"""MED (Salome MED-file, HDF5) mesh reader: NumPy copy of
circulantpreconditioner_tpu/mesh/med.py, the counterpart of the reference's
SOLVERLAB `Mesh(filename.med)` loader that every driver's file branch uses.

Format notes (MED 3.0 to 3.3):
- `ENS_MAA/<mesh>/<iteration>/NOE/COO`: node coordinates, no-interlace
  (all x, then all y, then all z), float64.
- `MAI/<TYPE>/NOD`: nodal connectivity, no-interlace, 1-based. Volume types
  TE4, PY5, PE6, HE8 and POE (polyhedra, by the IFN cell → face and INN
  face → node index arrays); boundary types TR3, QU4 and POG (polygons, by
  INN). In 2D (ESP = 2) TR3, QU4 and POG are the cells and SE2 the boundary.
- `MAI/<TYPE>/FAM`: each element's family; `FAS/<mesh>/**` maps families to
  group names (80-byte padded strings under GRO/NOM).

Boundary elements are matched to the extracted faces by sorted vertex ids;
a matched face gets its family's first group name. Unmatched boundary faces
keep the default group.

h5py is imported when a file is read (`import_h5py`), never when the
package is imported; without it reading a MED file raises an ImportError
that names it.
"""

from __future__ import annotations

import warnings

import numpy as np

from circulantpreconditioner_tpu_torch.mesh.core import Mesh
from circulantpreconditioner_tpu_torch.mesh.unstructured import build_mesh_from_cells

# volume element types: name -> nodes per element
_VOLUME_TYPES = {"TE4": 4, "PY5": 5, "PE6": 6, "HE8": 8}
# boundary (codim-1) element types
_FACE_TYPES = {"TR3": 3, "QU4": 4}

# local face tables for 5/6-node cells (orientation fixed later by centroid
# test, so only the vertex cycles matter). MED orders: PY5 = quad base 0-3 +
# apex 4; PE6 = bottom triangle 0-2 + top triangle 3-5.
_PY5_FACES = [(0, 3, 2, 1), (0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4)]
_PE6_FACES = [(0, 2, 1), (3, 4, 5), (0, 1, 4, 3), (1, 2, 5, 4), (2, 0, 3, 5)]


def _decode_names(ds) -> list[str]:
    """GRO/NOM rows are (80,) int8 — decode to stripped strings. The array
    dtype defeats whole-dataset reads in h5py, so index element-wise."""
    out = []
    for i in range(ds.shape[0]):
        row = ds[i]
        out.append(bytes(bytearray(int(b) & 0xFF for b in row)).split(b"\x00")[0]
                   .decode("latin-1").strip())
    return out


def _read_families(f, mesh_key: str) -> dict[int, list[str]]:
    """family NUM -> group names, from FAS/<mesh> (recursively: ELEME/NOEUD
    subtrees and bare family groups)."""
    fams: dict[int, list[str]] = {}
    root = f.get(f"FAS/{mesh_key}")
    if root is None:
        return fams

    # walk FAS/<mesh>/{ELEME,NOEUD,FAMILLE_ZERO,...}/<family>
    def walk(grp):
        num = grp.attrs.get("NUM")
        if num is not None:
            names = _decode_names(grp["GRO/NOM"]) if "GRO" in grp else []
            fams[int(num)] = names
        for key in grp:
            child = grp[key]
            if key != "GRO" and hasattr(child, "keys"):
                walk(child)

    walk(root)
    return fams


def import_h5py():
    """h5py, which MED files need; an ImportError naming it where it is
    missing. Imported only when a MED file is read or written, so that the
    package imports without it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("MED files (read_med, write_med, --med) need h5py, which is "
                          "not installed") from e
    return h5py


def read_med(path: str, mesh_name: str | None = None, name: str | None = None) -> Mesh:
    """Load a 2D or 3D MED mesh into the flat face-major `Mesh`."""
    h5py = import_h5py()

    with h5py.File(path, "r") as f:
        meshes = list(f["ENS_MAA"])
        if mesh_name is None:
            if len(meshes) != 1:
                raise ValueError(f"{path}: multiple meshes {meshes}, pass mesh_name=")
            mesh_name = meshes[0]
        g = f[f"ENS_MAA/{mesh_name}"]
        esp = int(g.attrs.get("ESP", g.attrs.get("DIM", 3)))
        # iteration group: the single computation-step child
        iters = [k for k in g if hasattr(g[k], "keys")]
        it = g[sorted(iters)[0]]

        coo = np.asarray(it["NOE/COO"], dtype=np.float64)
        points = coo.reshape(esp, -1).T.copy()  # no-interlace
        # several fixtures duplicate shared vertices per cell (3DKershawTetra*:
        # 3865 nodes, 2697 distinct) — weld so face matching by vertex set works
        from circulantpreconditioner_tpu_torch.mesh.unstructured import weld_points

        points, node_remap = weld_points(points)
        if esp == 2:
            return _read_med_2d(f, it, points, node_remap, mesh_name, name, path)
        if esp != 3:
            raise NotImplementedError(f"{path}: only 2D/3D MED meshes supported (ESP={esp})")

        mai = it["MAI"]
        cells: list[tuple[int, ...]] = []
        cell_faces: list[list[tuple[int, ...]]] | None = None
        any_poly = "POE" in mai

        def conn(ds, k):
            a = np.asarray(ds, dtype=np.int64)
            a = a.reshape(k, -1).T - 1  # no-interlace, 1-based -> 0-based
            return node_remap[a] if node_remap is not None else a

        vol_blocks = []  # (cells_block, faces_block or None)
        for typ, k in _VOLUME_TYPES.items():
            if typ in mai:
                cc = conn(mai[typ]["NOD"], k)
                if typ == "PY5":
                    fb = [_PY5_FACES] * len(cc)
                elif typ == "PE6":
                    fb = [_PE6_FACES] * len(cc)
                else:
                    fb = None  # canonical tables in build_mesh_from_cells
                vol_blocks.append(([tuple(r) for r in cc], fb))
        if any_poly:
            poe = mai["POE"]
            ifn = np.asarray(poe["IFN"], dtype=np.int64)  # (ncell+1,) 1-based face offsets
            inn = np.asarray(poe["INN"], dtype=np.int64)  # (nface+1,) 1-based node offsets
            nod = np.asarray(poe["NOD"], dtype=np.int64) - 1
            if node_remap is not None:
                nod = node_remap[nod]
            pcells, pfaces = [], []
            for c in range(len(ifn) - 1):
                local_faces_g = [
                    tuple(nod[inn[fj] - 1: inn[fj + 1] - 1])
                    for fj in range(ifn[c] - 1, ifn[c + 1] - 1)
                ]
                verts = []
                seen = {}
                for fc in local_faces_g:
                    for v in fc:
                        if v not in seen:
                            seen[v] = len(verts)
                            verts.append(v)
                pcells.append(tuple(verts))
                pfaces.append([tuple(seen[v] for v in fc) for fc in local_faces_g])
            vol_blocks.append((pcells, pfaces))

        if not vol_blocks:
            raise ValueError(f"{path}: no 3D volume elements found")

        need_faces = any(fb is not None for _, fb in vol_blocks)
        if need_faces:
            cell_faces = []
            for cb, fb in vol_blocks:
                if fb is None:
                    from circulantpreconditioner_tpu_torch.mesh.unstructured import (
                        _HEX_FACES,
                        _TET_FACES,
                    )
                    fb = [(_HEX_FACES if len(c) == 8 else _TET_FACES) for c in cb]
                cell_faces.extend(fb)
                cells.extend(cb)
        else:
            for cb, _ in vol_blocks:
                cells.extend(cb)

        # boundary element -> family id, keyed by sorted vertex tuple
        bnd_fam: dict[tuple[int, ...], int] = {}
        for typ, k in _FACE_TYPES.items():
            if typ in mai:
                cc = conn(mai[typ]["NOD"], k)
                fam = np.asarray(mai[typ]["FAM"], dtype=np.int64) if "FAM" in mai[typ] else None
                for i, r in enumerate(cc):
                    bnd_fam[tuple(sorted(r))] = int(fam[i]) if fam is not None else 0
        if "POG" in mai:
            pog = mai["POG"]
            inn = np.asarray(pog["INN"], dtype=np.int64)
            nod = np.asarray(pog["NOD"], dtype=np.int64) - 1
            if node_remap is not None:
                nod = node_remap[nod]
            fam = np.asarray(pog["FAM"], dtype=np.int64) if "FAM" in pog else None
            for i in range(len(inn) - 1):
                r = nod[inn[i] - 1: inn[i + 1] - 1]
                bnd_fam[tuple(sorted(r))] = int(fam[i]) if fam is not None else 0

        fams = _read_families(f, mesh_name)

    mesh = build_mesh_from_cells(
        points, cells, cell_faces=cell_faces, name=name or f"{mesh_name}",
    )
    # evidence flag for read_mesh's repair gate: per-cell duplicated nodes
    # are the pathology class the non-conforming pass exists for (ADVICE r4)
    mesh.welded_nodes = node_remap is not None  # type: ignore[attr-defined]

    # tag boundary faces with their MED group names
    if bnd_fam:
        fv = mesh.face_vertices  # type: ignore[attr-defined]
        bfaces = mesh.boundary_faces()
        for bf in bfaces:
            row = fv[bf]
            key = tuple(sorted(int(v) for v in (row[row >= 0] if isinstance(row, np.ndarray) else row)))
            famid = bnd_fam.get(key)
            if famid is None or famid == 0:
                continue
            names = fams.get(famid) or []
            if not names:
                continue
            gname = names[0]
            code = mesh.groups.get(gname)
            if code is None:
                code = max(mesh.groups.values(), default=0) + 1
                mesh.groups[gname] = code
            mesh.face_group[bf] = code
    return mesh


def _read_med_2d(f, it, points, node_remap, mesh_name, name, path) -> Mesh:
    """ESP=2 branch: TR3/QU4 elements are the CELLS, SE2 segments are the
    boundary elements carrying family/group tags. Mirrors the reference
    drivers' 2D `.med` acceptance (SOLVERLAB Mesh(file.med) is
    dimension-generic; WaveSystem_SphericalExplosion_expl_seq.cxx:151-175)."""
    from circulantpreconditioner_tpu_torch.mesh.unstructured import build_mesh_from_cells_2d

    mai = it["MAI"]
    cells: list[tuple[int, ...]] = []

    def conn(ds, k):
        a = np.asarray(ds, dtype=np.int64)
        a = a.reshape(k, -1).T - 1
        return node_remap[a] if node_remap is not None else a

    for typ, k in (("TR3", 3), ("QU4", 4)):
        if typ in mai:
            cells.extend(tuple(r) for r in conn(mai[typ]["NOD"], k))
    if "POG" in mai:  # general polygon cells
        pog = mai["POG"]
        inn = np.asarray(pog["INN"], dtype=np.int64)
        nod = np.asarray(pog["NOD"], dtype=np.int64) - 1
        if node_remap is not None:
            nod = node_remap[nod]
        for i in range(len(inn) - 1):
            cells.append(tuple(nod[inn[i] - 1: inn[i + 1] - 1]))
    if not cells:
        raise ValueError(f"{path}: no 2D cell elements (TR3/QU4/POG) found")

    bnd_fam: dict[tuple[int, int], int] = {}
    if "SE2" in mai:
        cc = conn(mai["SE2"]["NOD"], 2)
        fam = np.asarray(mai["SE2"]["FAM"], dtype=np.int64) if "FAM" in mai["SE2"] else None
        for i, r in enumerate(cc):
            key = (int(min(r)), int(max(r)))
            bnd_fam[key] = int(fam[i]) if fam is not None else 0
    fams = _read_families(f, mesh_name)

    mesh = build_mesh_from_cells_2d(points, cells, name=name or f"{mesh_name}")
    if bnd_fam:
        fv = mesh.face_vertices  # type: ignore[attr-defined]
        for bf in mesh.boundary_faces():
            a, b = fv[bf]
            famid = bnd_fam.get((min(a, b), max(a, b)))
            if famid is None or famid == 0:
                continue
            names = fams.get(famid) or []
            if not names:
                continue
            gname = names[0]
            code = mesh.groups.get(gname)
            if code is None:
                code = max(mesh.groups.values(), default=0) + 1
                mesh.groups[gname] = code
            mesh.face_group[bf] = code
    return mesh


def read_mesh(path: str, recover_topology: bool = True, **kw) -> Mesh:
    """Extension-dispatched mesh loader (.med, .msh, .typ3): the analog of
    the reference drivers' `Mesh(argv[1])` branch.

    With recover_topology (the default), as in the JAX package: the
    non-conforming repair (mesh/conforming.py) where the file duplicated
    shared vertices per cell (`welded_nodes`), the evidence of the
    pathology it repairs; then grid-topology recovery, so that hexahedral
    and Kershaw files get `topology_shape` and the gather-free stencil
    operators; else an RCM order (`bandwidth_ordered`) for the window SpMV.
    Where the repair is gated off, its first phase still counts the pairs
    it would couple and warns if there are any: the JAX package skips them
    in silence. The mesh is the same either way."""
    from circulantpreconditioner_tpu_torch.mesh.typ3 import read_typ3
    from circulantpreconditioner_tpu_torch.mesh.unstructured import read_gmsh

    if path.endswith(".med"):
        mesh = read_med(path, **kw)
    elif path.endswith(".msh"):
        mesh = read_gmsh(path, **kw)
    elif path.endswith(".typ3"):
        mesh = read_typ3(path, **kw)
    else:
        raise ValueError(f"unsupported mesh file: {path}")
    if recover_topology:
        from circulantpreconditioner_tpu_torch.mesh.conforming import (
            count_nonconforming_pairs,
            match_nonconforming_faces,
        )
        from circulantpreconditioner_tpu_torch.mesh.topology import (
            recover_grid_topology,
            renumber_bandwidth,
        )

        if getattr(mesh, "welded_nodes", False):
            match_nonconforming_faces(mesh)
        else:
            pairs = count_nonconforming_pairs(mesh)
            if pairs:
                warnings.warn(
                    f"{mesh.name}: {pairs} pairs of opposing boundary faces inside the "
                    "domain look like a non-conforming interface; they are left as "
                    "boundary, since the file shares its vertices (no node was welded). "
                    "mesh.conforming.match_nonconforming_faces couples them.")
        if not recover_grid_topology(mesh):
            renumber_bandwidth(mesh)
    return mesh
