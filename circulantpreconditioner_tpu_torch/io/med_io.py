"""MED (HDF5) output, mesh and cell-field time series: NumPy copy of
circulantpreconditioner_tpu/io/med_io.py (`--med`), the counterpart of the
reference drivers' Field::writeMED.

The MED 3.3 HDF5 layout (no-interlace arrays, 1-based connectivity), written
with h5py and no med-file C library:

- `write_med(path, mesh, fields, time=, it=, append=)` writes the mesh once
  and one field time step per call, with writeMED's first-call and append
  semantics;
- `read_med_field(path, name)` reads a field's (it, time, values) series;
- `med_cell_order(mesh)` maps the file's block order to the mesh's cells.

Cells: TE4/PY5/PE6/HE8 (TR3/QU4 in 2D) from stored connectivity, or the
lattice of a structured mesh (HE8, QU4, SE2). h5py is imported when a file
is written or read, never when the package is imported.
"""

from __future__ import annotations

import os

import numpy as np

from circulantpreconditioner_tpu_torch.mesh.core import Mesh
from circulantpreconditioner_tpu_torch.mesh.med import import_h5py

_ITER = f"{-1:020d}" + f"{-1:020d}"  # NDT=-1, NOR=-1 mesh iteration group


def _pad16(names: list[str]) -> bytes:
    return "".join(n[:16].ljust(16) for n in names).encode("latin-1")


def _mesh_blocks(mesh: Mesh):
    """Return (points (nV,esp), [(geotype, (nCb, k) conn, cell_ids)]) in the
    canonical write order. cell_ids maps block rows to mesh cell indices."""
    if getattr(mesh, "points", None) is not None and getattr(mesh, "cell_vertices", None) is not None:
        pts = np.asarray(mesh.points)[:, :2] if mesh.dim == 2 else np.asarray(mesh.points)[:, :3]
        cv = mesh.cell_vertices
        by_k: dict[int, list[int]] = {}
        for i, c in enumerate(cv):  # a list of tuples, or the port's (nC, k) array
            by_k.setdefault(len(c), []).append(i)
        geo_of = ({3: "TR3", 4: "QU4"} if mesh.dim == 2
                  else {4: "TE4", 5: "PY5", 6: "PE6", 8: "HE8"})
        blocks = []
        for k, ids in sorted(by_k.items()):
            geo = geo_of.get(k)
            if geo is None:
                raise NotImplementedError(f"cannot write {k}-vertex cells to MED")
            conn = np.array([cv[i] for i in ids], dtype=np.int64)
            blocks.append((geo, conn, np.asarray(ids, dtype=np.int64)))
        return pts, blocks
    if mesh.is_structured:
        n = list(mesh.structured_shape)
        b = mesh.bounds
        axes = [np.linspace(b[d, 0], b[d, 1], n[d] + 1) for d in range(mesh.dim)]
        if mesh.dim == 3:
            from circulantpreconditioner_tpu_torch.mesh.unstructured import (
                _hex_grid_points_cells,
            )

            pts, conn = _hex_grid_points_cells(b, n)  # the generators' lattice
            return pts, [("HE8", conn, np.arange(len(conn), dtype=np.int64))]
        if mesh.dim == 2:
            nx, ny = n
            Y, X = np.meshgrid(axes[1], axes[0], indexing="ij")
            pts = np.stack([X.ravel(), Y.ravel()], axis=1)
            vid = lambda i, j: j * (nx + 1) + i
            conn = np.empty((nx * ny, 4), dtype=np.int64)
            c = 0
            for j in range(ny):
                for i in range(nx):
                    conn[c] = (vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1))
                    c += 1
            return pts, [("QU4", conn, np.arange(len(conn), dtype=np.int64))]
        nx = n[0]
        pts = axes[0][:, None]
        conn = np.stack([np.arange(nx), np.arange(1, nx + 1)], axis=1).astype(np.int64)
        return pts, [("SE2", conn, np.arange(nx, dtype=np.int64))]
    raise NotImplementedError("mesh has neither stored connectivity nor structure")


_GEO_CODE = {"SE2": 102, "TR3": 203, "QU4": 204, "TE4": 304, "PY5": 305, "PE6": 306, "HE8": 308}

# Canonical block ordering = ascending vertex count, the same key _mesh_blocks
# sorts by (sorted(by_k.items())). read_med_field must walk blocks in this
# order, NOT alphabetically, or mixed-type meshes get misassociated values.
_GEO_ORDER = {g: i for i, g in enumerate(
    ["SE2", "TR3", "QU4", "TE4", "PY5", "PE6", "HE8"])}


def _write_mesh(f, mesh: Mesh, pts, blocks):
    info = f.require_group("INFOS_GENERALES")
    info.attrs.update({"MAJ": np.int32(3), "MIN": np.int32(3), "REL": np.int32(1)})
    esp = pts.shape[1]
    g = f.create_group(f"ENS_MAA/{mesh.name}")
    g.attrs.update({
        "DES": np.bytes_(b"written by circulantpreconditioner_tpu_torch"),
        "DIM": np.int32(mesh.dim), "ESP": np.int32(esp),
        "NOM": np.bytes_(_pad16(["x", "y", "z"][:esp])),
        "NXI": np.int32(-1), "NXT": np.int32(-1), "REP": np.int32(0),
        "SRT": np.int32(0), "TYP": np.int32(0),
        "UNI": np.bytes_(_pad16(["m"] * esp)), "UNT": np.bytes_(b"s"),
    })
    it = g.create_group(_ITER)
    it.attrs.update({"CGT": np.int32(1), "NDT": np.int32(-1), "NOR": np.int32(-1),
                     "NXI": np.int32(-1), "NXT": np.int32(-1), "PDT": np.float64(0.0),
                     "PVI": np.int32(-1), "PVT": np.int32(-1)})
    noe = it.create_group("NOE")
    noe.attrs.update({"CGS": np.int32(1), "CGT": np.int32(1),
                      "PFL": np.bytes_(b"MED_NO_PROFILE_INTERNAL")})
    noe.create_dataset("COO", data=pts.T.ravel().astype(np.float64))  # no-interlace
    noe.create_dataset("FAM", data=np.zeros(len(pts), dtype=np.int32))
    mai = it.create_group("MAI")
    mai.attrs["CGT"] = np.int32(1)
    for geo, conn, _ in blocks:
        tg = mai.create_group(geo)
        tg.attrs.update({"CGS": np.int32(1), "CGT": np.int32(1),
                         "GEO": np.int32(_GEO_CODE[geo]),
                         "PFL": np.bytes_(b"MED_NO_PROFILE_INTERNAL")})
        tg.create_dataset("NOD", data=(conn.T.ravel() + 1).astype(np.int32))
        tg.create_dataset("FAM", data=np.zeros(len(conn), dtype=np.int32))
    fas = f.create_group(f"FAS/{mesh.name}")
    fas.create_group("FAMILLE_ZERO").attrs["NUM"] = np.int32(0)


def write_med(path: str, mesh: Mesh, fields: dict[str, np.ndarray],
              time: float = 0.0, it: int = 0, append: bool = False) -> str:
    """Write/append cell fields at one timestep. `fields`: name → (nC,) or
    (nC, k) arrays (components flattened MED-style). First call (append=False
    or new file) also writes the mesh."""
    h5py = import_h5py()

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    mode = "a" if (append and os.path.exists(path)) else "w"
    with h5py.File(path, mode) as f:
        if f"ENS_MAA/{mesh.name}" not in f:
            pts, blocks = _mesh_blocks(mesh)
            _write_mesh(f, mesh, pts, blocks)
        else:
            _, blocks = _mesh_blocks(mesh)

        for name, vals in fields.items():
            vals = np.asarray(vals, dtype=np.float64)
            if vals.ndim == 1:
                vals = vals[:, None]
            if vals.shape[0] != mesh.n_cells:
                raise ValueError(f"{name}: {vals.shape[0]} values for {mesh.n_cells} cells")
            nco = vals.shape[1]
            cha = f.require_group(f"CHA/{name}")
            cha.attrs.update({
                "MAI": np.bytes_(mesh.name.encode("latin-1")), "NCO": np.int32(nco),
                "NOM": np.bytes_(_pad16([f"{name}{i}" for i in range(nco)])),
                "TYP": np.int32(6),
                "UNI": np.bytes_(_pad16([""] * nco)), "UNT": np.bytes_(b""),
            })
            ts_name = f"{it:020d}" + f"{-1:020d}"
            if ts_name in cha:
                raise ValueError(f"{name}: timestep {it} already written")
            ts = cha.create_group(ts_name)
            ts.attrs.update({"NDT": np.int32(it), "NOR": np.int32(-1),
                             "PDT": np.float64(time), "RDT": np.int32(-1),
                             "ROR": np.int32(-1)})
            mg = ts.create_group(f"MAI.{mesh.name}")
            for geo, conn, ids in blocks:
                gg = mg.create_group(geo)
                gg.attrs.update({"GAU": np.bytes_(b""), "NBR": np.int32(len(ids)),
                                 "NGA": np.int32(1),
                                 "PFL": np.bytes_(b"MED_NO_PROFILE_INTERNAL")})
                block_vals = vals[ids]  # (nCb, nco) in block order
                gg.create_dataset("CO", data=block_vals.T.ravel())  # no-interlace
    return path


def med_cell_order(mesh: Mesh) -> np.ndarray:
    """Permutation mapping MED block order (how cells land in the file and in
    any mesh read back from it) to this mesh's cell indices:
    `values_in_mesh_order[med_cell_order(mesh)] == values_in_med_order`.
    Identity for homogeneous and structured meshes."""
    _, blocks = _mesh_blocks(mesh)
    return np.concatenate([ids for _, _, ids in blocks])


def read_med_field(path: str, name: str):
    """Return the time series [(it, time, values (nC, nco))] of a cell field,
    with values in mesh cell order (blocks re-scattered via their id maps is
    unnecessary for single-block meshes; multi-block order follows the
    canonical write order, which matches this package's readers)."""
    h5py = import_h5py()

    out = []
    with h5py.File(path, "r") as f:
        cha = f[f"CHA/{name}"]
        nco = int(cha.attrs["NCO"])
        for ts_name in sorted(cha):
            ts = cha[ts_name]
            it = int(ts.attrs["NDT"])
            t = float(ts.attrs["PDT"])
            parts = []
            mg = ts[list(ts)[0]]  # MAI.<mesh>
            for geo in sorted(mg, key=lambda g: _GEO_ORDER.get(g, len(_GEO_ORDER))):
                co = np.asarray(mg[geo]["CO"], dtype=np.float64)
                parts.append(co.reshape(nco, -1).T)
            out.append((it, t, np.concatenate(parts, axis=0)))
    out.sort(key=lambda r: r[0])
    return out
