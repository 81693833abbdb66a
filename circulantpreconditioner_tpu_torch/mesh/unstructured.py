"""Unstructured meshes: cell-vertex → face-major conversion and the hexa,
Kershaw, tetra and Kershaw-tetra generators.

NumPy copy of circulantpreconditioner_tpu/mesh/unstructured.py. Homogeneous
hexahedral or tetrahedral meshes take a vectorised path whose faces are
numbered in the order they are first met, as the JAX package's native face
extraction (native/fvcore.cpp) numbers them, so every face array, the cell
volumes and the assembled operators are equal to the JAX package's bit for
bit. Polyhedral and mixed meshes (`cell_faces` given) take the generic
per-face path, the JAX package's own loop.

The tetra families number their cells hex-major, 6 tetrahedra per hexahedron,
so that `topology_shape` and `cells_per_site = 6` describe them as a grid of
supercells (ops/stencil.py).

Also `weld_points` (duplicate nodes merged, as the MED and Gmsh readers
need), the 2D polygon meshes of the MED reader's 2D branch, and the Gmsh
2.2 ASCII reader.
"""

from __future__ import annotations

import numpy as np

from circulantpreconditioner_tpu_torch.mesh.core import INTERIOR, Mesh
from circulantpreconditioner_tpu_torch.utils.profiling import host_spanned

# local vertex numbering of the 6 quad faces of a hexahedron with vertices
# ordered (x fastest): 0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0)
#                      4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
_HEX_FACES = [
    (0, 3, 2, 1),  # z-
    (4, 5, 6, 7),  # z+
    (0, 1, 5, 4),  # y-
    (3, 7, 6, 2),  # y+
    (0, 4, 7, 3),  # x-
    (1, 2, 6, 5),  # x+
]

# 4 triangle faces of a tetrahedron (outward for positively oriented tets)
_TET_FACES = [(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)]


def weld_points(points: np.ndarray, tol: float = 1e-9):
    """Merge duplicate nodes (the MEDCoupling mergeNodes analog): (points,
    remap) with remap[old_id] = new_id, or (points, None) when every node
    is unique. Some files store each cell with its own copies of shared
    vertices; faces are matched by vertex ids, so unwelded, their interior
    faces would be taken for boundary. Nodes are keyed on round(p /
    (tol·scale)); a cKDTree pass over the keys' representatives merges, by
    union-find, two copies whose noise straddles a rounding bin. The same
    np.unique and tolerance semantics as the JAX package, so the merged ids
    (and the face numbering that follows them) are the JAX package's."""
    pts = np.asarray(points, dtype=np.float64)
    scale = float(np.abs(pts).max()) or 1.0
    key = np.round(pts / (tol * scale)).astype(np.int64)
    _, first_idx, inverse = np.unique(key, axis=0, return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    reps = pts[first_idx]
    from scipy.spatial import cKDTree

    pairs = cKDTree(reps).query_pairs(r=tol * scale, output_type="ndarray")
    if len(first_idx) == len(pts) and pairs.size == 0:
        return pts, None
    parent = np.arange(len(reps))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(a) for a in range(len(reps))])
    uniq, compact = np.unique(roots, return_inverse=True)
    return reps[uniq], compact[inverse].astype(np.int64)


# splitting of a hex into 6 tets (all positively oriented, shared diagonal 0-6)
_HEX_TO_TETS = [
    (0, 1, 2, 6),
    (0, 2, 3, 6),
    (0, 3, 7, 6),
    (0, 7, 4, 6),
    (0, 4, 5, 6),
    (0, 5, 1, 6),
]


def _polygon_area_normal_center(pts: np.ndarray):
    """Fan triangulation around the vertex centroid; returns (area, unit
    normal, area-weighted centroid). Works for planar and mildly non-planar
    quads (Kershaw)."""
    c = pts.mean(axis=0)
    total = np.zeros(3)
    center = np.zeros(3)
    k = len(pts)
    for i in range(k):
        a, b = pts[i], pts[(i + 1) % k]
        tri_n = 0.5 * np.cross(a - c, b - c)
        total += tri_n
        tri_area = np.linalg.norm(tri_n)
        center += tri_area * (a + b + c) / 3.0
    area = np.linalg.norm(total)
    if area < 1e-300:
        raise ValueError("degenerate face")
    return area, total / area, center / max(area, 1e-300)


def _extract_faces(cells_arr: np.ndarray):
    """Shared faces of a homogeneous hex (8 vertices) or tet (4 vertices)
    mesh: (face_vertices (nF, 4), a tet's triangles padded with -1 in the
    fourth column; face_cells (nF, 2) with -1 on the boundary). Faces are
    numbered in the order they are first met, cell by cell and face by face
    within a cell, and keep the vertex order of that first meeting: the
    numbering of the JAX package's native face extraction (native/fvcore.cpp),
    so that every sum over faces runs in the same order and the assembled
    operators are equal bit for bit. Found by a lexsort of the sorted vertex
    keys, the pad included as the native key includes it (stable: the first
    of equal keys is the first met)."""
    n_cells, nv = cells_arr.shape
    table = np.asarray(_HEX_FACES if nv == 8 else _TET_FACES)
    nf, k = table.shape
    faces = cells_arr[:, table.reshape(-1)].reshape(n_cells * nf, k)
    if k == 3:
        faces = np.concatenate([faces, np.full((len(faces), 1), -1, np.int64)], axis=1)
    owner = np.repeat(np.arange(n_cells, dtype=np.int64), nf)
    key = np.sort(faces, axis=1)
    order = np.lexsort(key.T[::-1])
    key_s = key[order]
    new = np.ones(len(key_s), dtype=bool)
    new[1:] = (key_s[1:] != key_s[:-1]).any(axis=1)
    group = np.cumsum(new) - 1
    nF = int(group[-1]) + 1 if len(group) else 0
    if np.bincount(group, minlength=nF).max(initial=0) > 2:
        raise ValueError("broken mesh: face shared by >2 cells")
    # number the groups by their first meeting
    rank = np.empty(nF, dtype=np.int64)
    rank[np.argsort(order[new], kind="stable")] = np.arange(nF)
    fid = rank[group]
    fv = np.full((nF, 4), -1, dtype=np.int64)
    fc = np.full((nF, 2), -1, dtype=np.int64)
    fv[fid[new]] = faces[order[new]]
    fc[fid[new], 0] = owner[order[new]]
    fc[fid[~new], 1] = owner[order[~new]]
    return fv, fc


def _fast_build_homogeneous(points, cells_arr, default_group, name):
    """Vectorized build of a homogeneous hex or tet mesh. The
    fan-triangulation area vector Σ ½(aᵢ−c)×(aᵢ₊₁−c) does not depend on the
    fan point c, so a triangle padded with its first vertex repeated is
    exact. Geometry runs on per-component contiguous (nF, 4) arrays:
    stride-3 access over large buffers is far slower on the host."""
    n_cells = cells_arr.shape[0]
    fv, fc = _extract_faces(cells_arr)
    fvp = fv.copy()
    pad = fvp[:, 3] < 0
    fvp[pad, 3] = fvp[pad, 0]
    comp = [np.ascontiguousarray(points[:, d]) for d in range(3)]
    Pc = [cd[fvp] for cd in comp]  # 3 × (nF, 4)
    cc = [p.mean(axis=1) for p in Pc]  # fan point
    bc = [p[:, [1, 2, 3, 0]] for p in Pc]
    d1 = [p - m[:, None] for p, m in zip(Pc, cc)]
    d2 = [p - m[:, None] for p, m in zip(bc, cc)]
    tri_n = [
        0.5 * (d1[1] * d2[2] - d1[2] * d2[1]),
        0.5 * (d1[2] * d2[0] - d1[0] * d2[2]),
        0.5 * (d1[0] * d2[1] - d1[1] * d2[0]),
    ]  # 3 × (nF, 4)
    total = [t.sum(axis=1) for t in tri_n]
    area = np.sqrt(total[0] ** 2 + total[1] ** 2 + total[2] ** 2)
    if (area < 1e-300).any():
        raise ValueError("degenerate face")
    normal_c = [t / area for t in total]
    tri_area = np.sqrt(tri_n[0] ** 2 + tri_n[1] ** 2 + tri_n[2] ** 2)  # (nF, 4)
    tri_w = np.maximum(tri_area.sum(axis=1), 1e-300)
    center_c = [
        ((p + b_ + m[:, None]) / 3.0 * tri_area).sum(axis=1) / tri_w
        for p, b_, m in zip(Pc, bc, cc)
    ]

    centroid_c = [cd[cells_arr].mean(axis=1) for cd in comp]  # 3 × (nC,)
    fc0 = fc[:, 0]
    dot = sum(n_ * (ce - cen[fc0]) for n_, ce, cen in zip(normal_c, center_c, centroid_c))
    sign = np.where(dot < 0, -1.0, 1.0)
    normal_c = [n_ * sign for n_ in normal_c]

    # V = (1/3) Σ_f (c_f · n_f) A_f, with the sign of each side's outward
    # normal; summed in the JAX package's order (first sides, then second)
    contrib = area * sum(c_ * n_ for c_, n_ in zip(center_c, normal_c)) / 3.0
    m2 = fc[:, 1] >= 0
    cell_volume = np.bincount(np.concatenate([fc0, fc[m2, 1]]),
                              weights=np.concatenate([contrib, -contrib[m2]]),
                              minlength=n_cells)

    mesh = Mesh(
        dim=3,
        cell_center=np.stack(centroid_c, axis=1),
        cell_volume=cell_volume,
        face_cells=fc,
        face_normal=np.stack(normal_c, axis=1),
        face_area=area,
        face_center=np.stack(center_c, axis=1),
        face_group=np.where(fc[:, 1] < 0, 1, INTERIOR).astype(np.int32),
        groups={default_group: 1},
        periodic_twin=None,
        structured_shape=None,
        bounds=None,
        name=name,
    )
    mesh.points = points  # type: ignore[attr-defined]
    mesh.cell_vertices = cells_arr  # type: ignore[attr-defined]  # (nC, 8 or 4) int64
    mesh.face_vertices = fv  # type: ignore[attr-defined]  # (nF, 4) int64, -1 pad
    return mesh


@host_spanned("port.setup.mesh")
def build_mesh_from_cells(points: np.ndarray, cells, cell_faces=None,
                          default_group: str = "Wall", name: str = "unstructured") -> Mesh:
    """Face-major mesh from cells given by their vertex ids. With `cell_faces`
    None, cells are hexahedra (8 vertices, the _HEX_FACES numbering) or
    tetrahedra (4 vertices, _TET_FACES); homogeneous meshes of either (a
    list of equal-length tuples or an (nC, 8 or 4) array) take the
    vectorised path. Otherwise `cell_faces[c]` lists cell c's faces as
    tuples of its local vertex numbers (polyhedra, mixed meshes). Face areas
    and normals by fan triangulation, normals outward of the first incident
    cell, volumes by the divergence theorem: valid for the warped,
    non-planar Kershaw cells."""
    points = np.asarray(points, dtype=np.float64)
    if points.shape[1] == 2:
        points = np.concatenate([points, np.zeros((len(points), 1))], axis=1)
    if cell_faces is None and len(cells):
        if {len(c) for c in cells} in ({4}, {8}):
            return _fast_build_homogeneous(points, np.asarray(cells, dtype=np.int64),
                                           default_group, name)
    return _build_generic(points, cells, cell_faces, default_group, name)


def _build_generic(points, cells, cell_faces, default_group, name) -> Mesh:
    """The JAX package's per-face loop: faces in first-met order, each one's
    geometry by _polygon_area_normal_center, cell centres as vertex means."""
    face_map: dict[tuple[int, ...], int] = {}
    f_vertices: list[tuple[int, ...]] = []
    f_cells: list[list[int]] = []
    for ci, cv in enumerate(cells):
        if cell_faces is not None:
            local = cell_faces[ci]
        elif len(cv) == 8:
            local = _HEX_FACES
        elif len(cv) == 4:
            local = _TET_FACES
        else:
            raise ValueError(f"cell {ci}: unsupported vertex count {len(cv)}")
        for lf in local:
            gv = tuple(int(cv[i]) for i in lf)
            key = tuple(sorted(gv))
            j = face_map.get(key)
            if j is None:
                face_map[key] = len(f_vertices)
                f_vertices.append(gv)
                f_cells.append([ci])
            else:
                f_cells[j].append(ci)

    n_cells, nF = len(cells), len(f_vertices)
    face_cells = np.full((nF, 2), -1, dtype=np.int64)
    face_normal = np.zeros((nF, 3))
    face_area = np.zeros(nF)
    face_center = np.zeros((nF, 3))
    cell_centroid = np.array([points[list(cv)].mean(axis=0) for cv in cells])
    for f, (gv, cl) in enumerate(zip(f_vertices, f_cells)):
        if len(cl) > 2:
            raise ValueError(f"face {f} shared by {len(cl)} cells — broken mesh")
        area, nrm, ctr = _polygon_area_normal_center(points[list(gv)])
        if np.dot(nrm, ctr - cell_centroid[cl[0]]) < 0:
            nrm = -nrm
        face_cells[f, 0] = cl[0]
        if len(cl) == 2:
            face_cells[f, 1] = cl[1]
        face_normal[f] = nrm
        face_area[f] = area
        face_center[f] = ctr

    # V = (1/3) Σ_f (c_f · n_f) A_f, face by face as the JAX package sums it
    cell_volume = np.zeros(n_cells)
    for f in range(nF):
        contrib = face_area[f] * np.dot(face_center[f], face_normal[f]) / 3.0
        cell_volume[face_cells[f, 0]] += contrib
        if face_cells[f, 1] >= 0:
            cell_volume[face_cells[f, 1]] -= contrib

    mesh = Mesh(
        dim=3,
        cell_center=cell_centroid,
        cell_volume=cell_volume,
        face_cells=face_cells,
        face_normal=face_normal,
        face_area=face_area,
        face_center=face_center,
        face_group=np.where(face_cells[:, 1] < 0, 1, INTERIOR).astype(np.int32),
        groups={default_group: 1},
        periodic_twin=None,
        structured_shape=None,
        bounds=None,
        name=name,
    )
    mesh.points = points  # type: ignore[attr-defined]
    mesh.cell_vertices = cells  # type: ignore[attr-defined]
    mesh.face_vertices = f_vertices  # type: ignore[attr-defined]  # list of tuples
    return mesh


def build_mesh_from_cells_2d(points: np.ndarray, cells, default_group: str = "Wall",
                             name: str = "unstructured2d") -> Mesh:
    """2D mesh of polygon cells (TR3, QU4, ...) given by their ordered vertex
    ids, whose faces are edges: the MED reader's 2D branch. Edge measure =
    length, normal = in-plane unit outward of the first incident cell, cell
    volume = shoelace area. The JAX package's loops, in its order."""
    points = np.asarray(points, dtype=np.float64)[:, :2]
    face_map: dict[tuple[int, int], int] = {}
    f_vertices: list[tuple[int, int]] = []
    f_cells: list[list[int]] = []
    for ci, cv in enumerate(cells):
        k = len(cv)
        for a in range(k):
            gv = (int(cv[a]), int(cv[(a + 1) % k]))
            key = (min(gv), max(gv))
            j = face_map.get(key)
            if j is None:
                face_map[key] = len(f_vertices)
                f_vertices.append(gv)
                f_cells.append([ci])
            else:
                f_cells[j].append(ci)

    cell_centroid = np.array([points[list(cv)].mean(axis=0) for cv in cells])
    cell_volume = np.array([
        0.5 * abs(sum(
            points[cv[a], 0] * points[cv[(a + 1) % len(cv)], 1]
            - points[cv[(a + 1) % len(cv)], 0] * points[cv[a], 1]
            for a in range(len(cv))))
        for cv in cells])
    nF = len(f_vertices)
    face_cells = np.full((nF, 2), -1, dtype=np.int64)
    face_normal = np.zeros((nF, 2))
    face_area = np.zeros(nF)
    face_center = np.zeros((nF, 2))
    for f, (gv, cl) in enumerate(zip(f_vertices, f_cells)):
        if len(cl) > 2:
            raise ValueError(f"edge {f} shared by {len(cl)} cells — broken mesh")
        p0, p1 = points[gv[0]], points[gv[1]]
        t = p1 - p0
        L = float(np.hypot(*t))
        nrm = np.array([t[1], -t[0]]) / L
        ctr = 0.5 * (p0 + p1)
        if np.dot(nrm, ctr - cell_centroid[cl[0]]) < 0:
            nrm = -nrm
        face_cells[f, 0] = cl[0]
        if len(cl) == 2:
            face_cells[f, 1] = cl[1]
        face_normal[f] = nrm
        face_area[f] = L
        face_center[f] = ctr

    mesh = Mesh(
        dim=2,
        cell_center=cell_centroid,
        cell_volume=cell_volume,
        face_cells=face_cells,
        face_normal=face_normal,
        face_area=face_area,
        face_center=face_center,
        face_group=np.where(face_cells[:, 1] < 0, 1, INTERIOR).astype(np.int32),
        groups={default_group: 1},
        periodic_twin=None,
        structured_shape=None,
        bounds=None,
        name=name,
    )
    mesh.points = points  # type: ignore[attr-defined]
    mesh.cell_vertices = cells  # type: ignore[attr-defined]
    mesh.face_vertices = f_vertices  # type: ignore[attr-defined]  # list of (a, b)
    return mesh


def _hex_grid_points_cells(bounds, n, warp=None):
    """Vertices of the (nx+1)(ny+1)(nz+1) lattice (x fastest) and the 8
    vertex ids of each cell, cells numbered x fastest."""
    nx, ny, nz = (int(v) for v in n)
    bounds = np.asarray(bounds, dtype=np.float64).reshape(3, 2)
    xs = [np.linspace(bounds[d, 0], bounds[d, 1], int(n[d]) + 1) for d in range(3)]
    Z, Y, X = np.meshgrid(xs[2], xs[1], xs[0], indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)
    if warp is not None:
        pts = warp(pts)
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    i, j, k = i.reshape(-1), j.reshape(-1), k.reshape(-1)

    def vid(i, j, k):
        return (k * (ny + 1) + j) * (nx + 1) + i

    cells = np.stack([
        vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k), vid(i, j + 1, k),
        vid(i, j, k + 1), vid(i + 1, j, k + 1), vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1),
    ], axis=1).astype(np.int64)
    return pts, cells


def hex_mesh(bounds, n, name=None) -> Mesh:
    """Uniform hexahedra as an unstructured mesh (FVCA6 'mesh_hexa' family)."""
    pts, cells = _hex_grid_points_cells(bounds, n)
    m = build_mesh_from_cells(pts, cells, name=name or f"hexa_{'x'.join(map(str, n))}")
    m.topology_shape = tuple(int(v) for v in n)  # type: ignore[attr-defined]
    return m


def _tets_of_hexes(hexes: np.ndarray) -> np.ndarray:
    """(6·nH, 4) vertex ids: each hex split into the 6 tets of _HEX_TO_TETS,
    hex-major (the 6 tets of hex h are cells 6h … 6h+5)."""
    return hexes[:, np.asarray(_HEX_TO_TETS)].reshape(-1, 4)


def _supercell_grid(m: Mesh, n) -> Mesh:
    """Record the hex-major numbering: 6 tets per site of the (nx, ny, nz)
    grid, which the gather-free supercell stencils use."""
    m.topology_shape = tuple(int(v) for v in n)  # type: ignore[attr-defined]
    m.cells_per_site = 6  # type: ignore[attr-defined]
    return m


def tet_mesh(bounds, n, name=None) -> Mesh:
    """Each hex of the (nx, ny, nz) grid split into 6 tetrahedra (FVCA6
    'gentle tetrahedra' analog)."""
    pts, hexes = _hex_grid_points_cells(bounds, n)
    return _supercell_grid(build_mesh_from_cells(
        pts, _tets_of_hexes(hexes), name=name or f"tetra_{'x'.join(map(str, n))}"), n)


def _kershaw_warp(bounds, eps: float):
    bounds = np.asarray(bounds, dtype=np.float64).reshape(3, 2)
    lo, hi = bounds[:, 0], bounds[:, 1]

    def warp(pts):
        u = (pts - lo) / (hi - lo)
        x, y, z = u[:, 0], u[:, 1], u[:, 2]
        # kinked shear: a triangular wave in x and y scales the z shift.
        # zn = z + a·sin(2πz)/π has slope 1 + 2a·cos(2πz) ≥ eps > 0, so the
        # map is monotone in z and cells never fold, at every resolution.
        tri = lambda t: 1.0 - 2.0 * np.abs(t - np.floor(t + 0.5))
        amp = 0.5 * (1.0 - eps) * tri(2 * x) * tri(2 * y)
        zn = z + amp * np.sin(2 * np.pi * z) / np.pi
        out = u.copy()
        out[:, 2] = zn
        return lo + out * (hi - lo)

    return warp


def kershaw_mesh(bounds, n, eps: float = 0.3, name=None) -> Mesh:
    """Kershaw-distorted hexahedra (FVCA6 'Kershaw' family analog): z is
    sheared by a kinked profile whose amplitude depends on (x, y). eps ∈
    (0, 1] sets the severity (1 = uniform). The geometry is warped but the
    topology is the (nx, ny, nz) grid, which `topology_shape` records for
    the gather-free stencil operators."""
    warp = _kershaw_warp(bounds, eps)
    pts, cells = _hex_grid_points_cells(bounds, n, warp=warp)
    m = build_mesh_from_cells(pts, cells, name=name or f"kershaw_{'x'.join(map(str, n))}")
    m.topology_shape = tuple(int(v) for v in n)  # type: ignore[attr-defined]
    return m


def kershaw_tet_mesh(bounds, n, eps: float = 0.3, name=None) -> Mesh:
    """Kershaw-warped hexahedra split into 6 tets each: the generated analog
    of the reference's 3DKershawTetra family, whose top rung (KershawTetra3,
    766,976 tets) is absent from the reference snapshot; 6·50³ = 750,000 tets
    is close to it."""
    pts, hexes = _hex_grid_points_cells(bounds, n, warp=_kershaw_warp(bounds, eps))
    return _supercell_grid(build_mesh_from_cells(
        pts, _tets_of_hexes(hexes), name=name or f"kershawtet_{'x'.join(map(str, n))}"), n)


def read_gmsh(path: str, name=None) -> Mesh:
    """Gmsh MSH 2.2 ASCII reader: the nodes and the 3D elements (tetrahedra,
    type 4; hexahedra, type 5), in file order; other elements (the 2D
    boundary ones) are ignored. Node ids are renumbered in sorted order,
    duplicate nodes welded (`welded_nodes` records whether any were). A
    homogeneous file reaches the vectorised build as one (nC, 4 or 8)
    array."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    node_ids = np.zeros(0, dtype=np.int64)
    coords = np.zeros((0, 3))
    conn: list[list[str]] = []
    i = 0
    while i < len(lines):
        head = lines[i].strip()
        if head == "$Nodes":
            count = int(lines[i + 1])
            rows = [ln.split()[:4] for ln in lines[i + 2:i + 2 + count]]
            node_ids = np.array([int(r[0]) for r in rows], dtype=np.int64)
            coords = np.array([[float(v) for v in r[1:]] for r in rows]).reshape(-1, 3)
            i += 2 + count
        elif head == "$Elements":
            count = int(lines[i + 1])
            for ln in lines[i + 2:i + 2 + count]:
                parts = ln.split()
                if int(parts[1]) in (4, 5):  # tet, hex
                    conn.append(parts[3 + int(parts[2]):])
            i += 2 + count
        else:
            i += 1
    # sorted ids; a node listed twice keeps its last coordinates
    ids, last = np.unique(node_ids[::-1], return_index=True)
    points = coords[len(node_ids) - 1 - last]
    points, weld = weld_points(points)  # per-cell duplicated vertices

    def renumber(c):
        c = np.asarray(c, dtype=np.int64)
        pos = np.searchsorted(ids, c)
        if (pos >= len(ids)).any() or (ids[np.minimum(pos, len(ids) - 1)] != c).any():
            raise ValueError(f"{path}: an element references a node that is not listed")
        return weld[pos] if weld is not None else pos

    if conn and len({len(c) for c in conn}) == 1:
        cells = renumber(np.array([[int(v) for v in c] for c in conn], dtype=np.int64))
    else:
        cells = [tuple(int(v) for v in renumber([int(v) for v in c])) for c in conn]
    m = build_mesh_from_cells(points, cells, name=name or path)
    m.welded_nodes = weld is not None  # type: ignore[attr-defined]
    return m
