"""Grid-topology recovery and bandwidth renumbering for meshes read from
files.

NumPy copy of circulantpreconditioner_tpu/mesh/topology.py. The hexahedral
and Kershaw families are topological grids whose geometry is warped;
generated meshes carry `topology_shape` and take the gather-free stencil
operators (on the GPU, kernel K2), but a mesh read from a file carries no
grid. `recover_grid_topology`

1. finds the 2·dim boundary planes of the bounding box,
2. takes each cell's integer coordinate along an axis as its BFS distance
   from the cells on the low plane, over the face adjacency (in a
   topological grid that distance is the coordinate, whatever the warp),
3. checks that the coordinates are a bijection onto the (nx, ny, nz)
   lattice and that each interior face is a unit step along one axis,
4. renumbers the cells x fastest (the generators' order) and sets
   `topology_shape`.

Meshes with no grid (tetrahedra) get a reverse Cuthill–McKee order instead
(`renumber_bandwidth`, `bandwidth_ordered`), for the window SpMV
(ops/window_spmv.py). Either renumbering records `cell_permutation`
(orig_of_new: new cell id → the file's cell id), composed with any earlier
one, so that fields can be written back in file order.
"""

from __future__ import annotations

import numpy as np

from circulantpreconditioner_tpu_torch.mesh.core import Mesh


def _cell_adjacency(mesh: Mesh):
    """CSR adjacency (indptr, indices) over cells from interior faces."""
    fc = mesh.face_cells
    interior = fc[:, 1] >= 0
    L = fc[interior, 0]
    R = fc[interior, 1]
    n = mesh.n_cells
    src = np.concatenate([L, R])
    dst = np.concatenate([R, L])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, dst


def _bfs_layers(indptr, indices, seeds, n):
    """Vectorized multi-source BFS distance (-1 = unreachable)."""
    dist = np.full(n, -1, dtype=np.int64)
    frontier = np.unique(np.asarray(seeds, dtype=np.int64))
    dist[frontier] = 0
    d = 0
    while frontier.size:
        counts = indptr[frontier + 1] - indptr[frontier]
        total = int(counts.sum())
        if total == 0:
            break
        # concatenated neighbour ranges via repeat/cumsum
        starts = indptr[frontier]
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        nbrs = indices[np.repeat(starts, counts) + offs]
        nbrs = np.unique(nbrs)
        nbrs = nbrs[dist[nbrs] < 0]
        dist[nbrs] = d + 1
        frontier = nbrs
        d += 1
    return dist


def _boundary_plane_cells(mesh: Mesh, axis: int, low: bool, tol: float):
    """Cells adjacent to the boundary faces lying on one bbox plane."""
    bb = mesh.bbox()
    scale = float((bb[:, 1] - bb[:, 0]).max())
    bnd = mesh.boundary_faces()
    target = bb[axis, 0] if low else bb[axis, 1]
    sel = np.abs(mesh.face_center[bnd, axis] - target) < tol * scale
    return mesh.face_cells[bnd[sel], 0]


def recover_grid_topology(mesh: Mesh, tol: float = 1e-6) -> bool:
    """Detect an (n1,...,ndim) grid-minor structure; renumber + tag the mesh.

    Returns True on success (mesh mutated: cells renumbered lexicographically,
    `topology_shape` set, `cell_permutation` = orig_of_new recorded). Returns
    False — mesh untouched — if the mesh is not a topological grid with
    7-point face adjacency. O(n_cells + n_faces) host-side NumPy.
    """
    if getattr(mesh, "topology_shape", None) is not None:
        return True
    dim = mesh.dim
    n = mesh.n_cells
    if n == 0:
        return False
    indptr, indices = _cell_adjacency(mesh)
    # cheap necessary condition: interior degree <= 2*dim
    deg = np.diff(indptr)
    if deg.max(initial=0) > 2 * dim:
        return False

    coords = np.empty((dim, n), dtype=np.int64)
    shape = []
    for ax in range(dim):
        seeds = _boundary_plane_cells(mesh, ax, low=True, tol=tol)
        if seeds.size == 0:
            return False
        dist = _bfs_layers(indptr, indices, seeds, n)
        if dist.min() < 0:  # disconnected
            return False
        coords[ax] = dist
        shape.append(int(dist.max()) + 1)
    if int(np.prod(shape)) != n:
        return False

    # linear lexicographic id, x-fastest (matches the generators)
    strides = np.cumprod([1] + shape[:-1])
    new_id = np.zeros(n, dtype=np.int64)
    for ax in range(dim):
        new_id += coords[ax] * strides[ax]
    # bijection check
    seen = np.zeros(n, dtype=bool)
    seen[new_id] = True
    if not seen.all():
        return False

    # every interior face must be a unit step along exactly one axis
    fc = mesh.face_cells
    interior = fc[:, 1] >= 0
    dpos = np.abs(coords[:, fc[interior, 0]] - coords[:, fc[interior, 1]])
    if dpos.max(initial=0) > 1 or (dpos.sum(axis=0) != 1).any():
        return False

    permute_cells(mesh, new_id)
    mesh.topology_shape = tuple(shape)  # type: ignore[attr-defined]
    return True


def renumber_bandwidth(mesh: Mesh) -> bool:
    """Reverse Cuthill–McKee renumbering of a mesh with no grid topology
    (the tetrahedral families): consecutive cells become face neighbours, so
    the window SpMV (ops/window_spmv.py) gathers from small windows. SciPy's
    RCM on the face adjacency, as in the JAX package, so the permutation is
    the JAX package's. Returns True if the mesh was renumbered (recorded in
    `cell_permutation`, as grid recovery records it, and
    `bandwidth_ordered`); False for grid-tagged or trivial meshes."""
    if getattr(mesh, "topology_shape", None) is not None or mesh.n_cells < 2:
        return False
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = mesh.n_cells
    indptr, indices = _cell_adjacency(mesh)
    A = sp.csr_matrix((np.ones(len(indices), np.int8),
                       indices.astype(np.int32), indptr.astype(np.int32)),
                      shape=(n, n))
    perm = reverse_cuthill_mckee(A)  # position k holds old cell perm[k]
    new_id = np.empty(n, dtype=np.int64)
    new_id[perm] = np.arange(n)
    permute_cells(mesh, new_id)
    mesh.bandwidth_ordered = True  # type: ignore[attr-defined]
    return True


def permute_cells(mesh: Mesh, new_id: np.ndarray) -> None:
    """Renumber cells in place: cell c becomes cell new_id[c] (a bijection).

    Face arrays keep their order; only the cell labels inside them change.
    Records `mesh.cell_permutation` (orig_of_new) for file-order round-trips,
    composing with any permutation already present.
    """
    new_id = np.asarray(new_id, dtype=np.int64)
    orig_of_new = np.argsort(new_id)  # new index -> old index

    mesh.cell_center = mesh.cell_center[orig_of_new]
    mesh.cell_volume = mesh.cell_volume[orig_of_new]
    cv = getattr(mesh, "cell_vertices", None)
    if cv is not None:
        if isinstance(cv, np.ndarray):
            mesh.cell_vertices = cv[orig_of_new]  # type: ignore[attr-defined]
        else:
            mesh.cell_vertices = [cv[i] for i in orig_of_new]  # type: ignore[attr-defined]
    cf = getattr(mesh, "cell_faces", None)
    if cf is not None and not isinstance(cf, np.ndarray):
        mesh.cell_faces = [cf[i] for i in orig_of_new]  # type: ignore[attr-defined]

    fc = mesh.face_cells
    mesh.face_cells = np.where(fc >= 0, new_id[np.clip(fc, 0, None)], fc)
    if mesh.periodic_twin is not None:
        pt = mesh.periodic_twin
        mesh.periodic_twin = np.where(pt >= 0, new_id[np.clip(pt, 0, None)], pt)

    prev = getattr(mesh, "cell_permutation", None)
    if prev is not None:
        orig_of_new = np.asarray(prev)[orig_of_new]
    mesh.cell_permutation = orig_of_new  # type: ignore[attr-defined]
