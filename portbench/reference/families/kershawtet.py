"""Frozen Kershaw-tetra mesh geometry: the Kershaw lattice's hexahedra split
into 6 tetrahedra each, and the finite-volume quantities of each tet's four
triangular faces, in float64 NumPy.

A frozen copy of the port's `kershaw_tet_mesh` (`_HEX_TO_TETS`,
`_tets_of_hexes`, `_TET_FACES`) and of its face geometry
(`_fast_build_homogeneous`): the warped lattice of reference/mesh.py, each
hex split along its 0-6 diagonal, hex-major (the tets of hex h are cells
6h … 6h+5); each face's area vector ½(b − a) × (c − a) turned outward of its
tet, its centre the triangle's centroid (the port's fan around the vertex
mean gives the same), the cell volume by the divergence theorem
V = (1/3) Σ_f c_f · S_f, the cell centre the mean of its 4 vertices. The
cell across a face is found by matching sorted vertex triples; −1 on a wall.

The configuration's `mesh` entry: family "kershawtet", "n" = (nx, ny, nz)
the hex lattice, "eps" the Kershaw distortion, "bounds" optional.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.mesh import Geometry, lattice

# the six tets of a hex whose vertices are ordered x fastest (reference/mesh.py),
# all positively oriented, sharing the diagonal 0-6
HEX_TO_TETS = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6),
               (0, 5, 1, 6))
# local vertex numbers of the four faces of a tet
TET_FACES = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))


def tets(mesh: dict) -> tuple[np.ndarray, np.ndarray]:
    """(points (nV, 3), cells (6·nH, 4)), hex-major."""
    if mesh["family"] != "kershawtet":
        raise ValueError(f"not a Kershaw-tetra mesh: {mesh['family']!r}")
    pts, hexes = lattice({**mesh, "family": "kershaw"})
    return pts, hexes[:, np.asarray(HEX_TO_TETS)].reshape(-1, 4)


def cell_centres(mesh: dict) -> np.ndarray:
    """(nC, 3) float64: the mean of each tet's 4 vertices."""
    pts, cells = tets(mesh)
    return np.stack([pts[:, d][cells].mean(axis=1) for d in range(3)], axis=1)


def geometry(mesh: dict, periodic: bool = False) -> Geometry:
    """The four faces of every tet; the mesh has walls only."""
    if periodic:
        raise ValueError("a Kershaw-tetra mesh has no periodic form")
    pts, cells = tets(mesh)
    n_cells = cells.shape[0]
    centroid = pts[cells].mean(axis=1)  # (nC, 3)
    fv = cells[:, np.asarray(TET_FACES)]  # (nC, 4, 3) vertex ids
    a, b, c = (pts[fv[..., i]] for i in range(3))
    S = 0.5 * np.cross(b - a, c - a)
    centre = (a + b + c) / 3.0
    outward = np.einsum("cfd,cfd->cf", S, centre - centroid[:, None]) >= 0
    S = np.where(outward[..., None], S, -S)
    volume = np.einsum("cfd,cfd->c", centre, S) / 3.0

    key = np.sort(fv.reshape(-1, 3), axis=1)
    order = np.lexsort(key.T[::-1])
    same = (key[order[1:]] == key[order[:-1]]).all(axis=1)
    first, second = order[:-1][same], order[1:][same]
    neighbour = np.full(n_cells * 4, -1, dtype=np.int64)
    neighbour[first], neighbour[second] = second // 4, first // 4
    return Geometry(tuple(int(v) for v in mesh["n"]), volume, S, neighbour.reshape(n_cells, 4))
