"""Frozen hexahedral mesh geometry: the cartesian and Kershaw lattices and the
finite-volume quantities of each cell's six faces, in float64 NumPy.

A frozen copy of the port's generators (`_hex_grid_points_cells`,
`_kershaw_warp`) and of its face geometry (`_fast_build_homogeneous`): the
lattice's vertices x fastest, cells numbered x fastest (cell (i, j, k) is
i + nx·(j + ny·k)), each face's area vector by the fan triangulation around
its vertex mean, its centre the area-weighted mean of the fan's triangles,
the cell volume by the divergence theorem V = (1/3) Σ_f c_f · S_f, and the
cell centre the mean of its 8 vertices. Kept per cell and local face, with
the neighbour found on the lattice, rather than as a global face list.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# local vertex numbers of the six faces of a hexahedron whose vertices are
# ordered x fastest: 0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0), 4 to 7 at z + 1
HEX_FACES = ((0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4), (3, 7, 6, 2), (0, 4, 7, 3),
             (1, 2, 6, 5))
# the lattice step (axis x=0 y=1 z=2, direction) across each of those faces
FACE_STEP = ((2, -1), (2, 1), (1, -1), (1, 1), (0, -1), (0, 1))
DEFAULT_BOUNDS = ((-0.5, 0.5),) * 3


def kershaw_warp(pts: np.ndarray, bounds, eps: float) -> np.ndarray:
    """z sheared by a kinked profile whose amplitude depends on (x, y)."""
    bounds = np.asarray(bounds, dtype=np.float64).reshape(3, 2)
    lo, hi = bounds[:, 0], bounds[:, 1]
    u = (pts - lo) / (hi - lo)
    x, y, z = u[:, 0], u[:, 1], u[:, 2]

    def tri(t):
        return 1.0 - 2.0 * np.abs(t - np.floor(t + 0.5))

    amp = 0.5 * (1.0 - eps) * tri(2 * x) * tri(2 * y)
    out = u.copy()
    out[:, 2] = z + amp * np.sin(2 * np.pi * z) / np.pi
    return lo + out * (hi - lo)


def lattice(mesh: dict) -> tuple[np.ndarray, np.ndarray]:
    """(points (nV, 3), cells (nC, 8)) of the configuration's `mesh` entry:
    family "cartesian" or "kershaw" (with "eps"), "n" = (nx, ny, nz)."""
    nx, ny, nz = (int(v) for v in mesh["n"])
    bounds = np.asarray(mesh.get("bounds", DEFAULT_BOUNDS), dtype=np.float64).reshape(3, 2)
    xs = [np.linspace(bounds[d, 0], bounds[d, 1], int(mesh["n"][d]) + 1) for d in range(3)]
    Z, Y, X = np.meshgrid(xs[2], xs[1], xs[0], indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)
    if mesh["family"] == "kershaw":
        pts = kershaw_warp(pts, bounds, float(mesh["eps"]))
    elif mesh["family"] != "cartesian":
        raise ValueError(f"unknown mesh family {mesh['family']!r}")
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    i, j, k = i.reshape(-1), j.reshape(-1), k.reshape(-1)

    def vid(i, j, k):
        return (k * (ny + 1) + j) * (nx + 1) + i

    cells = np.stack([vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k), vid(i, j + 1, k),
                      vid(i, j, k + 1), vid(i + 1, j, k + 1), vid(i + 1, j + 1, k + 1),
                      vid(i, j + 1, k + 1)], axis=1).astype(np.int64)
    return pts, cells


def cell_centres(mesh: dict) -> np.ndarray:
    """(nC, 3) float64: the mean of each cell's 8 vertices."""
    pts, cells = lattice(mesh)
    return np.stack([pts[:, d][cells].mean(axis=1) for d in range(3)], axis=1)


@dataclass
class Geometry:
    shape: tuple[int, int, int]  # (nx, ny, nz)
    volume: np.ndarray  # (nC,)
    S: np.ndarray  # (nC, F, 3) outward area vectors of the local faces (F = 6 here)
    neighbour: np.ndarray  # (nC, F): the cell across each face, -1 on a wall

    @property
    def n_cells(self) -> int:
        return self.volume.shape[0]

    @property
    def area(self) -> np.ndarray:
        return np.linalg.norm(self.S, axis=2)

    def min_ratio_vol_surf(self) -> float:
        """min over cells of V / (sum of the cell's face areas)."""
        return float((self.volume / self.area.sum(axis=1)).min())


def geometry(mesh: dict, periodic: bool = False) -> Geometry:
    """The six faces of every cell; `periodic` wraps the lattice's boundary
    faces onto the opposite cell."""
    pts, cells = lattice(mesh)
    shape = tuple(int(v) for v in mesh["n"])
    comp = [np.ascontiguousarray(pts[:, d]) for d in range(3)]
    centroid = np.stack([c[cells].mean(axis=1) for c in comp], axis=1)
    n_cells = cells.shape[0]
    S = np.empty((n_cells, 6, 3))
    centre = np.empty((n_cells, 6, 3))
    for f, fv in enumerate(HEX_FACES):
        P = [c[cells[:, list(fv)]] for c in comp]  # 3 × (nC, 4)
        m = [p.mean(axis=1) for p in P]
        B = [p[:, [1, 2, 3, 0]] for p in P]
        d1 = [p - mm[:, None] for p, mm in zip(P, m)]
        d2 = [b - mm[:, None] for b, mm in zip(B, m)]
        tri = [0.5 * (d1[1] * d2[2] - d1[2] * d2[1]),
               0.5 * (d1[2] * d2[0] - d1[0] * d2[2]),
               0.5 * (d1[0] * d2[1] - d1[1] * d2[0])]
        total = np.stack([t.sum(axis=1) for t in tri], axis=1)
        tri_area = np.sqrt(tri[0] ** 2 + tri[1] ** 2 + tri[2] ** 2)
        w = np.maximum(tri_area.sum(axis=1), 1e-300)
        ctr = np.stack([((p + b + mm[:, None]) / 3.0 * tri_area).sum(axis=1) / w
                        for p, b, mm in zip(P, B, m)], axis=1)
        outward = np.einsum("ij,ij->i", total, ctr - centroid) >= 0
        S[:, f] = np.where(outward[:, None], total, -total)
        centre[:, f] = ctr
    volume = np.einsum("cfd,cfd->c", centre, S) / 3.0

    idx = np.arange(n_cells, dtype=np.int64)
    coords = np.stack([idx % shape[0], (idx // shape[0]) % shape[1],
                       idx // (shape[0] * shape[1])], axis=1)
    strides = (1, shape[0], shape[0] * shape[1])
    neighbour = np.empty((n_cells, 6), dtype=np.int64)
    for f, (axis, step) in enumerate(FACE_STEP):
        c = coords[:, axis] + step
        inside = (c >= 0) & (c < shape[axis])
        wrapped = idx + (np.mod(c, shape[axis]) - coords[:, axis]) * strides[axis]
        neighbour[:, f] = np.where(inside | periodic, wrapped, -1)
    return Geometry(shape, volume, S, neighbour)
