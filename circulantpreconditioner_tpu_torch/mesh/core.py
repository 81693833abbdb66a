"""Host-side mesh core: flat face/cell arrays for vectorized FV assembly.

NumPy copy of circulantpreconditioner_tpu/mesh/core.py (same fields, same
numbering), kept in the port so that it imports no JAX, with
`set_periodic` and `validate`.

Replacement for the SOLVERLAB/CDMATH Mesh/Cell/Face object API the
reference walks cell-by-cell (src/WaveSystem.cxx:109-176). Instead of an
object graph, a mesh here is a set of flat NumPy arrays in face-major form —
exactly what vectorized scatter-add assembly and device kernels need:

- `face_cells[f] = (L, R)`: the two incident cells; R = -1 on boundary faces.
- `face_normal[f]`: unit normal pointing OUT of cell L.
- `face_area[f]`, `cell_volume[c]`, `cell_center[c]`.
- `face_group[f]`: integer boundary-group code (0 = interior); group names
  (Wall/Periodic/Neumann/...) live in `groups` — the analog of
  Face::getGroupName (WaveSystem.cxx:150-168).
- `periodic_twin[f]`: the CELL on the other side of the periodic wrap for a
  periodic boundary face (or -1). The reference goes face → twin face →
  twin cell (getIndexFacePeriodic + Fp.getCellsId()[0], WaveSystem.cxx:159-167);
  we store the resulting cell directly.

All preprocessing is host-side NumPy (built once), matching the reference's
rank-0 assembly model (SURVEY.md §2.6); solvers receive static device arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

INTERIOR = 0


@dataclass
class BoundaryGroup:
    name: str
    code: int


@dataclass
class Mesh:
    dim: int
    cell_center: np.ndarray  # (nC, dim)
    cell_volume: np.ndarray  # (nC,)
    face_cells: np.ndarray  # (nF, 2) int64; [:,1] == -1 on boundary
    face_normal: np.ndarray  # (nF, dim) unit, outward from face_cells[:,0]
    face_area: np.ndarray  # (nF,)
    face_center: np.ndarray  # (nF, dim)
    face_group: np.ndarray  # (nF,) int32; 0 = interior
    groups: dict[str, int] = field(default_factory=dict)  # name -> code
    periodic_twin: np.ndarray | None = None  # (nF,) int64 twin CELL id, or -1
    # structured metadata (None for unstructured meshes)
    structured_shape: tuple[int, ...] | None = None  # (nx, ny, nz-like, xyz order)
    bounds: np.ndarray | None = None  # (dim, 2) [min, max] per axis
    name: str = "mesh"

    @property
    def n_cells(self) -> int:
        return self.cell_center.shape[0]

    @property
    def n_faces(self) -> int:
        return self.face_cells.shape[0]

    @property
    def is_structured(self) -> bool:
        return self.structured_shape is not None

    def group_code(self, name: str) -> int:
        return self.groups[name]

    def boundary_faces(self) -> np.ndarray:
        return np.nonzero(self.face_cells[:, 1] < 0)[0]

    def max_neighbours(self) -> int:
        """Max faces per cell (PETSc preallocation analog getMaxNbNeighbours)."""
        cnt = np.zeros(self.n_cells, dtype=np.int64)
        np.add.at(cnt, self.face_cells[:, 0], 1)
        inner = self.face_cells[:, 1]
        m = inner >= 0
        np.add.at(cnt, inner[m], 1)
        return int(cnt.max())

    def set_periodic(self, axes=None, tol: float = 1e-6) -> None:
        """Pair opposite boundary faces by translation along each axis in
        `axes` (default: all), tag them "Periodic", and record the twin CELL
        in `periodic_twin` and the twin FACE in `periodic_twin_face` (the
        diffusion assembly's shared pair distance uses both face centres).
        The boundary must lie on the bounding-box planes; faces are matched
        by their in-plane centre coordinates."""
        bb = self.bbox()
        axes = list(range(self.dim)) if axes is None else list(axes)
        scale = float((bb[:, 1] - bb[:, 0]).max())
        if self.periodic_twin is None:
            self.periodic_twin = np.full(self.n_faces, -1, dtype=np.int64)
        if getattr(self, "periodic_twin_face", None) is None:
            self.periodic_twin_face = np.full(self.n_faces, -1, dtype=np.int64)  # type: ignore[attr-defined]
        code = self.groups.get("Periodic")
        if code is None:
            code = max(self.groups.values(), default=0) + 1
            self.groups["Periodic"] = code
        bnd = self.boundary_faces()
        fc = self.face_center[bnd][:, : self.dim]
        for d in axes:
            lo = bnd[np.abs(fc[:, d] - bb[d, 0]) < tol * scale]
            hi = bnd[np.abs(fc[:, d] - bb[d, 1]) < tol * scale]
            if len(lo) != len(hi):
                raise ValueError(f"axis {d}: {len(lo)} low vs {len(hi)} high boundary faces")
            other = [a for a in range(self.dim) if a != d]
            key = lambda f: tuple(  # noqa: E731
                np.round(self.face_center[f, a] / (tol * scale)).astype(np.int64) for a in other)
            table = {key(f): f for f in hi}
            if len(table) != len(hi):
                raise ValueError(f"axis {d}: duplicate face keys — decrease tol")
            for f in lo:
                tw = table.get(key(f))
                if tw is None:
                    raise ValueError(f"axis {d}: no periodic twin for face {f}")
                self.periodic_twin[f] = self.face_cells[tw, 0]
                self.periodic_twin[tw] = self.face_cells[f, 0]
                self.periodic_twin_face[f] = tw  # type: ignore[attr-defined]
                self.periodic_twin_face[tw] = f  # type: ignore[attr-defined]
                self.face_group[f] = code
                self.face_group[tw] = code

    def min_ratio_vol_surf(self) -> float:
        """min over cells of |V| / |∂V| — the reference's minRatioVolSurf used
        in every CFL dt formula (e.g. TransportEquationFFT_...cxx:45)."""
        surf = np.zeros(self.n_cells)
        np.add.at(surf, self.face_cells[:, 0], self.face_area)
        inner = self.face_cells[:, 1]
        m = inner >= 0
        np.add.at(surf, inner[m], self.face_area[m])
        return float((self.cell_volume / surf).min())

    def bbox(self) -> np.ndarray:
        """(dim, 2) domain bounding box: structured bounds if known, vertex
        coordinates if the mesh carries them (unstructured generators /
        readers), cell centers as a last resort."""
        if self.bounds is not None:
            return self.bounds
        pts = getattr(self, "points", None)
        src = pts[:, : self.dim] if pts is not None else self.cell_center
        lo = src.min(axis=0)
        hi = src.max(axis=0)
        return np.stack([lo, hi], axis=1)

    def validate(self) -> None:
        """Check the invariants: positive volumes and areas, unit normals,
        and the divergence-theorem closure Σ_faces A·n = 0 of every cell.
        Raises ValueError naming the first that fails."""
        if not (self.cell_volume > 0).all():
            raise ValueError("non-positive cell volume")
        if not (self.face_area > 0).all():
            raise ValueError("non-positive face area")
        if not np.allclose(np.linalg.norm(self.face_normal, axis=1), 1.0, atol=1e-10):
            raise ValueError("non-unit face normal")
        closure = np.zeros((self.n_cells, self.dim))
        np.add.at(closure, self.face_cells[:, 0], self.face_area[:, None] * self.face_normal)
        inner = self.face_cells[:, 1]
        m = inner >= 0
        np.add.at(closure, inner[m], -self.face_area[m, None] * self.face_normal[m])
        worst = np.abs(closure).max()
        if worst >= 1e-9 * max(np.abs(self.face_area).max(), 1.0):
            raise ValueError(f"cell closure violated: max {worst:.3e}")
