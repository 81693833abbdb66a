"""Frozen upwind assembly of the implicit operators A = I + D, in float64
SciPy sparse form, from the reference's own geometry (the configuration's
mesh family: reference/mesh.py or reference/families/; any number of faces
a cell).

A frozen copy of the port's `transport_divergence_csr` and
`wave_divergence_bsr`. For a face of cell c with outward area vector S:

- transport, velocity a: D[c, c] += dt·max(S·a, 0)/V_c and
  D[c, other] += dt·min(S·a, 0)/V_c across interior and periodic faces;
  a wall face adds nothing (the port's Neumann no-op);
- wave system (p, q) with sound speed c0, n = S/|S|, k = dt·|S|/V_c:
  A(n) = [[0, c0² nᵀ], [n, 0]], |A|(n) = [[c0, 0], [0, c0·n nᵀ]],
  Am = k·(A − |A|)/2; across interior and periodic faces D[c, other] += Am and
  D[c, c] −= Am; on a wall (mirror ghost) D[c, c] −= Am·2vvᵀ with v = (0, n).

dt = cfl · min(V / Σ|S|) / ‖a‖ (transport) or / c0 (wave), as in the port's
models. Unknowns are cell-major: cell c's components are rows c·m … c·m + m−1.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from portbench.reference import family
from portbench.reference.mesh import Geometry


def transport_dt(geo: Geometry, velocity, cfl: float) -> float:
    return float(cfl * geo.min_ratio_vol_surf() / np.linalg.norm(velocity))


def wave_dt(geo: Geometry, c0: float, cfl: float) -> float:
    return float(cfl * geo.min_ratio_vol_surf() / c0)


def _blocks_to_bsr(diag: np.ndarray, off: np.ndarray, neighbour: np.ndarray) -> sp.bsr_matrix:
    """BSR of I + D from the diagonal blocks (nC, m, m) and the blocks
    across each face (nC, F, m, m), the faces without a neighbour dropped."""
    n_cells, m = diag.shape[0], diag.shape[1]
    keep = neighbour >= 0
    counts = 1 + keep.sum(axis=1)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    cols = np.concatenate([np.arange(n_cells)[:, None], neighbour], axis=1)
    data = np.concatenate([(diag + np.eye(m))[:, None], off], axis=1)
    mask = np.concatenate([np.ones((n_cells, 1), bool), keep], axis=1)
    return sp.bsr_matrix((data[mask], cols[mask], indptr), shape=(n_cells * m, n_cells * m))


def transport_operator(geo: Geometry, velocity, dt: float) -> sp.csr_matrix:
    """A = I + D of the upwind transport step (float64 CSR)."""
    a = np.asarray(velocity, dtype=np.float64)
    un = geo.S @ a  # (nC, F): S·a
    coef = dt / geo.volume[:, None]
    coupled = geo.neighbour >= 0
    diag = (coef * np.maximum(un, 0.0) * coupled).sum(axis=1)
    off = coef * np.minimum(un, 0.0)
    return _blocks_to_bsr(diag[:, None, None], off[:, :, None, None], geo.neighbour).tocsr()


def wave_operator(geo: Geometry, c0: float, dt: float) -> sp.bsr_matrix:
    """A = I + D of the upwind wave system, 4×4 blocks (float64 BSR)."""
    area = geo.area
    n = geo.S / area[:, :, None]  # (nC, F, 3)
    k = dt * area / geo.volume[:, None]
    A = np.zeros(n.shape[:2] + (4, 4))
    absA = np.zeros_like(A)
    A[..., 1:, 0] = n
    A[..., 0, 1:] = c0 * c0 * n
    absA[..., 0, 0] = c0
    absA[..., 1:, 1:] = c0 * n[..., :, None] * n[..., None, :]
    Am = 0.5 * (A - absA) * k[..., None, None]
    coupled = geo.neighbour >= 0
    v = np.zeros(n.shape[:2] + (4,))
    v[..., 1:] = n
    wall = Am @ (2.0 * v[..., :, None] * v[..., None, :])
    diag = -np.where(coupled[..., None, None], Am, wall).sum(axis=1)
    return _blocks_to_bsr(diag, Am, geo.neighbour)


def implicit_operator(config: dict, boundary: str):
    """(A = I + D, dt) of a configuration: model "transport" or "wave", on
    the `boundary` "wall" or "periodic"."""
    geo = family(config["mesh"]).geometry(config["mesh"], periodic=boundary == "periodic")
    if config["model"] == "transport":
        dt = transport_dt(geo, config["velocity"], config["cfl"])
        return transport_operator(geo, config["velocity"], dt), dt
    if config["model"] == "wave":
        dt = wave_dt(geo, config["c0"], config["cfl"])
        return wave_operator(geo, config["c0"], dt), dt
    raise ValueError(f"unknown model {config['model']!r}")
