"""Vectorized finite-volume assembly: scalar transport and diffusion (CSR),
the wave system (BSR), and the periodic-grid stencils of the diffusion and
wave operators. PyTorch counterpart of
circulantpreconditioner_tpu/ops/assembly.py.

The divergence matrix D ≈ dt·L gives the explicit step Uⁿ⁺¹ = Uⁿ − D Uⁿ and
the implicit step (I + D) Uⁿ⁺¹ = Uⁿ. For a face with unit normal n outward of
cell L and un = n·a, row L gets
    D[L,L] += dt·|F|/|V_L| · max(un, 0)
    D[L,R] += dt·|F|/|V_L| · min(un, 0)
and symmetrically for R with −n: the standard upwind, for which I + D on a
periodic uniform grid is exactly the circulant C = I + Σ λ_d (I − S_d).

Wave-system blocks ((p, q) per cell, dim+1 unknowns, src/WaveSystem.cxx:92-107):
    A(n)   = [[0, c0²nᵀ], [n, 0]],   |A|(n) = [[c0, 0], [0, c0·nnᵀ]]
    Am     = (A − |A|)/2 · dt·|F|/|V|
    interior/periodic:  D[L,R] += Am,  D[L,L] −= Am
    wall (mirror ghost U_R = (I − 2vvᵀ)U_L, v = (0, n)):
                        D[L,L] += −Am·(2vvᵀ)        (WaveSystem.cxx:150-157)
    neumann: no contribution                          (WaveSystem.cxx:168)
"""

from __future__ import annotations

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.mesh.core import Mesh
from circulantpreconditioner_tpu_torch.ops.csr import BSRMatrix, CSRMatrix


def _face_sides(mesh: Mesh):
    """Expand faces into per-side (cell, other, normal, area, group, twin)
    arrays: each interior face contributes both orientations."""
    L = mesh.face_cells[:, 0]
    R = mesh.face_cells[:, 1]
    interior = R >= 0
    twin = mesh.periodic_twin if mesh.periodic_twin is not None else np.full(mesh.n_faces, -1)
    cell = np.concatenate([L, R[interior]])
    other = np.concatenate([R, L[interior]])
    normal = np.concatenate([mesh.face_normal, -mesh.face_normal[interior]])
    area = np.concatenate([mesh.face_area, mesh.face_area[interior]])
    group = np.concatenate([mesh.face_group, mesh.face_group[interior]])
    twin_cell = np.concatenate([twin, np.full(int(interior.sum()), -1, dtype=np.int64)])
    return cell, other, normal, area, group, twin_cell


def transport_divergence_csr(mesh: Mesh, dt: float, velocity, *, device: torch.device,
                             dtype: torch.dtype, boundary: str = "auto") -> CSRMatrix:
    """Scalar upwind divergence matrix D (without the identity shift).

    boundary: "auto" honors per-face groups (Periodic couples through the
    wrap, everything else is a Neumann no-op); "neumann" forces the no-op on
    all boundaries.
    """
    a = np.asarray(velocity, dtype=np.float64)[: mesh.dim]
    cell, other, normal, area, group, twin_cell = _face_sides(mesh)
    un = normal @ a
    coeff = dt * area / mesh.cell_volume[cell]

    is_boundary = other < 0
    m_int = ~is_boundary
    rows = [cell[m_int], cell[m_int]]
    cols = [cell[m_int], other[m_int]]
    vals = [coeff[m_int] * np.maximum(un[m_int], 0.0), coeff[m_int] * np.minimum(un[m_int], 0.0)]

    per_code = mesh.groups.get("Periodic")
    if boundary == "auto" and mesh.periodic_twin is not None and per_code is not None:
        m_per = is_boundary & (group == per_code) & (twin_cell >= 0)
        rows += [cell[m_per], cell[m_per]]
        cols += [cell[m_per], twin_cell[m_per]]
        vals += [coeff[m_per] * np.maximum(un[m_per], 0.0),
                 coeff[m_per] * np.minimum(un[m_per], 0.0)]
    # all other boundary faces: Neumann → nothing

    n = mesh.n_cells
    return CSRMatrix.from_coo(n, n, np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals), device=device, dtype=dtype)


def diffusion_csr(mesh: Mesh, dt: float, nu: float, *, device: torch.device,
                  dtype: torch.dtype, boundary: str = "auto") -> CSRMatrix:
    """Scalar diffusion operator D = dt·ν·L (two-point flux approximation,
    no identity shift): the implicit heat step is (I + D)uⁿ⁺¹ = uⁿ.

    TPFA flux per face: ν·|F|·(u_other − u_cell)/d, d = ‖c_other − c_cell‖.
    A periodic face pair shares one distance d = ‖x_f − c_cell‖ +
    ‖x_f' − c_twin‖ (the two face-to-centre legs across the wrap), so the
    unscaled coefficient ν|F|/d is the same on both sides and V·L stays
    symmetric on warped meshes; without a twin-face map the one-sided
    distance is doubled. Other boundaries are insulated (no flux). L is
    symmetric positive semi-definite, constants in its kernel."""
    L = mesh.face_cells[:, 0]
    R = mesh.face_cells[:, 1]
    interior = R >= 0
    cc = mesh.cell_center[:, : mesh.dim]
    fc = mesh.face_center[:, : mesh.dim]
    cell, other, _, area, group, twin_cell = _face_sides(mesh)
    fctr = np.concatenate([fc, fc[interior]])

    is_boundary = other < 0
    m_int = ~is_boundary
    d = np.linalg.norm(cc[other[m_int]] - cc[cell[m_int]], axis=1)
    coef = dt * nu * area[m_int] / (d * mesh.cell_volume[cell[m_int]])
    rows = [cell[m_int], cell[m_int]]
    cols = [cell[m_int], other[m_int]]
    vals = [coef, -coef]

    per_code = mesh.groups.get("Periodic")
    if boundary == "auto" and mesh.periodic_twin is not None and per_code is not None:
        m_per = is_boundary & (group == per_code) & (twin_cell >= 0)
        twin_face = getattr(mesh, "periodic_twin_face", None)
        face_idx = np.concatenate([np.arange(mesh.n_faces), np.arange(mesh.n_faces)[interior]])
        tf = (np.full(mesh.n_faces, -1, dtype=np.int64) if twin_face is None
              else np.asarray(twin_face))[face_idx[m_per]]
        d_self = np.linalg.norm(fctr[m_per] - cc[cell[m_per]], axis=1)
        d_twin = np.where(tf >= 0,
                          np.linalg.norm(fc[np.maximum(tf, 0)] - cc[twin_cell[m_per]], axis=1),
                          d_self)  # no twin-face map: the doubled one-sided distance
        d = d_self + d_twin
        coef = dt * nu * area[m_per] / (d * mesh.cell_volume[cell[m_per]])
        rows += [cell[m_per], cell[m_per]]
        cols += [cell[m_per], twin_cell[m_per]]
        vals += [coef, -coef]
    # all other boundaries: no flux (insulated)

    n = mesh.n_cells
    return CSRMatrix.from_coo(n, n, np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals), device=device, dtype=dtype)


def diffusion_stencil(dim: int, dt: float, nu: float, spacing_xyz):
    """Periodic-uniform-grid stencil (offsets_zyx, (k, 1, 1) coefficients) of
    D = dt·ν·L, the input of the m = 1 block-circulant solvers (the FFT
    direct solve and the diffusion projection PC)."""
    h = np.asarray(spacing_xyz, dtype=np.float64)[:dim]
    lam = dt * nu / (h * h)  # xyz
    offsets = [(0,) * dim]
    blocks = [[[2.0 * float(lam.sum())]]]
    for d_xyz in range(dim):
        for sgn in (+1, -1):
            off = [0] * dim
            off[dim - 1 - d_xyz] = sgn  # zyx order
            offsets.append(tuple(off))
            blocks.append([[-float(lam[d_xyz])]])
    return offsets, np.asarray(blocks)


def wave_jacobian_blocks(normal: np.ndarray, c0: float) -> tuple[np.ndarray, np.ndarray]:
    """Batched A(n) and |A|(n) for the linear wave system; normal (k, dim).
    Mirrors jacobianMatrices (WaveSystem.cxx:92-107) without the coeff factor."""
    k, dim = normal.shape
    A = np.zeros((k, dim + 1, dim + 1))
    absA = np.zeros((k, dim + 1, dim + 1))
    A[:, 1:, 0] = normal
    A[:, 0, 1:] = c0 * c0 * normal
    absA[:, 0, 0] = c0
    absA[:, 1:, 1:] = c0 * normal[:, :, None] * normal[:, None, :]
    return A, absA


def wave_divergence_bsr(mesh: Mesh, dt: float, c0: float, *, device: torch.device,
                        dtype: torch.dtype) -> BSRMatrix:
    """Block upwind divergence matrix for the wave system ((dim+1)² blocks).

    Boundary handling by group name: "Periodic" couples through the wrap,
    "Neumann" is a no-op, anything else gets the wall mirror condition: the
    reference's precedence (WaveSystem.cxx:148-173)."""
    nb = mesh.dim + 1
    cell, other, normal, area, group, twin_cell = _face_sides(mesh)
    coeff = dt * area / mesh.cell_volume[cell]

    A, absA = wave_jacobian_blocks(normal, c0)
    Am = (A - absA) * (0.5 * coeff[:, None, None])

    is_boundary = other < 0
    m_int = ~is_boundary
    brows = [cell[m_int], cell[m_int]]
    bcols = [other[m_int], cell[m_int]]
    blocks = [Am[m_int], -Am[m_int]]

    per_code = mesh.groups.get("Periodic")
    neu_code = mesh.groups.get("Neumann")
    if per_code is not None and mesh.periodic_twin is not None:
        m_per = is_boundary & (group == per_code) & (twin_cell >= 0)
        brows += [cell[m_per], cell[m_per]]
        bcols += [twin_cell[m_per], cell[m_per]]
        blocks += [Am[m_per], -Am[m_per]]
    else:
        m_per = np.zeros_like(is_boundary)

    m_neu = (is_boundary & (group == neu_code) if neu_code is not None
             else np.zeros_like(is_boundary))
    m_wall = is_boundary & ~m_per & ~m_neu
    if m_wall.any():
        v = np.zeros((int(m_wall.sum()), nb))
        v[:, 1:] = normal[m_wall]
        mirror = 2.0 * v[:, :, None] * v[:, None, :]  # 2 v vᵀ
        brows.append(cell[m_wall])
        bcols.append(cell[m_wall])
        blocks.append(-np.einsum("kij,kjl->kil", Am[m_wall], mirror))

    n = mesh.n_cells
    return BSRMatrix.from_block_coo(n, n, np.concatenate(brows), np.concatenate(bcols),
                                    np.concatenate(blocks), device=device, dtype=dtype)


def wave_block_stencil(dim: int, dt: float, c0: float, spacing) -> tuple[list, np.ndarray]:
    """Periodic-uniform-grid block stencil {offset_zyx: B} of I + D for the
    wave system (the input of the block-circulant solver)."""
    nb = dim + 1
    h = np.asarray(spacing, dtype=np.float64)[:dim]
    offsets: list[tuple[int, ...]] = []
    blocks: list[np.ndarray] = []
    center = np.eye(nb)
    for d in range(dim):  # xyz axis index
        for sgn in (+1.0, -1.0):
            e = np.zeros((1, dim))
            e[0, d] = sgn
            A, absA = wave_jacobian_blocks(e, c0)
            Am = 0.5 * (A[0] - absA[0]) * (dt / h[d])
            off = [0] * dim  # zyx offset: axis index dim-1-d in zyx order
            off[dim - 1 - d] = int(sgn)
            offsets.append(tuple(off))
            blocks.append(Am)
            center = center - Am
    offsets.append((0,) * dim)
    blocks.append(center)
    return offsets, np.stack(blocks)
