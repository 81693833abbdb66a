"""Circulant FFT preconditioners for non-cartesian meshes by projection onto
a cartesian grid (PyTorch counterpart of
circulantpreconditioner_tpu/solvers/circulant_pc.py).

    M⁻¹ = P_back · C⁻¹ · P

- the grid: n_d = round(nbCells^(1/dim)) cells per axis over the mesh's
  bounding box, λ_d = a_d·dt/Δ_d (`derive_grid_context`);
- P (grid ← cells): each voxel averages the cells nearest to
  samples_per_axis^dim regular points inside it ("sample"), or takes the
  volume deposits of the cells ("volume");
- P_back (cells ← grid): each cell takes the voxel that holds its centroid;
- C⁻¹: the scalar transport circulant (`CirculantProjectionPC`), the periodic
  block-circulant wave operator (`BlockCirculantProjectionPC`), the
  wall-boundary DCT/DST wave solve (`DCTBlockProjectionPC`) or the periodic
  diffusion operator I + dt·ν·L_h (`DiffusionProjectionPC`).

P and P_back are built once on the host (NumPy, SciPy's cKDTree) and applied
on the device, as clustered-window operators where their windows fit in
256 MiB (ops/window_spmv.py), the same choice as the JAX package's, else as
CSR. `projection="identity"` maps recovered-grid cells one to one onto the
voxels; on a mesh where that does not apply it raises (the JAX package
samples instead).

The periodic coarse solves run by torch.fft (cuFFT on the GPU) by default.
`use_matmul_dft=True` selects the staged DFT by matmul instead, the JAX
package's default (its FFT lowering is slow on the TPU); it is kept for the
parity tests, which compare against that default.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.mesh.core import Mesh
from circulantpreconditioner_tpu_torch.ops.circulant import (
    BlockCirculantOperator,
    CirculantTransportOperator,
)
from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix
from circulantpreconditioner_tpu_torch.ops.dft_matmul import (
    MatmulBlockCirculantSolver,
    MatmulCirculantSolver,
)
from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator
from circulantpreconditioner_tpu_torch.utils.profiling import host_spanned

PROJECTIONS = ("auto", "sample", "volume", "identity")
WINDOW_MAX_BYTES = 256 * 2**20


def derive_grid_context(mesh: Mesh, velocity, dt: float):
    """(n_xyz, spacing, λ_xyz, bbox): n_d = round(nbCells^(1/dim)) per axis
    (at least 2) over the mesh's bounding box, λ_d = a_d·dt/Δ_d."""
    dim = mesh.dim
    n_side = int(round(mesh.n_cells ** (1.0 / dim)))
    n_xyz = (max(n_side, 2),) * dim
    bbox = mesh.bbox()
    spacing = [(bbox[d, 1] - bbox[d, 0]) / n_xyz[d] for d in range(dim)]
    a = np.asarray(velocity, dtype=np.float64)[:dim]
    lambdas_xyz = [a[d] * dt / spacing[d] for d in range(dim)]
    return n_xyz, tuple(spacing), tuple(lambdas_xyz), bbox


def _cell_volume_samples(mesh: Mesh, levels: int = 1):
    """Equal-sub-volume sample points per cell, (S, n_cells, dim): a
    tetrahedron splits at its centroid into 4 sub-tets of equal volume,
    `levels` times; other cells (hexahedra, Kershaw cells) keep their
    centroid."""
    dim = mesh.dim
    cv = getattr(mesh, "cell_vertices", None)
    C = mesh.cell_center[:, :dim]
    if dim != 3 or cv is None:
        return C[None, :, :]
    if isinstance(cv, np.ndarray):
        is_tet = (cv >= 0).sum(axis=1) == 4 if cv.ndim == 2 else None
        verts = cv
    else:
        sizes = np.array([len(c) for c in cv])
        is_tet = sizes == 4
        verts = np.full((mesh.n_cells, 4), -1, dtype=np.int64)
        for i, c in enumerate(cv):
            if len(c) == 4:
                verts[i] = list(c)
    if is_tet is None or not is_tet.any():
        return C[None, :, :]
    pts = getattr(mesh, "points", None)
    if pts is None:
        return C[None, :, :]

    tets = np.where(is_tet)[0]
    corners = pts[verts[tets][:, :4]][:, :, :dim]  # (nt, 4, dim)

    def split(tet_corners):
        # one level: 4 equal-volume sub-tets (vertex i replaced by the centroid)
        c = tet_corners.mean(axis=1, keepdims=True)
        subs = []
        for i in range(4):
            sc = tet_corners.copy()
            sc[:, i:i + 1, :] = c
            subs.append(sc)
        return np.stack(subs, axis=1)  # (nt, 4, 4, dim)

    cur = corners[:, None, :, :]
    for _ in range(max(0, levels)):
        nt, s = cur.shape[0], cur.shape[1]
        cur = split(cur.reshape(nt * s, 4, cur.shape[-1]))
        cur = cur.reshape(nt, s * 4, 4, cur.shape[-1])
    S = cur.shape[1]
    tet_pts = cur.mean(axis=2)  # (nt, S, dim) sub-tet centroids

    out = np.repeat(C[None, :, :], S, axis=0).copy()
    out[:, tets, :] = tet_pts.transpose(1, 0, 2)
    return out


@host_spanned("port.setup.pc")
def build_projection_matrices(mesh: Mesh, n_xyz, bbox, samples_per_axis: int = 3, *,
                              device: torch.device, dtype: torch.dtype,
                              method: str = "sample") -> tuple[CSRMatrix, CSRMatrix]:
    """(P grid ← cells, P_back cells ← grid) as CSR.

    method="sample": each voxel averages the nearest cells (cKDTree on the
    cell centroids) of samples_per_axis^dim regular points inside it.
    method="volume": each cell deposits its volume, over its equal-volume
    sample points, into the voxels holding them; rows are normalised by the
    deposited mass, and a voxel with no deposit takes its nearest cell.
    P_back row c samples the voxel holding centroid(c)."""
    from scipy.spatial import cKDTree

    if method not in ("sample", "volume"):
        raise ValueError(f"method must be 'sample' or 'volume', got {method!r}")
    dim = mesh.dim
    n_xyz = tuple(int(v) for v in n_xyz)
    h = np.array([(bbox[d, 1] - bbox[d, 0]) / n_xyz[d] for d in range(dim)])
    lo = bbox[:, 0]
    n_cart = int(np.prod(n_xyz))
    csr = functools.partial(CSRMatrix.from_coo, device=device, dtype=dtype)

    def voxel_of(pts):
        idx = np.clip(((pts - lo[:dim]) / h).astype(np.int64), 0, np.asarray(n_xyz) - 1)
        flat = np.zeros(len(pts), dtype=np.int64)
        stride = 1
        for d in range(dim):
            flat += idx[:, d] * stride
            stride *= n_xyz[d]
        return flat

    # voxel centres, x-fastest flattening (z, y, x C-order)
    axes = [lo[d] + (np.arange(n_xyz[d]) + 0.5) * h[d] for d in range(dim)]
    grids = np.meshgrid(*reversed(axes), indexing="ij")
    cart_centers = np.stack([g.reshape(-1) for g in reversed(grids)], axis=1)

    if method == "volume":
        samples = _cell_volume_samples(mesh)  # (S, n_cells, dim)
        S = samples.shape[0]
        w = np.repeat(mesh.cell_volume[None, :] / S, S, axis=0).reshape(-1)
        rows = voxel_of(samples.reshape(-1, dim))
        cols = np.tile(np.arange(mesh.n_cells), S)
        mass = np.zeros(n_cart)
        np.add.at(mass, rows, w)
        empty = np.where(mass == 0)[0]
        if empty.size:
            tree = cKDTree(mesh.cell_center[:, :dim])
            _, owner = tree.query(cart_centers[empty])
            rows = np.concatenate([rows, empty])
            cols = np.concatenate([cols, owner])
            w = np.concatenate([w, np.ones(empty.size)])
            mass[empty] = 1.0
        P = csr(n_cart, mesh.n_cells, rows, cols, w / mass[rows])
    else:
        tree = cKDTree(mesh.cell_center[:, :dim])
        s = samples_per_axis
        offs_1d = [((np.arange(s) + 0.5) / s - 0.5) * h[d] for d in range(dim)]
        offs = np.meshgrid(*reversed(offs_1d), indexing="ij")
        offsets = np.stack([o.reshape(-1) for o in reversed(offs)], axis=1)
        pts = (cart_centers[:, None, :] + offsets[None, :, :]).reshape(-1, dim)
        _, owner = tree.query(pts)
        owner = owner.reshape(n_cart, -1)
        rows = np.repeat(np.arange(n_cart), owner.shape[1])
        P = csr(n_cart, mesh.n_cells, rows, owner.reshape(-1),
                np.full(rows.shape[0], 1.0 / owner.shape[1]))

    P_back = csr(mesh.n_cells, n_cart, np.arange(mesh.n_cells),
                 voxel_of(mesh.cell_center[:, :dim]), np.ones(mesh.n_cells))
    return P, P_back


def _identity_projection_applies(mesh: Mesh, n_xyz) -> bool:
    """True when the derived grid is the mesh's own topology grid with one
    cell per site: cells are then numbered x-fastest like the voxels, and the
    projection is the identity."""
    ts = getattr(mesh, "topology_shape", None)
    cps = int(getattr(mesh, "cells_per_site", 1) or 1)
    return ts is not None and tuple(ts) == tuple(n_xyz) and cps == 1


def _try_window(P: CSRMatrix, max_bytes: int = WINDOW_MAX_BYTES):
    """Clustered-window form of a projection CSR (G = 8, unit = 8), or None
    when its windows exceed `max_bytes` or cannot be allocated."""
    try:
        W = WindowedBlockOperator.from_csr(P, G=8, unit=8)
    except MemoryError:
        return None
    return W if W.window_bytes <= max_bytes else None


def _block_identity_apply(op, r):
    return op.solve(r)


def _scalar_identity_apply(solver, r):
    return solver.solve(r.reshape(solver.shape_zyx)).reshape(-1)


def _block_proj_apply(P, op, P_back, r):
    nb = op.m
    r_cart = P.matvec(r.reshape(-1, nb))  # (n_cart, nb)
    x_cart = op.solve(r_cart.reshape(-1))
    return P_back.matvec(x_cart.reshape(-1, nb)).reshape(-1)


def _block_proj_apply_win(Pw, op, Pbw, r):
    nb = op.m
    r_cart = Pw.matvec_multi(r.reshape(-1, nb))
    x_cart = op.solve(r_cart.reshape(-1))
    return Pbw.matvec_multi(x_cart.reshape(-1, nb)).reshape(-1)


def _scalar_proj_apply(P, solver, P_back, r):
    x_cart = solver.solve(P.matvec(r).reshape(solver.shape_zyx)).reshape(-1)
    return P_back.matvec(x_cart)


def _scalar_proj_apply_win(Pw, solver, Pbw, r):
    x_cart = solver.solve(Pw.matvec(r).reshape(solver.shape_zyx)).reshape(-1)
    return Pbw.matvec(x_cart)


def _set_projection(pc, mesh, n_xyz, bbox, samples_per_axis, device, dtype, projection,
                    applies: tuple, solver) -> None:
    """Sets pc.P, pc.P_back, pc.projection and pc.apply. `applies` holds the
    (identity, CSR, window) apply functions of the PC's kind."""
    if projection not in PROJECTIONS:
        raise ValueError(f"projection must be one of {PROJECTIONS}, got {projection!r}")
    ident_apply, proj_apply, win_apply = applies
    if projection == "identity":
        if not _identity_projection_applies(mesh, n_xyz):
            raise ValueError(
                f"projection='identity' needs a mesh whose topology grid is the derived "
                f"grid {tuple(n_xyz)} with one cell per site; this mesh has topology "
                f"{getattr(mesh, 'topology_shape', None)}")
        pc.P = pc.P_back = None
        pc.projection = "identity"
        pc.apply = functools.partial(ident_apply, solver)
        return
    pc.P, pc.P_back = build_projection_matrices(
        mesh, n_xyz, bbox, samples_per_axis, device=device, dtype=dtype,
        method="volume" if projection == "volume" else "sample")
    Pw, Pbw = _try_window(pc.P), _try_window(pc.P_back)
    if Pw is not None and Pbw is not None:
        pc.projection = "sample-window"
        pc.apply = functools.partial(win_apply, Pw, solver, Pbw)
    else:
        pc.projection = "sample"
        pc.apply = functools.partial(proj_apply, pc.P, solver, pc.P_back)


_BLOCK_APPLIES = (_block_identity_apply, _block_proj_apply, _block_proj_apply_win)
_SCALAR_APPLIES = (_scalar_identity_apply, _scalar_proj_apply, _scalar_proj_apply_win)


class BlockCirculantProjectionPC:
    """Block-circulant projection PC for the wave system:
    M⁻¹ = (P_back ⊗ I_nb) · C_blk⁻¹ · (P ⊗ I_nb), C_blk the periodic cartesian
    wave operator (ops/assembly.py::wave_block_stencil) inverted in
    frequency space. The FV operator has wall boundaries, so the periodic
    coarse operator mismatches it there; DCTBlockProjectionPC removes that."""

    def __init__(self, mesh: Mesh, dt: float, c0: float, *, device: torch.device,
                 dtype: torch.dtype, samples_per_axis: int = 3, use_matmul_dft: bool = False,
                 projection: str = "auto"):
        from circulantpreconditioner_tpu_torch.ops.assembly import wave_block_stencil

        n_xyz, spacing, _, bbox = derive_grid_context(mesh, [0.0] * mesh.dim, dt)
        self.n_xyz = n_xyz
        self.nb = mesh.dim + 1
        offsets, blocks = wave_block_stencil(mesh.dim, dt, c0, spacing)
        shape_zyx = tuple(reversed(n_xyz))
        if use_matmul_dft:
            self.op = MatmulBlockCirculantSolver.from_stencil(
                shape_zyx, offsets, blocks, device=device, dtype=dtype, precision="high")
        else:
            self.op = BlockCirculantOperator.from_stencil(shape_zyx, offsets, blocks,
                                                          device=device, dtype=dtype)
        _set_projection(self, mesh, n_xyz, bbox, samples_per_axis, device, dtype, projection,
                        _BLOCK_APPLIES, self.op)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.apply(r)


class DCTBlockProjectionPC:
    """Wall-boundary block projection PC for the wave system: the projection
    of BlockCirculantProjectionPC around the exact wall-boundary cartesian
    solve (ops/dct_wave.py::DCTBlockWaveSolver)."""

    def __init__(self, mesh: Mesh, dt: float, c0: float, *, device: torch.device,
                 dtype: torch.dtype, samples_per_axis: int = 3, precision: str = "high",
                 projection: str = "auto"):
        from circulantpreconditioner_tpu_torch.ops.dct_wave import DCTBlockWaveSolver

        n_xyz, spacing, _, bbox = derive_grid_context(mesh, [0.0] * mesh.dim, dt)
        self.n_xyz = n_xyz
        self.nb = mesh.dim + 1
        self.op = DCTBlockWaveSolver.create(tuple(reversed(n_xyz)), mesh.dim, dt, c0, spacing,
                                            device=device, dtype=dtype, precision=precision)
        _set_projection(self, mesh, n_xyz, bbox, samples_per_axis, device, dtype, projection,
                        _BLOCK_APPLIES, self.op)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.apply(r)


class CirculantProjectionPC:
    """M⁻¹ = P_back · C⁻¹ · P for GMRES on the transport operator of a
    non-cartesian mesh; C the periodic transport circulant of the derived
    grid, solved by the FFT or by the staged DFT (use_matmul_dft). The
    projection always samples, as in the JAX package: "volume" raises."""

    def __init__(self, mesh: Mesh, velocity, dt: float, *, device: torch.device,
                 dtype: torch.dtype, samples_per_axis: int = 3, use_matmul_dft: bool = False,
                 projection: str = "auto"):
        if projection == "volume":
            raise ValueError("CirculantProjectionPC samples; projection='volume' is for the "
                             "block PCs")
        n_xyz, _, lambdas_xyz, bbox = derive_grid_context(mesh, velocity, dt)
        self.n_xyz = n_xyz
        self.op = CirculantTransportOperator.create(
            tuple(reversed(n_xyz)), tuple(reversed(lambdas_xyz)), device=device, dtype=dtype)
        self.solver = MatmulCirculantSolver.from_operator(self.op) if use_matmul_dft else self.op
        _set_projection(self, mesh, n_xyz, bbox, samples_per_axis, device, dtype, projection,
                        _SCALAR_APPLIES, self.solver)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.apply(r)


class DiffusionProjectionPC:
    """Projection PC for the diffusion equation on non-cartesian meshes:
    the residual projected onto the derived cartesian grid, (I + dt·ν·L_h)⁻¹
    applied in frequency space (the m = 1 block-circulant solve of
    ops/assembly.py::diffusion_stencil), and projected back."""

    def __init__(self, mesh: Mesh, dt: float, nu: float, *, device: torch.device,
                 dtype: torch.dtype, samples_per_axis: int = 3, use_matmul_dft: bool = False,
                 projection: str = "auto"):
        from circulantpreconditioner_tpu_torch.ops.assembly import diffusion_stencil

        n_xyz, spacing, _, bbox = derive_grid_context(mesh, [0.0] * mesh.dim, dt)
        self.n_xyz = n_xyz
        offsets, blocks = diffusion_stencil(mesh.dim, dt, nu, spacing)
        blocks = blocks.copy()
        blocks[0] += 1.0  # the symbol of I + D
        shape_zyx = tuple(reversed(n_xyz))
        if use_matmul_dft:
            self.op = MatmulBlockCirculantSolver.from_stencil(
                shape_zyx, offsets, blocks, device=device, dtype=dtype, precision="high")
        else:
            self.op = BlockCirculantOperator.from_stencil(shape_zyx, offsets, blocks,
                                                          device=device, dtype=dtype)
        _set_projection(self, mesh, n_xyz, bbox, samples_per_axis, device, dtype, projection,
                        _BLOCK_APPLIES, self.op)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.apply(r)
