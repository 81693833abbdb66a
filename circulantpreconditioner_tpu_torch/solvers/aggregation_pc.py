"""Multilevel V-cycle preconditioners built from Galerkin coarse operators
(PyTorch counterpart of circulantpreconditioner_tpu/solvers/aggregation_pc.py).

The coarse operators are exact Galerkin restrictions R·A·P of the assembled
fine operator (piecewise-constant P, mean R, R·P = I), built on the host with
SciPy, so they inherit the warped coefficients. The smoother is ω-damped
point-block Jacobi, V(1,1) by default, and the bottom level is a dense
inverse (one matmul). Two hierarchies, each in one layout:

- `AggregationVCyclePC` (algebraic, any mesh; cell-major): consecutive chunks
  of `factor` block rows form the aggregates, so the transfers are reshapes,
  sums and broadcasts; the coarse operators are clustered-window SpMVs
  (ops/window_spmv.py); ω = 1.
- `GridVCyclePC` (meshes whose topology is a grid: the warped Kershaw
  hexahedra, and the tet meshes with their 6 cells per grid site;
  field-major): on a supercell mesh the first level aggregates the cells of
  each site, then each level coarsens 2×2×2 boxes of sites and applies its
  operator as a gather-free 7-point varying stencil, flat or periodic
  (grid_last); the fine level uses the caller's operator (the model's: kernel
  K2 on the GPU for the Kershaw hexahedra), and the bottom inverse is kept in
  field-major order. Its cell-major `apply` is one relayout pair around
  `apply_fm`. The ω = 0.8 damping is load-bearing: undamped block-Jacobi
  smoothing amplifies high-frequency error on the upwind wave operator.

One recursion, `_vcycle`, runs both. Each level carries its `_Stages`,
chosen when the hierarchy is built: a grid level below the fine one whose
stencil kernel K5 takes (ops/vcycle_sweep.py: a 3D flat-layout stencil of
m ≤ 8), in a cycle with post-smoothing, gets K5's stages, one launch each on
CUDA tensors and their plain PyTorch versions on the CPU; every other level
gets the generic stages, whose field-major smoothing steps z + ω·Dinv·(r − A z)
are one launch of kernel K6 each on the card (ops/block_jacobi.py) and an
einsum on the CPU. `utils.graphs.STATS` counts the visits of levels below
the fine one that K5 ran (`vcycle_levels_fused`) and that it did not
(`_plain`). The levels below the fine one and the bottom solve are the device
span "port.pc.coarse"; a supercell level's own work (smoothing, residuals,
transfers) the device span "port.pc.site".
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops import block_jacobi, vcycle_sweep
from circulantpreconditioner_tpu_torch.ops.csr import BSRMatrix
from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator
from circulantpreconditioner_tpu_torch.solvers.preconditioners import cell_major_adapter
from circulantpreconditioner_tpu_torch.utils.graphs import STATS
from circulantpreconditioner_tpu_torch.utils.profiling import device_span, host_spanned

# --- the transfers and smoothings of an aggregation level (_Level) ------------


def _smooth(L: _Level, omega: float, r: torch.Tensor) -> torch.Tensor:
    z = torch.einsum("nij,nj->ni", L.Dinv, r.reshape(-1, L.b)).reshape(-1)
    return omega * z if omega != 1.0 else z


def _restrict(L: _Level, r: torch.Tensor) -> torch.Tensor:
    rb = r.reshape(-1, L.b)
    pad = L.n_agg * L.factor - L.n
    if pad:
        rb = torch.nn.functional.pad(rb, (0, 0, 0, pad))
    s = rb.reshape(L.n_agg, L.factor, L.b).sum(dim=1)
    return (s * L.cnt_inv[:, None]).reshape(-1)


def _prolong(L: _Level, zc: torch.Tensor) -> torch.Tensor:
    zb = zc.reshape(L.n_agg, 1, L.b).expand(L.n_agg, L.factor, L.b)
    return zb.reshape(-1, L.b)[:L.n].reshape(-1)


# field-major variants: vectors are flat with x.reshape(factor·b, n_agg) as
# the field view, the supercell layout; valid when n == factor·n_agg (the
# cells-per-site aggregation of GridVCyclePC.from_grid_model)


def _smooth_fm(L: _Level, omega: float, g: torch.Tensor) -> torch.Tensor:
    gk = g.reshape(L.factor, L.b, L.n_agg)
    DT = L.Dinv.reshape(L.n_agg, L.factor, L.b, L.b)
    z = torch.einsum("nkij,kjn->kin", DT, gk).reshape(-1)
    return omega * z if omega != 1.0 else z


def _restrict_fm(L: _Level, g: torch.Tensor) -> torch.Tensor:
    return (g.reshape(L.factor, L.b, L.n_agg).sum(dim=0) * L.cnt_inv[None, :]).reshape(-1)


def _prolong_fm(L: _Level, zc: torch.Tensor) -> torch.Tensor:
    return zc.reshape(1, L.b, L.n_agg).expand(L.factor, L.b, L.n_agg).reshape(-1)


# --- the same of a grid level (_GridLevel), field-major -----------------------


def _grid_smooth_fm(L: _GridLevel, omega: float, g: torch.Tensor) -> torch.Tensor:
    z = torch.einsum("nij,jn->in", L.Dinv, g.reshape(L.b, -1)).reshape(-1)
    return omega * z if omega != 1.0 else z


def _box_sum(g: torch.Tensor, shape_zyx, cshape_zyx, lead: int) -> torch.Tensor:
    """Sum over 2×2×2 boxes of the grid axes g.shape[lead:lead+3], the grid
    zero-padded to even extents."""
    pads = [0, 0] * (g.ndim - lead - 3)
    for n, c in zip(reversed(shape_zyx), reversed(cshape_zyx)):
        pads += [0, 2 * c - n]
    if any(pads):
        g = torch.nn.functional.pad(g, pads)
    cz, cy, cx = cshape_zyx
    shp = g.shape
    g = g.reshape(shp[:lead] + (cz, 2, cy, 2, cx, 2) + shp[lead + 3:])
    return g.sum(dim=(lead + 1, lead + 3, lead + 5))


def _grid_restrict_fm(L: _GridLevel, g: torch.Tensor) -> torch.Tensor:
    nx, ny, nz = L.shape_xyz
    cx, cy, cz = L.cshape_xyz
    s = _box_sum(g.reshape(L.b, nz, ny, nx), (nz, ny, nx), (cz, cy, cx), 1)
    return (s * L.cnt_inv.reshape(1, cz, cy, cx)).reshape(-1)


def _grid_prolong_fm(L: _GridLevel, zc: torch.Tensor) -> torch.Tensor:
    nx, ny, nz = L.shape_xyz
    cx, cy, cz = L.cshape_xyz
    g = zc.reshape(L.b, cz, 1, cy, 1, cx, 1).expand(L.b, cz, 2, cy, 2, cx, 2)
    return g.reshape(L.b, 2 * cz, 2 * cy, 2 * cx)[:, :nz, :ny, :nx].reshape(-1)


def _smooth_step(smooth, L, omega: float, r, z=None, y=None):
    """z + smooth(L, ω, r − y), y = A z; smooth(L, ω, r) without z."""
    return smooth(L, omega, r) if z is None else z + smooth(L, omega, r - y)


def _smooth_step_fm(smooth, L, omega: float, r, z=None, y=None):
    """The same on field-major vectors: one K6 launch on the card, `smooth`
    its plain version on the CPU (the level's Dinv cell-major, its cells g to
    a site on a supercell level)."""
    g = L.factor if isinstance(L, _Level) else 1
    return block_jacobi.run(functools.partial(smooth, L, omega), L.Dinv, "cell", g, omega, r,
                            z, y)


# --- a level's stages ---------------------------------------------------------


class _Stages(NamedTuple):
    """What the V-cycle does at a level, in the level's layout:
    smooth(L, ω, r) = ω·Dinv·r; sweep(L, ω, r, z, zc=None): z' = z + P zc
    (z' = z without zc; the generic stages write z' into z), then
    z' + ω·Dinv·(r − A z'); restrict(L, r, z) =
    R (r − A z), the next level's right-hand side; prolong(L, zc) = P zc, the
    post-step of a cycle without post-smoothing. `fused`: K5 runs them on
    CUDA tensors."""

    smooth: Callable
    sweep: Callable
    restrict: Callable
    prolong: Callable
    fused: bool = False


def _generic(smooth, restrict, prolong, field_major: bool) -> _Stages:
    """The stages on the level's own operator (L.A_fm when `field_major`,
    else L.A) and the plain transfers; each smoothing step is
    `_smooth_step_fm` (K6 on the card) when `field_major`, else
    `_smooth_step`."""
    step = _smooth_step_fm if field_major else _smooth_step

    def op(L):
        return L.A_fm if field_major else L.A

    def sweep(L, omega, r, z, zc=None):
        if zc is not None:
            # in place: the V-cycle drops the z it hands over, and a new z'
            # beside it would add a vector to the step's peak memory
            z = z.add_(prolong(L, zc))
        return step(smooth, L, omega, r, z, op(L)(z))

    return _Stages(functools.partial(step, smooth), sweep,
                   lambda L, r, z: restrict(L, r - op(L)(z)), prolong)


def _sweep_plain(L: _GridLevel, omega: float, r: torch.Tensor, z: torch.Tensor,
                 zc: torch.Tensor | None = None) -> torch.Tensor:
    """K5's sweep in plain PyTorch: z' = z + P zc (none when zc is None),
    then z' + ω·Dinv·(r − A z'). Its smoothing is `_grid_smooth_fm` and its
    restriction `_GRID.restrict`."""
    if zc is not None:
        z = z + _grid_prolong_fm(L, zc)
    return z + _grid_smooth_fm(L, omega, r - L.A_fm(z))


def _fused_smooth(L: _GridLevel, omega: float, r: torch.Tensor) -> torch.Tensor:
    if r.is_cuda:
        return vcycle_sweep.smooth_cuda(L.Dinv, r, omega)
    return _grid_smooth_fm(L, omega, r)


def _fused_restrict(L: _GridLevel, r: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    if r.is_cuda:
        return vcycle_sweep.restrict_cuda(L.stencil, L.cnt_inv, L.cshape_xyz, r, z)
    return _GRID.restrict(L, r, z)


def _fused_sweep(L: _GridLevel, omega: float, r: torch.Tensor, z: torch.Tensor,
                 zc: torch.Tensor | None = None) -> torch.Tensor:
    if r.is_cuda:
        return vcycle_sweep.sweep_cuda(L.stencil, L.Dinv, L.cshape_xyz, omega, r, z, zc)
    return _sweep_plain(L, omega, r, z, zc)


# AggregationVCyclePC's levels, a supercell level, a grid level
_CELL = _generic(_smooth, _restrict, _prolong, field_major=False)
_SITE = _generic(_smooth_fm, _restrict_fm, _prolong_fm, field_major=True)
_GRID = _generic(_grid_smooth_fm, _grid_restrict_fm, _grid_prolong_fm, field_major=True)
_K5 = _Stages(_fused_smooth, _fused_sweep, _fused_restrict, _grid_prolong_fm, fused=True)


def _coarse_stages(stencil, dtype: torch.dtype, n_smooth) -> _Stages:
    """A grid level below the fine one: K5's stages where K5 takes its
    stencil in `dtype` and a post-smoothing sweep carries the prolongation,
    else the generic ones."""
    return _K5 if n_smooth[1] >= 1 and vcycle_sweep.takes(stencil, dtype) else _GRID


@dataclass
class _Level:
    """An aggregation level: `factor` consecutive block rows per aggregate."""

    A: Callable | None     # cell-major flat operator apply (AggregationVCyclePC)
    Dinv: torch.Tensor     # (n, b, b) inverted diagonal blocks (the smoother)
    cnt_inv: torch.Tensor  # (n_agg,) 1/|aggregate|, for the mean restriction
    n: int                 # block rows at this level
    b: int                 # block size
    factor: int            # aggregation factor to the next level
    n_agg: int             # block rows at the next level
    A_fm: Callable | None = None  # field-major flat operator apply (a supercell level)
    span: str | None = None  # the device span of the level's own work (a supercell level's)
    stages: _Stages = _CELL


@dataclass
class _GridLevel:
    """A level on an (nx, ny, nz) site grid: box mean / broadcast transfers
    and a 7-point varying-stencil operator, field-major."""

    Dinv: torch.Tensor     # (n_sites, b, b) inverted diagonal blocks
    cnt_inv: torch.Tensor  # (cz, cy, cx, 1) 1/|box|, boundary truncation included
    shape_xyz: tuple       # fine grid (nx, ny, nz)
    cshape_xyz: tuple      # coarse grid (cx, cy, cz)
    b: int
    A_fm: Callable | None = None  # field-major flat operator apply
    stencil: object | None = None  # a coarse level's VaryingStencilOperator (None: the fine level)
    stages: _Stages = _GRID


def _vcycle(levels, bot_inv, n_smooth, omega, l, r):
    """One V-cycle from level l, in the hierarchy's layout. bot_inv: the
    dense bottom inverse in that layout, or a callable that takes the bottom
    level's place (parallel/vcycle_dist.py: the gather to the replicated
    levels)."""
    if l == len(levels):
        return bot_inv(r) if callable(bot_inv) else bot_inv @ r
    L = levels[l]
    S = L.stages
    if l > 0:
        if S.fused and r.is_cuda:
            STATS.vcycle_levels_fused += 1
        else:
            STATS.vcycle_levels_plain += 1
    with _level_span(L, r.device):
        z = S.smooth(L, omega, r)
        for _ in range(n_smooth[0] - 1):
            z = S.sweep(L, omega, r, z)
        rc = S.restrict(L, r, z)
    # from level 0, every coarser level and the bottom solve: "port.pc.coarse"
    with (device_span("port.pc.coarse", r.device) if l == 0 else contextlib.nullcontext()):
        zc = _vcycle(levels, bot_inv, n_smooth, omega, l + 1, rc)
    with _level_span(L, r.device):
        if not n_smooth[1]:
            return z + S.prolong(L, zc)
        z = S.sweep(L, omega, r, z, zc)
        for _ in range(n_smooth[1] - 1):
            z = S.sweep(L, omega, r, z)
    return z


def _level_span(L, device: torch.device):
    """The level's device span (`_Level.span`) around its work before and
    after the coarser levels, which it leaves out."""
    span = getattr(L, "span", None)
    return device_span(span, device) if span else contextlib.nullcontext()


def _shifted_apply(Dmv, shift, x):
    return shift * x + Dmv(x)


class AggregationVCyclePC:
    """M⁻¹ r ≈ A⁻¹ r by one V(pre, post) cycle over Galerkin coarse levels;
    see the module docstring."""

    def __init__(self, levels, bot_inv: torch.Tensor, n_smooth=(1, 1), omega: float = 1.0,
                 b: int | None = None):
        self.levels = tuple(levels)
        self.bot_inv = bot_inv
        self.n_smooth = tuple(n_smooth)
        self.omega = float(omega)
        self.b = int(b) if b is not None else (levels[-1].b if levels else 1)  # fields a cell

    @classmethod
    @host_spanned("port.setup.pc")
    def from_bsr(cls, D: BSRMatrix, A0_apply=None, shift: float = 1.0, factor: int = 4,
                 bottom_max: int = 1200, n_smooth=(1, 1), omega: float = 1.0,
                 dtype: torch.dtype | None = None, max_levels: int = 10, window_G: int = 8):
        """Preconditioner of A = shift·I + D, D the assembled block operator.
        A0_apply: the production fine-level matvec; a clustered-window
        operator of D where None."""
        import scipy.sparse as sp

        device = D.blocks.device
        dtype = dtype or D.blocks.dtype
        b = D.block_size
        A0 = (shift * sp.identity(D.shape[0], format="csr")
              + D.to_scipy().astype(np.float64)).tocsr()
        if A0_apply is None:
            W0 = WindowedBlockOperator.from_bsr(D, G=window_G, dtype=dtype)
            A0_apply = functools.partial(_shifted_apply, W0.matvec, shift)

        levels = []
        A_l, apply_l = A0, A0_apply
        n_l = A0.shape[0] // b
        for _ in range(max_levels):
            if n_l <= bottom_max:
                break
            n_agg = -(-n_l // factor)
            agg = np.arange(n_l) // factor
            cnt = np.bincount(agg, minlength=n_agg).astype(np.float64)
            levels.append(_Level(A=apply_l, Dinv=_block_diag_inv(A_l, b, device, dtype),
                                 cnt_inv=torch.as_tensor(1.0 / cnt).to(device=device,
                                                                       dtype=dtype),
                                 n=n_l, b=b, factor=factor, n_agg=n_agg))
            A_l = _galerkin_map(A_l, b, agg, n_agg)
            n_l = n_agg
            apply_l = _windowed_from_scipy_bsr(A_l, b, n_l, window_G, device, dtype).matvec

        bot_inv = torch.as_tensor(np.linalg.inv(A_l.toarray())).to(device=device, dtype=dtype)
        return cls(levels, bot_inv, n_smooth=n_smooth, omega=omega, b=b)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """Cell-major flat apply."""
        return _vcycle(self.levels, self.bot_inv, self.n_smooth, self.omega, 0, r)

    __call__ = apply

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1


class GridVCyclePC(AggregationVCyclePC):
    """The geometric-Galerkin grid V-cycle, field-major; see the module
    docstring."""

    @classmethod
    @host_spanned("port.setup.pc")
    def from_grid_model(cls, D: BSRMatrix, shape_xyz, cells_per_site: int = 1,
                        A0_apply=None, A0_apply_fm=None, shift: float = 1.0,
                        bottom_max: int = 600, n_smooth=(1, 1), omega: float = 0.8,
                        dtype: torch.dtype | None = None):
        """Preconditioner of A = shift·I + D. A0_apply_fm: the production
        fine-level matvec on field-major flat vectors; where it is None,
        A0_apply (cell-major flat) behind one relayout pair, and where both
        are None, D's varying stencil (on a supercell mesh its dense
        (cps·b)² form, 8× the block-sparse one: pass the model's own to
        avoid it)."""
        import scipy.sparse as sp

        from circulantpreconditioner_tpu_torch.ops.stencil import VaryingStencilOperator

        device = D.blocks.device
        dtype = dtype or D.blocks.dtype
        b = D.block_size
        cps = int(cells_per_site)
        # the blocks in their working dtype, widened: the JAX package's
        # D.to_csr(dtype).to_scipy() without the round trip to the device
        A0 = (shift * sp.identity(D.shape[0], format="csr")
              + D.to_scipy().astype(np.float64)).tocsr()
        if A0_apply_fm is None and A0_apply is not None:
            A0_apply_fm = cell_major_adapter(A0_apply, cps * b)
        elif A0_apply_fm is None:
            op0 = VaryingStencilOperator.from_bsr(D, shape_xyz, dtype=dtype, cells_per_site=cps)
            A0_apply_fm = functools.partial(_shifted_apply, op0.matvec_fm_flat, shift)

        levels = []
        A_l = A0
        if cps > 1:
            # level 0 → 1: the cps cells of each site, contiguous in the
            # hex-major numbering, so the transfers are reshapes (_Level)
            n0, n_sites = A0.shape[0] // b, int(np.prod(shape_xyz))
            levels.append(_Level(A=None, Dinv=_block_diag_inv(A_l, b, device, dtype),
                                 cnt_inv=torch.full((n_sites,), 1.0 / cps, device=device,
                                                    dtype=dtype),
                                 n=n0, b=b, factor=cps, n_agg=n_sites, A_fm=A0_apply_fm,
                                 span="port.pc.site", stages=_SITE))
            A_l = _galerkin_chunk(A_l, b, n0, cps, n_sites)
        shape = tuple(int(v) for v in shape_xyz)
        while int(np.prod(shape)) > bottom_max:
            cshape = tuple(-(-s // 2) for s in shape)
            nx, ny, nz = shape
            cx, cy, cz = cshape
            # site → box flat index map (x fastest)
            xi, yi, zi = np.arange(nx) // 2, np.arange(ny) // 2, np.arange(nz) // 2
            site = (xi[None, None, :] + cx * yi[None, :, None]
                    + cx * cy * zi[:, None, None]).reshape(-1)
            n_c = cx * cy * cz
            cnt = np.bincount(site, minlength=n_c).astype(np.float64)
            cnt_inv = torch.as_tensor((1.0 / cnt).reshape(cz, cy, cx, 1)).to(
                device=device, dtype=dtype)
            if levels:
                op_l = _varying_from_scipy(A_l, b, shape, device, dtype)
                A_fm, stages = op_l.matvec_fm_flat, _coarse_stages(op_l, dtype, n_smooth)
            else:  # the fine level: the production operator
                op_l, A_fm, stages = None, A0_apply_fm, _GRID
            levels.append(_GridLevel(Dinv=_block_diag_inv(A_l, b, device, dtype),
                                     cnt_inv=cnt_inv, shape_xyz=shape, cshape_xyz=cshape, b=b,
                                     A_fm=A_fm, stencil=op_l, stages=stages))
            A_l = _galerkin_map(A_l, b, site, n_c)
            shape = cshape

        # the bottom in field-major order: row i·Nc + c is site c's field i
        inv = np.linalg.inv(A_l.toarray())
        fm = np.arange(inv.shape[0]).reshape(-1, b).T.reshape(-1)
        bot_inv = torch.as_tensor(inv[np.ix_(fm, fm)]).to(device=device, dtype=dtype)
        return cls(levels, bot_inv, n_smooth=n_smooth, omega=omega, b=b)

    def apply_fm(self, g: torch.Tensor) -> torch.Tensor:
        """Field-major flat apply: g.reshape(b, n) is the field view, or, on a
        supercell fine level, g.reshape(cps·b, n_sites)."""
        return _vcycle(self.levels, self.bot_inv, self.n_smooth, self.omega, 0, g)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """Cell-major flat apply: one relayout pair around `apply_fm`."""
        L0 = self.levels[0] if self.levels else None
        m = L0.factor * L0.b if isinstance(L0, _Level) else self.b
        return self.apply_fm(r.reshape(-1, m).T.reshape(-1)).reshape(m, -1).T.reshape(-1)

    __call__ = apply


def _galerkin_chunk(A_csr, b: int, n: int, factor: int, n_agg: int):
    """Galerkin R·A·P over chunks of `factor` consecutive block rows."""
    return _galerkin_map(A_csr, b, np.arange(n) // factor, n_agg)


def _galerkin_map(A_csr, b: int, agg: np.ndarray, n_agg: int):
    """Galerkin R·A·P for an aggregate map (piecewise-constant P, mean R),
    block size b."""
    import scipy.sparse as sp

    n = len(agg)
    cnt = np.bincount(agg, minlength=n_agg).astype(np.float64)
    P_a = sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, n_agg))
    R_a = sp.csr_matrix((1.0 / cnt[agg], (agg, np.arange(n))), shape=(n_agg, n))
    eye_b = sp.identity(b, format="csr")
    P = sp.kron(P_a, eye_b).tocsr()
    R = sp.kron(R_a, eye_b).tocsr()
    return (R @ A_csr @ P).tocsr()


def _varying_from_scipy(A_csr, b: int, shape_xyz, device: torch.device, dtype: torch.dtype):
    from circulantpreconditioner_tpu_torch.ops.stencil import VaryingStencilOperator

    Ab = A_csr.tobsr(blocksize=(b, b))
    brows = np.repeat(np.arange(A_csr.shape[0] // b), np.diff(Ab.indptr))
    return VaryingStencilOperator.from_blocks(brows, Ab.indices, Ab.data, shape_xyz,
                                              device=device, dtype=dtype)


def _block_diag_inv(A_csr, b: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """(n, b, b) inverted diagonal blocks of a SciPy CSR with b×b block
    structure."""
    coo = A_csr.tocoo()
    n = A_csr.shape[0] // b
    br, bc = coo.row // b, coo.col // b
    m = br == bc
    blocks = np.zeros((n, b, b))
    blocks[br[m], coo.row[m] % b, coo.col[m] % b] = coo.data[m]
    return torch.as_tensor(np.linalg.inv(blocks)).to(device=device, dtype=dtype)


def _windowed_from_scipy_bsr(A_csr, b: int, n_brows: int, G: int, device: torch.device,
                             dtype: torch.dtype) -> WindowedBlockOperator:
    """Clustered-window operator from a SciPy CSR with b×b block structure."""
    Ab = A_csr.tobsr(blocksize=(b, b))
    brows = np.repeat(np.arange(n_brows), np.diff(Ab.indptr))
    return WindowedBlockOperator.from_block_coo(n_brows, brows, Ab.indices, Ab.data, G=G,
                                                device=device, dtype=dtype)
