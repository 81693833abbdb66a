"""Multilevel V-cycle preconditioners built from Galerkin coarse operators
(PyTorch counterpart of circulantpreconditioner_tpu/solvers/aggregation_pc.py).

The coarse operators are exact Galerkin restrictions R·A·P of the assembled
fine operator (piecewise-constant P, mean R, R·P = I), built on the host with
SciPy, so they inherit the warped coefficients. The smoother is ω-damped
point-block Jacobi, V(1,1) by default, and the bottom level is a dense
inverse (one matmul). Two hierarchies:

- `AggregationVCyclePC` (algebraic, any mesh): consecutive chunks of `factor`
  block rows form the aggregates, so the transfers are reshapes, sums and
  broadcasts; the coarse operators are clustered-window SpMVs
  (ops/window_spmv.py); ω = 1.
- `GridVCyclePC` (meshes whose topology is a grid: the warped Kershaw
  hexahedra, and the tet meshes with their 6 cells per grid site): on a
  supercell mesh the first level aggregates the cells of each site (an
  aggregation level, in both layouts), then each level coarsens 2×2×2 boxes
  of sites and applies its operator as a gather-free 7-point varying
  stencil; the fine level uses the caller's operators (the model's: kernel
  K2 on the GPU for the Kershaw hexahedra). The ω = 0.8 damping is
  load-bearing: undamped block-Jacobi smoothing amplifies high-frequency
  error on the upwind wave operator.

On the card, a grid level below the fine one whose operator is a 3D
flat-layout varying stencil of m ≤ 8 runs as kernel K5 (ops/vcycle_sweep.py):
a V(pre, post ≥ 1) visit is one smoothing launch, one residual-and-
restriction launch, the next level, and one launch of prolongation and
post-smoothing, each extra sweep one more; the level above the bottom
writes the bottom's right-hand side in its cell-major order and reads its
answer back in it. A CPU tensor runs the same stages in their plain PyTorch
versions. A level whose coarser levels lack a field-major operator (a
periodic grid_last level below it) keeps the V-cycle's generic stages, as do
the fine level and the algebraic hierarchy's levels; `utils.graphs.STATS`
counts the visits of levels below the fine one that K5 ran
(`vcycle_levels_fused`) and that it did not (`_plain`). On field-major
vectors each smoothing step of the generic stages, z + ω·Dinv·(r − A z)
after A z, is one launch of kernel K6 on the card (ops/block_jacobi.py: the
hex fine level, a tet mesh's site level), its einsum on the CPU. The levels
below the fine one are the device span "port.pc.coarse"; a supercell level's own work
(smoothing, residuals, transfers) the device span "port.pc.site".
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops import block_jacobi, vcycle_sweep
from circulantpreconditioner_tpu_torch.ops.csr import BSRMatrix
from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator
from circulantpreconditioner_tpu_torch.utils.graphs import STATS
from circulantpreconditioner_tpu_torch.utils.profiling import device_span, host_spanned


@dataclass
class _Level:
    """An aggregation level: `factor` consecutive block rows per aggregate."""

    A: Callable            # cell-major flat operator apply
    Dinv: torch.Tensor     # (n, b, b) inverted diagonal blocks (the smoother)
    cnt_inv: torch.Tensor  # (n_agg,) 1/|aggregate|, for the mean restriction
    n: int                 # block rows at this level
    b: int                 # block size
    factor: int            # aggregation factor to the next level
    n_agg: int             # block rows at the next level
    A_fm: Callable | None = None  # field-major flat operator apply (grid PCs only)
    span: str | None = None  # the device span of the level's own work (a supercell level's)


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


@dataclass
class _GridLevel:
    """A level on an (nx, ny, nz) site grid: box mean / broadcast transfers
    and a 7-point varying-stencil operator."""

    A: Callable            # cell-major flat operator apply
    Dinv: torch.Tensor     # (n_sites, b, b) inverted diagonal blocks
    cnt_inv: torch.Tensor  # (cz, cy, cx, 1) 1/|box|, boundary truncation included
    shape_xyz: tuple       # fine grid (nx, ny, nz)
    cshape_xyz: tuple      # coarse grid (cx, cy, cz)
    b: int
    A_fm: Callable | None = None  # field-major flat operator apply
    stencil: object | None = None  # a coarse level's VaryingStencilOperator (None: the fine level)


def _grid_smooth(L: _GridLevel, omega: float, r: torch.Tensor) -> torch.Tensor:
    z = torch.einsum("nij,nj->ni", L.Dinv, r.reshape(-1, L.b)).reshape(-1)
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


def _grid_restrict(L: _GridLevel, r: torch.Tensor) -> torch.Tensor:
    nx, ny, nz = L.shape_xyz
    cx, cy, cz = L.cshape_xyz
    s = _box_sum(r.reshape(nz, ny, nx, L.b), (nz, ny, nx), (cz, cy, cx), 0)
    return (s * L.cnt_inv).reshape(-1)


def _grid_prolong(L: _GridLevel, zc: torch.Tensor) -> torch.Tensor:
    nx, ny, nz = L.shape_xyz
    cx, cy, cz = L.cshape_xyz
    g = zc.reshape(cz, 1, cy, 1, cx, 1, L.b).expand(cz, 2, cy, 2, cx, 2, L.b)
    return g.reshape(2 * cz, 2 * cy, 2 * cx, L.b)[:nz, :ny, :nx].reshape(-1)


def _grid_smooth_fm(L: _GridLevel, omega: float, g: torch.Tensor) -> torch.Tensor:
    z = torch.einsum("nij,jn->in", L.Dinv, g.reshape(L.b, -1)).reshape(-1)
    return omega * z if omega != 1.0 else z


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


# the stages of a fused grid level on field-major flat vectors, L.stencil the
# level's operator (L.A_fm): kernel K5 on CUDA tensors (ops/vcycle_sweep.py),
# the plain versions below on the CPU; the smoothing's plain version is
# _grid_smooth_fm


def _restrict_plain(L: _GridLevel, r: torch.Tensor, z: torch.Tensor, cm: bool = False):
    """The next level's right-hand side cnt_inv·Σ_box (r − A z), cell-major
    (the dense bottom's order) when `cm`."""
    rc = _grid_restrict_fm(L, r - L.A_fm(z))
    return rc.reshape(L.b, -1).T.reshape(-1) if cm else rc


def _sweep_plain(L: _GridLevel, omega: float, r: torch.Tensor, z: torch.Tensor,
                 zc: torch.Tensor | None = None, zc_cm: bool = False) -> torch.Tensor:
    """z' = z + P zc (zc cell-major when `zc_cm`; none when zc is None), then
    z' + ω·Dinv·(r − A z')."""
    if zc is not None:
        z = z + _grid_prolong_fm(L, zc.reshape(-1, L.b).T.reshape(-1) if zc_cm else zc)
    return z + _grid_smooth_fm(L, omega, r - L.A_fm(z))


def _fused_smooth(L: _GridLevel, omega: float, r: torch.Tensor) -> torch.Tensor:
    if r.is_cuda:
        return vcycle_sweep.smooth_cuda(L.Dinv, r, omega)
    return _grid_smooth_fm(L, omega, r)


def _fused_restrict(L: _GridLevel, r: torch.Tensor, z: torch.Tensor, cm: bool = False):
    if r.is_cuda:
        return vcycle_sweep.restrict_cuda(L.stencil, L.cnt_inv, L.cshape_xyz, r, z, cm)
    return _restrict_plain(L, r, z, cm)


def _fused_sweep(L: _GridLevel, omega: float, r: torch.Tensor, z: torch.Tensor,
                 zc: torch.Tensor | None = None, zc_cm: bool = False) -> torch.Tensor:
    if r.is_cuda:
        return vcycle_sweep.sweep_cuda(L.stencil, L.Dinv, L.cshape_xyz, omega, r, z, zc, zc_cm)
    return _sweep_plain(L, omega, r, z, zc, zc_cm)


def _fusable(levels, l: int, dtype: torch.dtype, n_smooth) -> bool:
    """Level l runs as fused stages: a grid level below the fine one whose
    stencil K5 takes in `dtype`, a post-smoothing sweep to carry the
    prolongation, and a field-major operator on every level below it (the
    stages recurse field-major; a periodic grid_last level has none)."""
    L = levels[l]
    return (isinstance(L, _GridLevel) and L.stencil is not None and n_smooth[1] >= 1
            and vcycle_sweep.takes(L.stencil, dtype)
            and all(M.A_fm is not None for M in levels[l + 1:]))


def _vcycle_fused(levels, bot_inv, n_smooth, omega, l, r, bot_b):
    """One V-cycle from the fusable level l on a field-major r."""
    L = levels[l]
    # the dense bottom next: its right-hand side and answer stay cell-major
    cm = l + 1 == len(levels) and not callable(bot_inv)
    z = _fused_smooth(L, omega, r)
    for _ in range(n_smooth[0] - 1):
        z = _fused_sweep(L, omega, r, z)
    rc = _fused_restrict(L, r, z, cm)
    zc = bot_inv @ rc if cm else _vcycle(levels, bot_inv, n_smooth, omega, l + 1, rc, fm=True,
                                         bot_b=bot_b)
    z = _fused_sweep(L, omega, r, z, zc, cm)
    for _ in range(n_smooth[1] - 1):
        z = _fused_sweep(L, omega, r, z)
    return z


def _vcycle(levels, bot_inv, n_smooth, omega, l, r, fm=False, bot_b=1):
    """One V-cycle from level l. bot_inv: the dense bottom inverse, or a
    callable that takes the bottom level's place (parallel/vcycle_dist.py:
    the gather to the replicated levels)."""
    if l == len(levels):
        if callable(bot_inv):
            return bot_inv(r)
        if fm:
            x = bot_inv @ r.reshape(bot_b, -1).T.reshape(-1)
            return x.reshape(-1, bot_b).T.reshape(-1)
        return bot_inv @ r
    L = levels[l]
    if _fusable(levels, l, r.dtype, n_smooth):
        if r.is_cuda:
            STATS.vcycle_levels_fused += 1
        else:
            STATS.vcycle_levels_plain += 1
        if fm:
            return _vcycle_fused(levels, bot_inv, n_smooth, omega, l, r, bot_b)
        # cell-major: one relayout of the residual in, one of the correction out
        z = _vcycle_fused(levels, bot_inv, n_smooth, omega, l, r.reshape(-1, L.b).T.reshape(-1),
                          bot_b)
        return z.reshape(L.b, -1).T.reshape(-1)
    if l > 0:
        STATS.vcycle_levels_plain += 1
    if isinstance(L, _GridLevel):
        smooth, restrict, prolong = ((_grid_smooth_fm, _grid_restrict_fm, _grid_prolong_fm) if fm
                                     else (_grid_smooth, _grid_restrict, _grid_prolong))
    else:
        smooth, restrict, prolong = ((_smooth_fm, _restrict_fm, _prolong_fm) if fm
                                     else (_smooth, _restrict, _prolong))
    A = L.A_fm if fm else L.A
    step = functools.partial(_smooth_step_fm if fm else _smooth_step, smooth, L, omega)
    with _level_span(L, r.device):
        z = step(r)
        for _ in range(n_smooth[0] - 1):
            z = step(r, z, A(z))
        rc = restrict(L, r - A(z))
    # from level 0, every coarser level and the bottom solve: "port.pc.coarse"
    with (device_span("port.pc.coarse", r.device) if l == 0 else contextlib.nullcontext()):
        zc = _vcycle(levels, bot_inv, n_smooth, omega, l + 1, rc, fm=fm, bot_b=bot_b)
    with _level_span(L, r.device):
        z = z + prolong(L, zc)
        for _ in range(n_smooth[1]):
            z = step(r, z, A(z))
    return z


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
        # block size for the bottom level's field-major relayout, needed
        # when the whole mesh fits the bottom (zero levels)
        self.b = int(b) if b is not None else (levels[-1].b if levels else 1)

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
        return _vcycle(self.levels, self.bot_inv, self.n_smooth, self.omega, 0, r,
                       bot_b=self.b)

    __call__ = apply

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1


class GridVCyclePC(AggregationVCyclePC):
    """The geometric-Galerkin grid V-cycle; see the module docstring."""

    @classmethod
    @host_spanned("port.setup.pc")
    def from_grid_model(cls, D: BSRMatrix, shape_xyz, cells_per_site: int = 1,
                        A0_apply=None, A0_apply_fm=None, shift: float = 1.0,
                        bottom_max: int = 600, n_smooth=(1, 1), omega: float = 0.8,
                        dtype: torch.dtype | None = None):
        """Preconditioner of A = shift·I + D. A0_apply / A0_apply_fm: the
        production fine-level matvecs (cell-major flat / field-major flat);
        where either is None, both missing ones come from D's varying stencil
        (on a supercell mesh its dense (cps·b)² form, 8× the block-sparse
        one: pass the model's own to avoid it)."""
        import scipy.sparse as sp

        from circulantpreconditioner_tpu_torch.ops.stencil import VaryingStencilOperator

        device = D.blocks.device
        dtype = dtype or D.blocks.dtype
        b = D.block_size
        # the blocks in their working dtype, widened: the JAX package's
        # D.to_csr(dtype).to_scipy() without the round trip to the device
        A0 = (shift * sp.identity(D.shape[0], format="csr")
              + D.to_scipy().astype(np.float64)).tocsr()
        if A0_apply is None or A0_apply_fm is None:
            op0 = VaryingStencilOperator.from_bsr(D, shape_xyz, dtype=dtype,
                                                  cells_per_site=cells_per_site)
            if A0_apply is None:
                A0_apply = functools.partial(_shifted_apply, op0.matvec, shift)
            if A0_apply_fm is None and op0.layout == "flat":
                A0_apply_fm = functools.partial(_shifted_apply, op0.matvec_fm_flat, shift)

        levels = []
        A_l = A0
        cps = int(cells_per_site)
        if cps > 1:
            # level 0 → 1: the cps cells of each site, contiguous in the
            # hex-major numbering, so the transfers are reshapes (_Level)
            n0, n_sites = A0.shape[0] // b, int(np.prod(shape_xyz))
            levels.append(_Level(A=A0_apply, Dinv=_block_diag_inv(A_l, b, device, dtype),
                                 cnt_inv=torch.full((n_sites,), 1.0 / cps, device=device,
                                                    dtype=dtype),
                                 n=n0, b=b, factor=cps, n_agg=n_sites, A_fm=A0_apply_fm,
                                 span="port.pc.site"))
            A_l = _galerkin_chunk(A_l, b, n0, cps, n_sites)
        shape = tuple(int(v) for v in shape_xyz)
        first = cps == 1
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
            if first:
                # the first grid level is the fine level: the production operators
                A_cm, A_fm = A0_apply, A0_apply_fm
            else:
                op_l = _varying_from_scipy(A_l, b, shape, device, dtype)
                A_cm = op_l.matvec
                A_fm = op_l.matvec_fm_flat if op_l.layout == "flat" else None
            levels.append(_GridLevel(A=A_cm, Dinv=_block_diag_inv(A_l, b, device, dtype),
                                     cnt_inv=cnt_inv, shape_xyz=shape, cshape_xyz=cshape,
                                     b=b, A_fm=A_fm, stencil=None if first else op_l))
            A_l = _galerkin_map(A_l, b, site, n_c)
            shape = cshape
            first = False

        bot_inv = torch.as_tensor(np.linalg.inv(A_l.toarray())).to(device=device, dtype=dtype)
        return cls(levels, bot_inv, n_smooth=n_smooth, omega=omega, b=b)

    def apply_fm(self, g: torch.Tensor) -> torch.Tensor:
        """Field-major flat apply (g.reshape(b, n) is the field view, or, on a
        supercell fine level, g.reshape(cps·b, n_sites)), with no relayout
        above the bottom level. Raises when a level has no field-major
        operator (a grid_last, i.e. periodic, level)."""
        missing = [l for l, L in enumerate(self.levels) if L.A_fm is None]
        if missing:
            raise ValueError(f"GridVCyclePC.apply_fm: levels {missing} have no field-major "
                             "operator (periodic grid_last stencils); use apply")
        return _vcycle(self.levels, self.bot_inv, self.n_smooth, self.omega, 0, g, fm=True,
                       bot_b=self.b)


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
