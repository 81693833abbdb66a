"""Preconditioners M⁻¹ as plain callables (PyTorch counterpart of
circulantpreconditioner_tpu/solvers/preconditioners.py): Jacobi, point-block
Jacobi, the additive and multiplicative composites, ILU(0) and block-Jacobi
ILU(0).

ILU(0) is factored on the host in float64 and applied on the vectors' device
by level-scheduled triangular solves: the rows of one level do not depend on
one another, so each level is one gather-multiply-sum and one indexed write.
There is no hand-written kernel there; the JAX package applies it by gathers
too (no Pallas kernel). The field-major point-block Jacobi (`pbjacobi_fm`)
runs as kernel K6 on the card (ops/block_jacobi.py), and so does the
multiplicative composite's z + Ms(r − A z) when Ms is one."""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops import block_jacobi
from circulantpreconditioner_tpu_torch.ops.csr import BSRMatrix, CSRMatrix
from circulantpreconditioner_tpu_torch.solvers.gmres import _identity
from circulantpreconditioner_tpu_torch.utils.profiling import device_span


def identity() -> Callable[[torch.Tensor], torch.Tensor]:
    """M⁻¹ = I, the solvers' default when no preconditioner is given."""
    return _identity


def _diag_apply(dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return dinv * r


def jacobi(A: CSRMatrix):
    """Diagonal scaling M⁻¹ = diag(A)⁻¹ (rows with a zero diagonal keep 1)."""
    d = A.diagonal()
    dinv = torch.where(torch.abs(d) > 0, 1.0 / d, 1.0)
    return functools.partial(_diag_apply, dinv)


def _block_diag_apply(Dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.einsum("nij,nj->ni", Dinv, r.reshape(-1, Dinv.shape[-1])).reshape(-1)


def _inverted_diagonal_blocks(A: BSRMatrix, shift: float) -> np.ndarray:
    D = A.block_diagonal().cpu().numpy()  # (n_brows, b, b)
    if shift:
        D = D + shift * np.eye(A.block_size)[None, :, :]
    return np.linalg.inv(D)


def pbjacobi(A: BSRMatrix, shift: float = 0.0):
    """Point-block Jacobi (PETSc PCPBJACOBI): the (b×b) diagonal blocks are
    inverted once on the host; the apply is a batched small matvec.
    shift=1.0 preconditions I + A (the implicit FV systems)."""
    Dinv = _inverted_diagonal_blocks(A, shift)
    return functools.partial(_block_diag_apply, torch.as_tensor(Dinv).to(
        device=A.blocks.device, dtype=A.blocks.dtype))


def _block_diag_apply_fm(DinvT: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ijn,jn->in", DinvT, r.reshape(DinvT.shape[0], -1)).reshape(-1)


def _site_block_diag_apply_fm(DinvT: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    g, b = DinvT.shape[0], DinvT.shape[1]
    return torch.einsum("kijn,kjn->kin", DinvT, r.reshape(g, b, -1)).reshape(-1)


class PointBlockJacobiFM:
    """`pbjacobi_fm`'s apply M⁻¹ r, and `fused(r, z, y)` = z + M⁻¹ (r − y):
    one K6 launch each on the card, the einsum on the CPU."""

    def __init__(self, DinvT: torch.Tensor, g: int):
        self.DinvT, self.g = DinvT, g
        self._plain = functools.partial(
            _block_diag_apply_fm if g == 1 else _site_block_diag_apply_fm, DinvT)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.fused(r)

    def fused(self, r: torch.Tensor, z: torch.Tensor | None = None,
              y: torch.Tensor | None = None) -> torch.Tensor:
        return block_jacobi.run(self._plain, self.DinvT, "field", self.g, 1.0, r, z, y)


def pbjacobi_fm(A: BSRMatrix, shift: float = 0.0, cells_per_site: int = 1) -> PointBlockJacobiFM:
    """pbjacobi for field-major flat vectors. With one cell a site
    x.reshape(b, n) is the field view and the inverted blocks are stored
    (b, b, n). On a supercell mesh (cells_per_site = g > 1, cell g·s + k the
    k-th cell of site s) the view is x.reshape(g·b, n_sites), cell g·s + k
    owning rows k·b … k·b + b−1 of column s, and the blocks are stored
    (g, b, b, n_sites)."""
    Dinv = _inverted_diagonal_blocks(A, shift)  # (n, b, b)
    g = int(cells_per_site)
    if g == 1:
        DinvT = Dinv.transpose(1, 2, 0)
    else:
        n, b = Dinv.shape[0], Dinv.shape[1]
        DinvT = Dinv.reshape(n // g, g, b, b).transpose(1, 2, 3, 0)
    return PointBlockJacobiFM(torch.as_tensor(np.ascontiguousarray(DinvT)).to(
        device=A.blocks.device, dtype=A.blocks.dtype), g)


def _cell_major_adapter_apply(apply_cm, m: int, r: torch.Tensor) -> torch.Tensor:
    z = apply_cm(r.reshape(m, -1).T.reshape(-1))
    return z.reshape(-1, m).T.reshape(-1)


def cell_major_adapter(apply_cm: Callable, m: int):
    """Wrap a cell-major preconditioner for field-major flat vectors whose
    field view is (m, N): one (N,m)↔(m,N) relayout pair per apply. m is the
    model's fm_block (dim+1, or cells_per_site·(dim+1) on a supercell mesh,
    whose cell-major order is site-major)."""
    return functools.partial(_cell_major_adapter_apply, apply_cm, int(m))


def _additive_apply(appliers, r):
    out = appliers[0](r)
    for M in appliers[1:]:
        out = out + M(r)
    return out


def additive(*appliers: Callable):
    """Additive combination M⁻¹ = Σ Mᵢ⁻¹ (PETSc PCCOMPOSITE ADDITIVE)."""
    return functools.partial(_additive_apply, tuple(appliers))


def _multiplicative_apply(A, coarse, smoother, r):
    with device_span("port.pc.coarse", r.device):
        z = coarse(r)
    fused = getattr(smoother, "fused", None)
    if fused is not None:
        return fused(r, z, A(z))
    return z + smoother(r - A(z))


def multiplicative(A: Callable, coarse: Callable, smoother: Callable):
    """Multiplicative two-level cycle z = Mc r; z += Ms (r − A z) (PETSc
    PCCOMPOSITE MULTIPLICATIVE). A smoother with a `fused(r, z, y)` method
    (`pbjacobi_fm`'s) computes z + Ms (r − y) itself, y = A z."""
    return functools.partial(_multiplicative_apply, A, coarse, smoother)


# ---------------------------------------------------------------------------
# ILU(0)
# ---------------------------------------------------------------------------


def _diagonal_positions(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Position of each row's diagonal entry; raises on the first row
    without one."""
    n = len(indptr) - 1
    rown = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    on_diag = indices == rown
    has = np.zeros(n, dtype=bool)
    has[rown[on_diag]] = True
    if not has.all():
        raise ValueError(f"ILU(0): missing diagonal in row {int(np.argmin(has))}")
    diag_pos = np.empty(n, dtype=np.int64)
    diag_pos[rown[on_diag]] = np.nonzero(on_diag)[0]
    return diag_pos


def _level_of_rows(indptr: np.ndarray, indices: np.ndarray, strict_lower: bool,
                   n: int) -> np.ndarray:
    """Level of each row in a triangular solve: 0 for a row with no
    dependency in the strict triangle, else 1 + the largest level of the
    rows it depends on (the longest dependency path, found front by front)."""
    rown = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dep = (indices < rown) if strict_lower else (indices > rown)
    row, on = rown[dep], indices[dep]  # row depends on the row `on`
    indeg = np.bincount(row, minlength=n)
    order = np.argsort(on, kind="stable")
    dependents = row[order]
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(on, minlength=n), out=starts[1:])
    level = np.zeros(n, dtype=np.int64)
    front = np.nonzero(indeg == 0)[0]
    lev = 0
    while len(front):
        level[front] = lev
        cnt = starts[front + 1] - starts[front]
        total = int(cnt.sum())
        if not total:
            break
        offs = np.cumsum(cnt) - cnt
        nxt = dependents[np.arange(total) - np.repeat(offs, cnt) + np.repeat(starts[front], cnt)]
        indeg -= np.bincount(nxt, minlength=n)
        cand = np.unique(nxt)
        front = cand[indeg[cand] == 0]
        lev += 1
    return level


def _level_schedule(indptr, indices, strict_lower: bool, n: int) -> list[np.ndarray]:
    """Level sets of a triangular solve, in dependency order; rows ascending
    within a level. The JAX package's `_level_schedule` row by row, computed
    front by front (the same levels)."""
    level = _level_of_rows(np.asarray(indptr, dtype=np.int64),
                           np.asarray(indices, dtype=np.int64), strict_lower, n)
    nlev = int(level.max()) + 1 if n else 0
    order = np.argsort(level, kind="stable")
    bounds = np.searchsorted(level[order], np.arange(nlev + 1))
    return [order[bounds[l]:bounds[l + 1]] for l in range(nlev)]


def _ilu0_factor_host(indptr, indices, data, lower_levels=None):
    """ILU(0), IKJ variant, on the host: returns (f, diag_pos), f holding L
    (unit diagonal implied) in the strict lower entries and U in the others.
    Column indices must be sorted within each row.

    The same arithmetic as the JAX package's `_ilu0_factor_host`, entry for
    entry and in the same order (the results are equal bit for bit), run a
    level of the lower schedule at a time: the rows of a level depend only on
    rows of earlier levels, so the t-th lower entry of every row of the level
    is eliminated at once. A zero pivot is replaced by finfo.tiny."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    n = len(indptr) - 1
    data = np.array(data, copy=True)
    diag_pos = _diagonal_positions(indptr, indices)
    if lower_levels is None:
        lower_levels = _level_schedule(indptr, indices, True, n)
    nnz = len(indices)
    rown = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keys = rown * n + indices  # sorted: rows ascending, columns sorted in each row
    n_lower = diag_pos - indptr[:-1]
    tiny = np.finfo(data.dtype).tiny
    for rows in lower_levels:
        for t in range(int(n_lower[rows].max()) if len(rows) else 0):
            sel = rows[n_lower[rows] > t]
            kk = indptr[sel] + t
            k = indices[kk]
            piv = data[diag_pos[k]]
            piv = np.where(piv == 0.0, tiny, piv)
            lik = data[kk] / piv
            data[kk] = lik
            # subtract lik · U[k, j] wherever row i's pattern holds j > k
            start = diag_pos[k] + 1
            cnt = indptr[k + 1] - start
            total = int(cnt.sum())
            if not total:
                continue
            offs = np.cumsum(cnt) - cnt
            pk = np.arange(total) - np.repeat(offs, cnt) + np.repeat(start, cnt)
            key = np.repeat(sel, cnt) * n + indices[pk]
            pos = np.minimum(np.searchsorted(keys, key), nnz - 1)
            hit = keys[pos] == key
            data[pos[hit]] -= np.repeat(lik, cnt)[hit] * data[pk[hit]]
    return data, diag_pos


class ILU0Preconditioner:
    """ILU(0) of a CSRMatrix, x = U⁻¹ L⁻¹ r by level-scheduled triangular
    solves on the matrix's device.

    The factor is computed once on the host in float64. Each strict triangle
    is packed ELL-style per level, as (rows, cols, vals) tables of width the
    level's largest row degree, and uploaded once as one concatenated tensor
    per array; the levels are views into it. `schedule` is kept for call-site
    parity with the JAX package, whose "unrolled" and "scan" schedules differ
    only in how XLA traces the same per-level updates: "auto", "unrolled" and
    "scan" all run the one per-level apply here."""

    def __init__(self, A: CSRMatrix, schedule: str = "auto"):
        if schedule not in ("auto", "unrolled", "scan"):
            raise ValueError(f"schedule must be auto|unrolled|scan, got {schedule}")
        indptr = A.indptr.cpu().numpy()
        indices = A.indices.cpu().numpy()
        data = A.data.cpu().numpy().astype(np.float64)
        n = A.shape[0]
        dtype, device = A.data.dtype, A.data.device
        lower_rows = _level_schedule(indptr, indices, True, n)
        upper_rows = _level_schedule(indptr, indices, False, n)
        f, diag_pos = _ilu0_factor_host(indptr, indices, data, lower_rows)
        rown = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        dinv = 1.0 / f[diag_pos]

        def build_tri(strict_lower: bool, rows_levels, scale):
            # the global ELL pack of the strict triangle, then each level's rows
            mask = (indices < rown) if strict_lower else (indices > rown)
            sel_rows = rown[mask]
            deg = np.bincount(sel_rows, minlength=n).astype(np.int64)
            Kg = max(int(deg.max()) if n else 0, 1)
            offs = np.zeros(n, dtype=np.int64)
            np.cumsum(deg[:-1], out=offs[1:])
            pos = np.arange(len(sel_rows), dtype=np.int64) - offs[sel_rows]
            cols_g = np.zeros((n, Kg), dtype=np.int64)
            vals_g = np.zeros((n, Kg), dtype=np.float64)
            cols_g[sel_rows, pos] = indices[mask]
            vals_g[sel_rows, pos] = f[mask]
            widths = [max(int(deg[r].max()) if len(r) else 0, 1) for r in rows_levels]
            cat = lambda parts: np.concatenate(parts) if parts else np.zeros(0)  # noqa: E731
            # one upload per array; each level is a view into it
            rows_t = torch.as_tensor(cat(rows_levels).astype(np.int64), device=device)
            cols_t = torch.as_tensor(cat([cols_g[r, :k].reshape(-1)
                                          for r, k in zip(rows_levels, widths)]).astype(np.int64),
                                     device=device)
            as_dev = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)  # noqa: E731
            vals_t = as_dev(cat([vals_g[r, :k].reshape(-1) for r, k in zip(rows_levels, widths)]))
            scale_t = as_dev(cat([scale[r] for r in rows_levels])) if scale is not None else None
            levels, ro, fo = [], 0, 0
            for r, k in zip(rows_levels, widths):
                m = len(r)
                levels.append((rows_t[ro:ro + m], cols_t[fo:fo + m * k].view(m, k),
                               vals_t[fo:fo + m * k].view(m, k),
                               scale_t[ro:ro + m] if scale is not None else None))
                ro, fo = ro + m, fo + m * k
            return tuple(levels)

        self._lower = build_tri(True, lower_rows, None)
        self._upper = build_tri(False, upper_rows, dinv)  # dinv[rows] per level
        self.n_levels = (len(self._lower), len(self._upper))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """x = U⁻¹ L⁻¹ r (unit-diagonal L)."""
        return _ilu_apply(self._lower, self._upper, r)

    __call__ = apply


def _ilu_apply(lower_levels, upper_levels, r: torch.Tensor) -> torch.Tensor:
    """The JAX package's `_ilu_apply`: for each lower level
    y[rows] = r[rows] − Σ_k vals·y[cols], then for each upper level, in the
    order built, x[rows] = (y[rows] − Σ_k vals·x[cols])·dinv[rows]."""
    y = r.clone()
    for rows, cols, vals, _ in lower_levels:
        acc = (vals * y[cols]).sum(dim=1)
        y[rows] = r[rows] - acc
    x = y.clone()
    for rows, cols, vals, dinv in upper_levels:
        acc = (vals * x[cols]).sum(dim=1)
        x[rows] = (y[rows] - acc) * dinv
    return x


def ilu0(A: CSRMatrix, schedule: str = "auto") -> ILU0Preconditioner:
    return ILU0Preconditioner(A, schedule=schedule)


def _block_jacobi_apply(subs, r: torch.Tensor) -> torch.Tensor:
    return torch.cat([pc.apply(r[s:e]) for s, e, pc in subs])


def block_jacobi_ilu0(A: CSRMatrix, n_blocks: int):
    """PETSc PCBJACOBI analog: rows split into `n_blocks` contiguous chunks,
    ILU(0) of each diagonal block, applied independently (the couplings
    between blocks are dropped, as in the reference's MPI BJACOBI with
    np = n_blocks)."""
    n = A.shape[0]
    bounds = np.linspace(0, n, n_blocks + 1).astype(np.int64)
    Asp = A.to_scipy()
    subs = []
    for k in range(n_blocks):
        s, e = int(bounds[k]), int(bounds[k + 1])
        sub = CSRMatrix.from_scipy(Asp[s:e, s:e].tocsr(), device=A.data.device,
                                   dtype=A.data.dtype)
        subs.append((s, e, ILU0Preconditioner(sub)))
    return functools.partial(_block_jacobi_apply, tuple(subs))
