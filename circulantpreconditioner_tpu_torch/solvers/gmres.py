"""Matrix-free restarted GMRES (PyTorch counterpart of
circulantpreconditioner_tpu/solvers/gmres.py).

Same arithmetic as the JAX solver: PETSc's defaults (restart m = 30, LEFT
preconditioning, convergence when ‖r‖ < max(rtol·‖b_pre‖, atol), divergence
when ‖r‖ > divtol·‖b_pre‖), classical Gram-Schmidt run twice (CGS2), and the
Givens rotations composed into an explicit (m+1)×(m+1) matrix Q so that
applying all previous rotations to a new Hessenberg column is one matvec.
side="right" solves A M⁻¹ y = b, x = M⁻¹ y, and converges on the TRUE
residual.

The iteration runs on the host. The Krylov basis V (m+1, n), the operator,
the preconditioner and the projections stay on the vectors' device; after the
projections each iteration copies the (j+2)-long Hessenberg column to the host
(its one synchronisation), where the Givens update, the residual estimate and
the stopping tests run in NumPy in the vectors' dtype. Only the "flat" basis
is ported: the JAX solver's "lane" layout folds vectors onto the TPU's
128-lane axis. The projections use the active rows V[:j+1] only; the JAX
solver's rows beyond j are zero, so the results agree.

On row-sharded vectors (parallel/), each rank holds its block of b, x and
the basis, and `allreduce` sums a tensor over the ranks: the norms and the
CGS2 projections are then the global ones (the JAX package's psums under
shard_map), and every rank takes the same Givens updates and stopping
decisions. None (the default) is the one-device solver.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg
import torch


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int  # total inner iterations (matvec count)
    resnorm: float  # final residual norm (preconditioned for side="left")
    converged: bool  # tolerance met (PETSc reason > 0 analog)


def _identity(r):
    return r


def _combine(c: torch.Tensor, Vj: torch.Tensor) -> torch.Tensor:
    """Σ_i c_i V_i. One row is a scaled copy: cuBLAS runs a one-row product
    as a GEMM that takes 49 µs at n = 10⁶ on an H100, against 12 µs for two
    rows."""
    return c * Vj[0] if Vj.shape[0] == 1 else Vj.T @ c


def make_gmres(
    A: Callable[[torch.Tensor], torch.Tensor],
    M: Callable[[torch.Tensor], torch.Tensor] | None = None,
    *,
    restart: int = 30,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    maxiter: int = 1000,
    divtol: float = 1e4,
    side: str = "left",
    allreduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> Callable[..., KrylovResult]:
    """GMRES for a fixed operator/preconditioner pair: solve(b, x0=None).
    allreduce: sums a tensor over the ranks of a row-sharded solve."""
    if M is None:
        M = _identity
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    right = side == "right"

    def solve(b: torch.Tensor, x0: torch.Tensor | None = None) -> KrylovResult:
        return _gmres_body(A, M, b, x0, m=int(restart), rtol=rtol, atol=atol,
                           maxiter=maxiter, divtol=divtol, right=right, allreduce=allreduce)

    return solve


def _gmres_body(A, M, b, x0, *, m, rtol, atol, maxiter, divtol, right,
                allreduce=None) -> KrylovResult:
    n = b.shape[0]
    dtype = b.dtype
    npdt = np.float64 if dtype == torch.float64 else np.float32
    eps = npdt(np.finfo(npdt).tiny)
    x = torch.zeros_like(b) if x0 is None else x0
    if allreduce is None:
        vnorm = torch.linalg.norm
        project = lambda Vj, w: Vj @ w  # noqa: E731
    else:
        vnorm = lambda v: torch.sqrt(allreduce(torch.dot(v, v).reshape(1)))[0]  # noqa: E731
        project = lambda Vj, w: allreduce(Vj @ w)  # noqa: E731
    norm = lambda v: npdt(vnorm(v).item())

    b_pre = b if right else M(b)
    bnorm = norm(b_pre)
    tol = max(npdt(rtol) * bnorm, npdt(atol))
    dtol = npdt(divtol) * max(bnorm, eps)

    def precond_op(v):
        return A(M(v)) if right else M(A(v))

    def arnoldi_cycle(x, total_it):
        """One restart cycle; returns (x_new, res, iters_done, diverged)."""
        r = (b - A(x)) if right else M(b - A(x))
        beta = norm(r)
        V = torch.empty((m + 1, n), dtype=dtype, device=b.device)
        V[0] = r / max(beta, eps)
        H = np.zeros((m + 1, m), dtype=npdt)
        Q = np.eye(m + 1, dtype=npdt)
        j = 0
        res = beta
        while j < m and res >= tol and res <= dtol and total_it + j < maxiter:
            w = precond_op(V[j])
            Vj = V[: j + 1]
            h = project(Vj, w)  # classical Gram-Schmidt, twice
            w = w - _combine(h, Vj)
            h2 = project(Vj, w)
            w = w - _combine(h2, Vj)
            wnorm = vnorm(w)
            V[j + 1] = w / torch.clamp(wnorm, min=float(eps))
            hw = torch.cat([h + h2, wnorm.reshape(1)]).cpu().numpy().astype(npdt)
            hfull = np.zeros(m + 1, dtype=npdt)
            hfull[: j + 2] = hw

            hcol = Q @ hfull  # all previous rotations at once
            denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            if denom > eps:
                c = hcol[j] / max(denom, eps)
                s = hcol[j + 1] / max(denom, eps)
            else:
                c, s = npdt(1.0), npdt(0.0)
            qj, qj1 = Q[j].copy(), Q[j + 1].copy()
            Q[j] = c * qj + s * qj1
            Q[j + 1] = -s * qj + c * qj1
            hcol[j] = denom
            hcol[j + 1] = 0.0
            H[:, j] = hcol
            res = beta * np.abs(Q[j + 1, 0])  # |g[j+1]|, g = β·Q[:,0]
            j += 1
        g = beta * Q[:, 0]

        # Solve R y = g on the active j×j block; inactive columns get a unit
        # diagonal and zero right-hand side, so y there is 0.
        diag_ok = np.arange(m) < j
        R = H[:m, :]
        R = np.where(np.eye(m, dtype=bool) & ~diag_ok[None, :], npdt(1.0), R)
        R = R + np.diag(np.where(np.abs(np.diag(R)) < eps, eps, npdt(0.0)))
        gm = np.where(diag_ok, g[:m], npdt(0.0))
        y = scipy.linalg.solve_triangular(R, gm, lower=False)
        corr = _combine(torch.as_tensor(y[:j], dtype=dtype, device=b.device), V[:j])
        x_new = x + (M(corr) if right else corr)
        return x_new, res, j, res > dtol

    r0 = (b - A(x)) if right else M(b - A(x))
    res = norm(r0)
    it = 0
    diverged = False
    while res >= tol and it < maxiter and not diverged:
        x, res, j, diverged = arnoldi_cycle(x, it)
        it += j
    return KrylovResult(x, int(it), float(res), bool(res < tol and not diverged))


def gmres(A, b, x0=None, *, M=None, restart: int = 30, rtol: float = 1e-5,
          atol: float = 1e-5, maxiter: int = 1000, side: str = "left",
          allreduce=None) -> KrylovResult:
    """One-shot convenience wrapper around make_gmres."""
    return make_gmres(A, M, restart=restart, rtol=rtol, atol=atol, maxiter=maxiter,
                      side=side, allreduce=allreduce)(b, x0)
