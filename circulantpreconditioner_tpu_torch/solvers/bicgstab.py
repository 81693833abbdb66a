"""Preconditioned BiCGStab for nonsymmetric operators (PyTorch counterpart of
circulantpreconditioner_tpu/solvers/bicgstab.py, PETSc's KSPBCGS).

Right preconditioning; convergence on the true residual,
‖r‖ < max(rtol·‖b‖, atol); every denominator below finfo.tiny in magnitude
is replaced by it, as in the JAX solver. The iteration runs on the host; the
vectors and the scalars of the recurrence stay on the vectors' device, and
each iteration copies the residual norm to the host for the stopping test
(its one synchronisation).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.solvers.gmres import KrylovResult, _identity


def make_bicgstab(
    A: Callable[[torch.Tensor], torch.Tensor],
    M: Callable[[torch.Tensor], torch.Tensor] | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    maxiter: int = 1000,
) -> Callable[..., KrylovResult]:
    """BiCGStab for a fixed operator/preconditioner pair: solve(b, x0=None)."""
    if M is None:
        M = _identity

    def solve(b: torch.Tensor, x0: torch.Tensor | None = None) -> KrylovResult:
        x = torch.zeros_like(b) if x0 is None else x0
        eps = torch.tensor(torch.finfo(b.dtype).tiny, dtype=b.dtype, device=b.device)
        guard = lambda v: torch.where(torch.abs(v) > eps, v, eps)  # noqa: E731
        npdt = np.float64 if b.dtype == torch.float64 else np.float32
        tol = max(npdt(rtol) * npdt(torch.linalg.norm(b).item()), npdt(atol))

        r = b - A(x)
        r0 = r
        one = torch.ones((), dtype=b.dtype, device=b.device)
        rho, alpha, omega = one, one, one
        v = torch.zeros_like(b)
        p = torch.zeros_like(b)
        res = npdt(torch.linalg.norm(r).item())
        it = 0
        while res >= tol and it < maxiter:
            rho_new = torch.dot(r0, r)
            beta = (rho_new / guard(rho)) * (alpha / guard(omega))
            p = r + beta * (p - omega * v)
            phat = M(p)
            v = A(phat)
            alpha = rho_new / guard(torch.dot(r0, v))
            s = r - alpha * v
            shat = M(s)
            t = A(shat)
            tt = torch.dot(t, t)
            omega = torch.dot(t, s) / torch.where(tt > eps, tt, eps)
            x = x + alpha * phat + omega * shat
            r = s - omega * t
            rho = rho_new
            res = npdt(torch.linalg.norm(r).item())
            it += 1
        return KrylovResult(x, it, float(res), bool(res < tol))

    return solve


def bicgstab(A, b, x0=None, *, M=None, rtol: float = 1e-5, atol: float = 1e-5,
             maxiter: int = 1000) -> KrylovResult:
    """One-shot convenience wrapper around make_bicgstab."""
    return make_bicgstab(A, M, rtol=rtol, atol=atol, maxiter=maxiter)(b, x0)
