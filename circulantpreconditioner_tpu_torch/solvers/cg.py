"""Preconditioned conjugate gradient for SPD operators (PyTorch counterpart of
circulantpreconditioner_tpu/solvers/cg.py, PETSc's KSPCG).

Convergence as in the JAX solver: ‖z‖ = ‖M r‖ < max(rtol·‖M b‖, atol), with
finfo.tiny guarding both denominators. The iteration runs on the host; the
vectors and the scalars of the recurrence stay on the vectors' device, and
each iteration copies the residual norm to the host for the stopping test
(its one synchronisation).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.solvers.gmres import KrylovResult, _identity


def make_cg(
    A: Callable[[torch.Tensor], torch.Tensor],
    M: Callable[[torch.Tensor], torch.Tensor] | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    maxiter: int = 1000,
) -> Callable[..., KrylovResult]:
    """CG for a fixed operator/preconditioner pair: solve(b, x0=None)."""
    if M is None:
        M = _identity

    def solve(b: torch.Tensor, x0: torch.Tensor | None = None) -> KrylovResult:
        x = torch.zeros_like(b) if x0 is None else x0
        eps = float(torch.finfo(b.dtype).tiny)
        npdt = np.float64 if b.dtype == torch.float64 else np.float32
        bnorm = npdt(torch.linalg.norm(M(b)).item())
        tol = max(npdt(rtol) * bnorm, npdt(atol))

        r = b - A(x)
        z = M(r)
        p = z
        rz = torch.dot(r, z)
        res = npdt(torch.linalg.norm(z).item())
        it = 0
        while res >= tol and it < maxiter:
            Ap = A(p)
            alpha = rz / torch.clamp(torch.dot(p, Ap), min=eps)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = torch.dot(r, z)
            beta = rz_new / torch.clamp(rz, min=eps)
            p = z + beta * p
            rz = rz_new
            res = npdt(torch.linalg.norm(z).item())
            it += 1
        return KrylovResult(x, it, float(res), bool(res < tol))

    return solve


def cg(A, b, x0=None, *, M=None, rtol: float = 1e-5, atol: float = 1e-5,
       maxiter: int = 1000) -> KrylovResult:
    """One-shot convenience wrapper around make_cg."""
    return make_cg(A, M, rtol=rtol, atol=atol, maxiter=maxiter)(b, x0)
