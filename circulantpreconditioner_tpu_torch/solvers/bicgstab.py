"""Preconditioned BiCGStab for nonsymmetric operators (PyTorch counterpart of
circulantpreconditioner_tpu/solvers/bicgstab.py, PETSc's KSPBCGS).

Right preconditioning; convergence on the true residual,
‖r‖ < max(rtol·‖b‖, atol); every denominator below finfo.tiny in magnitude
is replaced by it, as in the JAX solver. The solve is device-resident, as
the JAX solver's jit + lax.while_loop is: the vectors, the scalars of the
recurrence, the iteration count and the loop's `active` flag are device
tensors, an iteration is one step function (one CUDA graph on the card)
whose updates are masked by `active`, and the host reads the flags
LOOKAHEAD iterations behind the device (solvers/cg.py, solvers/gmres.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from circulantpreconditioner_tpu_torch.solvers.cg import _ShortRecurrence
from circulantpreconditioner_tpu_torch.solvers.gmres import KrylovResult
from circulantpreconditioner_tpu_torch.utils.graphs import masked_update


class BiCGStab(_ShortRecurrence):
    _vectors = ("r", "r0", "v", "p")
    _scalars = ("rho", "alpha", "omega")

    def _guard(self, v: torch.Tensor) -> torch.Tensor:
        return torch.where(torch.abs(v) > self.eps, v, self.eps)

    def _init(self) -> None:
        self.tol.copy_(torch.clamp(torch.linalg.norm(self.b) * self.rtol, min=self.atol))
        r = self.b - self.A(self.x)
        self.r.copy_(r)
        self.r0.copy_(r)
        for name in ("rho", "alpha", "omega"):
            getattr(self, name).fill_(1.0)
        self.v.zero_()
        self.p.zero_()
        self.res.copy_(torch.linalg.norm(r))
        self.it.zero_()
        self._post_flags(torch.ones((), dtype=torch.bool, device=r.device))

    def _iterate(self) -> None:
        act = self.active.clone()
        r, r0, eps = self.r, self.r0, self.eps
        rho_new = torch.dot(r0, r)
        beta = (rho_new / self._guard(self.rho)) * (self.alpha / self._guard(self.omega))
        p = r + beta * (self.p - self.omega * self.v)
        phat = self.M(p)
        v = self.A(phat)
        alpha = rho_new / self._guard(torch.dot(r0, v))
        s = r - alpha * v
        shat = self.M(s)
        t = self.A(shat)
        tt = torch.dot(t, t)
        omega = torch.dot(t, s) / torch.where(tt > eps, tt, eps)
        r_new = s - omega * t
        masked_update(act, (self.x, self.x + alpha * phat + omega * shat), (self.r, r_new),
                      (self.v, v), (self.p, p), (self.rho, rho_new), (self.alpha, alpha),
                      (self.omega, omega), (self.res, torch.linalg.norm(r_new)),
                      (self.it, self.it + 1))
        self._post_flags(act)


def make_bicgstab(
    A: Callable[[torch.Tensor], torch.Tensor],
    M: Callable[[torch.Tensor], torch.Tensor] | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    maxiter: int = 1000,
) -> BiCGStab:
    """BiCGStab for a fixed operator/preconditioner pair: solve(b, x0=None)."""
    return BiCGStab(A, M, rtol=rtol, atol=atol, maxiter=maxiter)


def bicgstab(A, b, x0=None, *, M=None, rtol: float = 1e-5, atol: float = 1e-5,
             maxiter: int = 1000) -> KrylovResult:
    """One-shot convenience wrapper around make_bicgstab."""
    return make_bicgstab(A, M, rtol=rtol, atol=atol, maxiter=maxiter)(b, x0)
