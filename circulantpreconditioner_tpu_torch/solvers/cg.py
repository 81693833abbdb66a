"""Preconditioned conjugate gradient for SPD operators (PyTorch counterpart of
circulantpreconditioner_tpu/solvers/cg.py, PETSc's KSPCG).

Convergence as in the JAX solver: ‖z‖ = ‖M r‖ < max(rtol·‖M b‖, atol), with
finfo.tiny guarding both denominators. The solve is device-resident, as the
JAX solver's jit + lax.while_loop is: x, r, p, r·z, ‖z‖, the iteration count
and the loop's `active` flag are device tensors of the solver, an iteration is
one step function (one CUDA graph on the card, utils/graphs.py) whose updates
are masked by `active`, and the host reads the flags LOOKAHEAD iterations
behind the device (solvers/gmres.py::run_loop).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from circulantpreconditioner_tpu_torch.solvers.gmres import (
    BELOW,
    LOOKAHEAD,
    RES,
    KrylovResult,
    _identity,
    run_loop,
)
from circulantpreconditioner_tpu_torch.utils.graphs import STATS, FlagRing, GraphSet, masked_update

IT = 3  # a flag row: act_in, active, res, it, res < tol


def flag_row(out, act_in, active, res, it, tol) -> None:
    torch.stack([act_in.double(), active.double(), res.double(), it.double(),
                 (res < tol).double()], out=out)


class _ShortRecurrence:
    """The host loop and buffers shared by CG and BiCGStab: `_vectors` names
    the n-vectors of the state and `_scalars` its scalars; `_init` and
    `_iterate` are the step functions."""

    _vectors: tuple[str, ...] = ()
    _scalars: tuple[str, ...] = ()

    def __init__(self, A, M=None, *, rtol: float = 1e-5, atol: float = 1e-5,
                 maxiter: int = 1000):
        self.A, self.M = A, (M if M is not None else _identity)
        self.rtol, self.atol, self.maxiter = rtol, atol, int(maxiter)
        self._lookahead = LOOKAHEAD
        self._key = None

    def _setup(self, b: torch.Tensor) -> None:
        key = (b.shape[0], b.dtype, b.device)
        if key == self._key:
            return
        zeros = functools.partial(torch.zeros, dtype=b.dtype, device=b.device)
        for name in ("b", "x") + self._vectors:
            setattr(self, name, zeros(b.shape[0]))
        for name in ("res", "tol") + self._scalars:
            setattr(self, name, zeros(()))
        self.it = torch.zeros((), dtype=torch.int64, device=b.device)
        self.active = torch.zeros((), dtype=torch.bool, device=b.device)
        self.eps = float(torch.finfo(b.dtype).tiny)
        self.graphs = GraphSet(b.device)
        self.ring = FlagRing(self._lookahead + 2, 5, b.device)
        self._key = key

    def _post_flags(self, act: torch.Tensor) -> None:
        self.active.copy_(act & (self.res >= self.tol) & (self.it < self.maxiter))
        flag_row(self.ring.flags, act, self.active, self.res, self.it, self.tol)

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None) -> KrylovResult:
        self._setup(b)
        self.b.copy_(b)
        if x0 is None:
            self.x.zero_()
        else:
            self.x.copy_(x0)
        STATS.solves += 1
        self.graphs.run("init", self._init)
        row = run_loop(self.graphs, self.ring, self.maxiter, self._lookahead,
                       lambda k: [("iterate", self._iterate)])
        if row is None:  # maxiter 0: the start's own flags
            self.ring.post(0)
            row = self.ring.read(0)
        return KrylovResult(self.x.clone(), int(row[IT]), float(row[RES]), bool(row[BELOW]))

    __call__ = solve


class CG(_ShortRecurrence):
    _vectors = ("r", "p")
    _scalars = ("rz",)

    def _init(self) -> None:
        bnorm = torch.linalg.norm(self.M(self.b))
        self.tol.copy_(torch.clamp(bnorm * self.rtol, min=self.atol))
        r = self.b - self.A(self.x)
        z = self.M(r)
        self.r.copy_(r)
        self.p.copy_(z)
        self.rz.copy_(torch.dot(r, z))
        self.res.copy_(torch.linalg.norm(z))
        self.it.zero_()
        self._post_flags(torch.ones((), dtype=torch.bool, device=r.device))

    def _iterate(self) -> None:
        act = self.active.clone()
        p, eps = self.p, self.eps
        Ap = self.A(p)
        alpha = self.rz / torch.clamp(torch.dot(p, Ap), min=eps)
        x = self.x + alpha * p
        r = self.r - alpha * Ap
        z = self.M(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp(self.rz, min=eps)
        masked_update(act, (self.x, x), (self.r, r), (self.p, z + beta * p),
                      (self.rz, rz_new), (self.res, torch.linalg.norm(z)),
                      (self.it, self.it + 1))
        self._post_flags(act)


def make_cg(
    A: Callable[[torch.Tensor], torch.Tensor],
    M: Callable[[torch.Tensor], torch.Tensor] | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    maxiter: int = 1000,
) -> CG:
    """CG for a fixed operator/preconditioner pair: solve(b, x0=None)."""
    return CG(A, M, rtol=rtol, atol=atol, maxiter=maxiter)


def cg(A, b, x0=None, *, M=None, rtol: float = 1e-5, atol: float = 1e-5,
       maxiter: int = 1000) -> KrylovResult:
    """One-shot convenience wrapper around make_cg."""
    return make_cg(A, M, rtol=rtol, atol=atol, maxiter=maxiter)(b, x0)
