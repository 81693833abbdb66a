"""Matrix-free restarted GMRES (PyTorch counterpart of
circulantpreconditioner_tpu/solvers/gmres.py).

Same arithmetic as the JAX solver: PETSc's defaults (restart m = 30, LEFT
preconditioning, convergence when ‖r‖ < max(rtol·‖b_pre‖, atol), divergence
when ‖r‖ > divtol·‖b_pre‖), classical Gram-Schmidt run twice (CGS2), and the
Givens rotations composed into an explicit (m+1)×(m+1) matrix Q so that
applying all previous rotations to a new Hessenberg column is one matvec.
side="right" solves A M⁻¹ y = b, x = M⁻¹ y, and stops, as PETSc's default
test does, where its residual estimate meets the tolerance. The estimate is
that of A M⁻¹ as applied to each basis vector; x takes M⁻¹ of their
combination, and in float32, or with a preconditioner in reduced precision
(K4's bf16×3) that is not linear to the last bit, ‖b − A x‖ can lie far
above it. With true_residual=True the estimate's stop is checked: the next
cycle's start forms b − A x and its norm, and the solve ends there if that
norm meets the tolerance, else that cycle runs (a restart the true residual
forced, counted in STATS.true_restarts). Only the "flat" basis is ported:
the JAX solver's "lane" layout folds vectors onto the TPU's 128-lane axis.

The solve is device-resident, as the JAX solver's jit + lax.while_loop is.
The basis V (m+1, n), H, Q, the residual estimate, the counters and the
inner loop's `active` flag are device tensors of the solver, and the host
issues no synchronising call inside an iteration. An iteration is two step
functions (utils/graphs.py), each a CUDA graph on the card: `precond_op`
(A then M, or M then A) on a static input row, and the projection of inner
index j: CGS2 on the active rows V[:j+1] (one graph per j, captured the first
time j is reached), the Givens update of Q and H on the device (the JAX
solver's `hcol = Q @ h`), the residual estimate res = β·|Q[j+1, 0]|, and the
stopping tests, every update masked by `active` as lax.while_loop's state
is. The host learns where the cycle stopped from a flag ring, LOOKAHEAD
iterations behind the device; the iterations it queued past the stop run
masked and change nothing that the result reads. At the end of a cycle (the host knows j then)
the triangular solve and x += V[:j]ᵀy (then M for side="right") run on the
device, as one graph per j.

On row-sharded vectors (parallel/), each rank holds its block of b, x and
the basis, and `allreduce` sums a tensor over the ranks: the norms and the
CGS2 projections are then the global ones (the JAX package's psums under
shard_map). The collectives, the all-reduces and the operator's and
preconditioner's exchanges, are captured in the graphs with the rest. Every
rank reads the same all-reduced flags, so every rank takes the same stopping
decisions and captures and replays the same graphs in the same order.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.utils.graphs import (
    STATS,
    FlagRing,
    GraphSet,
    masked_update,
)
from circulantpreconditioner_tpu_torch.utils.profiling import device_span

# iterations the host queues before it reads the flags of the oldest (the
# results do not depend on it: the CPU tests set a solver's `_lookahead`)
LOOKAHEAD = 1


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int  # total inner iterations (matvec count)
    resnorm: float  # final residual norm: the estimate (preconditioned for
    # side="left"); ‖b − A x‖ where true_residual checked the estimate's stop
    converged: bool  # tolerance met (PETSc reason > 0 analog)


def _identity(r):
    return r


def _in_span(name: str):
    """Run a GMRES step function inside the device span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(self, *args):
            with device_span(name, self.b.device):
                fn(self, *args)
        return spanned
    return wrap


def _combine(c: torch.Tensor, Vj: torch.Tensor) -> torch.Tensor:
    """Σ_i c_i V_i. One row is a scaled copy: cuBLAS runs a one-row product
    as a GEMM that takes 49 µs at n = 10⁶ on an H100, against 12 µs for two
    rows."""
    return c * Vj[0] if Vj.shape[0] == 1 else Vj.T @ c


# a flag row: the iteration's `active` on entry and after it, the residual
# estimate, the inner index j, res < tol, res ≥ tol and res > dtol
ACT_IN, ACTIVE, RES, J, BELOW, ABOVE, DIVERGED = range(7)


def _flag_row(out, act_in, active, res, j, tol, dtol) -> None:
    torch.stack([act_in.double(), active.double(), res.double(), j.double(),
                 (res < tol).double(), (res >= tol).double(), (res > dtol).double()], out=out)


def read_slots(ring: FlagRing, pending: list, first: int, last: int) -> np.ndarray:
    """Read the flag rows of iterations first..last−1 (slot k modulo the
    ring) and return the last. An iteration that ran masked adds its kernel
    launches (`pending[k]`) to STATS.masked_launches."""
    for k in range(first, last):
        row = ring.read(k % len(ring))
        if row[ACT_IN]:
            STATS.iterations += 1
        else:
            STATS.masked += 1
            STATS.masked_launches = tuple(map(sum, zip(STATS.masked_launches, pending[k])))
    return row


def run_loop(graphs: GraphSet, ring: FlagRing, count: int, lookahead: int,
             steps: Callable[[int], list]) -> np.ndarray:
    """The host side of a device-resident while_loop: queue iteration k as
    the step functions `steps(k)` ((key, fn) pairs) and the post of its flag
    row to slot k modulo the ring, for k < count, reading the oldest unread
    row whenever more than `lookahead` are queued; stop queuing at the first
    row whose `active` is clear, read the rows still queued (those iterations
    ran masked), and return the last row. The ring needs lookahead + 2 slots
    or `count` + 1."""
    pending: list[tuple[int, ...]] = []
    read, row = 0, None
    for k in range(count):
        counts = [graphs.run(key, fn) for key, fn in steps(k)]
        ring.post(k % len(ring))
        pending.append(tuple(map(sum, zip(*counts))))
        if k + 1 - read > lookahead:  # more than L iterations unread: read the oldest
            row = read_slots(ring, pending, read, read + 1)
            read += 1
            if not row[ACTIVE]:
                break
    if read < len(pending):
        row = read_slots(ring, pending, read, len(pending))
    return row


class GMRES:
    """GMRES for a fixed operator/preconditioner pair: solve(b, x0=None), or
    call the object. Buffers and graphs are made by the first solve and kept
    while the shape, dtype and device of b stay (`release()` drops them)."""

    def __init__(self, A, M=None, *, restart: int = 30, rtol: float = 1e-5,
                 atol: float = 1e-5, maxiter: int = 1000, divtol: float = 1e4,
                 side: str = "left", allreduce=None, true_residual: bool = False):
        if side not in ("left", "right"):
            raise ValueError(f"side must be 'left' or 'right', got {side!r}")
        if true_residual and side != "right":
            raise ValueError("true_residual checks side='right' GMRES: side='left' stops on "
                             "the preconditioned residual")
        if restart < 1:
            raise ValueError(f"restart must be ≥ 1, got {restart}")
        self.A, self.M = A, (M if M is not None else _identity)
        self.m = int(restart)
        self.rtol, self.atol, self.maxiter, self.divtol = rtol, atol, int(maxiter), divtol
        self.right = side == "right"
        self.check = bool(true_residual)
        self.allreduce = allreduce
        self._lookahead = LOOKAHEAD
        self._key = None

    # --- the reductions (global ones on row-sharded vectors) ----------------
    def _norm(self, v: torch.Tensor) -> torch.Tensor:
        if self.allreduce is None:
            return torch.linalg.norm(v)
        return torch.sqrt(self.allreduce(torch.dot(v, v).reshape(1)))[0]

    def _project(self, Vj: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return Vj @ w if self.allreduce is None else self.allreduce(Vj @ w)

    def _precondition(self, r: torch.Tensor) -> torch.Tensor:
        with device_span("port.pc", r.device):
            return self.M(r)

    def _residual(self) -> torch.Tensor:
        r = self.b - self.A(self.x)
        return r if self.right else self._precondition(r)

    # --- buffers ------------------------------------------------------------
    def _setup(self, b: torch.Tensor) -> None:
        key = (b.shape[0], b.dtype, b.device)
        if key == self._key:
            return
        n, m, dt, dev = b.shape[0], self.m, b.dtype, b.device
        zeros = functools.partial(torch.zeros, dtype=dt, device=dev)
        self.b, self.x, self.vin, self.w = zeros(n), zeros(n), zeros(n), zeros(n)
        self.V = zeros(m + 1, n)
        self.H, self.Q = zeros(m + 1, m), zeros(m + 1, m + 1)
        self.eye = torch.eye(m + 1, dtype=dt, device=dev)
        self.beta, self.res, self.tol, self.dtol = zeros(()), zeros(()), zeros(()), zeros(())
        self.j = torch.zeros((), dtype=torch.int64, device=dev)
        self.it = torch.zeros((), dtype=torch.int64, device=dev)
        self.active = torch.zeros((), dtype=torch.bool, device=dev)
        self.eps = float(torch.finfo(dt).tiny)
        self.graphs = GraphSet(dev)
        self.ring = FlagRing(m + 1, 7, dev)  # slot k: inner index k; slot m: the start
        self._key = key

    def release(self) -> None:
        """Drop the graphs and the basis V, most of the solver's device
        memory; the next solve makes them again."""
        if self._key is not None:
            self.graphs.release()
            del self.V, self.graphs, self.ring
        self._key = None

    # --- step functions (utils/graphs.py): no arguments, static buffers -----
    # each inside a device span (utils/profiling.py): the cycle's bookkeeping,
    # the operator and PC apply, the orthogonalisation
    @_in_span("port.gmres.cycle")
    def _init(self) -> None:
        """tol, dtol and ‖r0‖ (the JAX solver's res0), into slot m."""
        b_pre = self.b if self.right else self._precondition(self.b)
        bnorm = self._norm(b_pre)
        self.tol.copy_(torch.clamp(bnorm * self.rtol, min=self.atol))
        self.dtol.copy_(torch.clamp(bnorm, min=self.eps) * self.divtol)
        res0 = self._norm(self._residual())
        self.res.copy_(res0)
        self.it.zero_()
        one = torch.ones((), dtype=torch.bool, device=res0.device)
        _flag_row(self.ring.flags, one, one, res0, self.it, self.tol,
                  torch.full_like(self.dtol, float("inf")))

    @_in_span("port.gmres.cycle")
    def _start(self) -> None:
        """A restart cycle's first basis row and reset Q, H, j, res, active;
        with true_residual its β = ‖b − A x‖ also into the flag row, which the
        host posts and reads after a cycle whose estimate met the tolerance."""
        r = self._residual()
        beta = self._norm(r)
        self.beta.copy_(beta)
        torch.div(r, torch.clamp(beta, min=self.eps), out=self.V[0])
        self.vin.copy_(self.V[0])
        self.H.zero_()
        self.Q.copy_(self.eye)
        self.j.zero_()
        self.res.copy_(beta)
        self.active.copy_((beta >= self.tol) & (beta <= self.dtol) & (self.it < self.maxiter))
        if self.check:
            _flag_row(self.ring.flags, self.active, self.active, beta, self.j, self.tol,
                      self.dtol)

    @_in_span("port.gmres.apply")
    def _precond_op(self) -> None:
        v = self.vin
        self.w.copy_(self.A(self._precondition(v)) if self.right
                     else self._precondition(self.A(v)))

    @_in_span("port.gmres.ortho")
    def _arnoldi(self, j: int) -> None:
        """Inner index j: CGS2 against V[:j+1], the Givens update, the
        stopping tests, the next row into `vin`; masked by `active`."""
        m, eps = self.m, self.eps
        act = self.active.clone()
        Vj = self.V[: j + 1]
        w = self.w
        h = self._project(Vj, w)  # classical Gram-Schmidt, twice
        w = w - _combine(h, Vj)
        h2 = self._project(Vj, w)
        w = w - _combine(h2, Vj)
        wnorm = self._norm(w)
        hfull = torch.zeros(m + 1, dtype=w.dtype, device=w.device)
        hfull[: j + 1] = h + h2
        hfull[j + 1] = wnorm
        hcol = self.Q @ hfull  # all previous rotations at once
        denom = torch.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        ok = denom > eps
        c = torch.where(ok, hcol[j] / torch.clamp(denom, min=eps), 1.0)
        s = torch.where(ok, hcol[j + 1] / torch.clamp(denom, min=eps), 0.0)
        qj, qj1 = self.Q[j].clone(), self.Q[j + 1].clone()
        hcol[j] = denom
        hcol[j + 1].zero_()
        masked_update(act, (self.V[j + 1], w / torch.clamp(wnorm, min=eps)),
                      (self.Q[j], c * qj + s * qj1), (self.Q[j + 1], -s * qj + c * qj1),
                      (self.H[:, j], hcol))
        masked_update(act, (self.res, self.beta * torch.abs(self.Q[j + 1, 0])),
                      (self.j, self.j + 1))
        res = self.res
        go = act & (res >= self.tol) & (res <= self.dtol) & (self.it + self.j < self.maxiter)
        self.active.copy_(go & (j + 1 < m))
        self.vin.copy_(self.V[j + 1])
        _flag_row(self.ring.flags, act, self.active, res, self.j, self.tol, self.dtol)

    @_in_span("port.gmres.cycle")
    def _finish(self, j: int) -> None:
        """Solve R y = g on the active j×j block (|R_ii| < eps → eps, as the
        JAX solver), x += V[:j]ᵀ y (M of it for side="right"), it += j."""
        R = self.H[:j, :j]
        d = torch.diagonal(R)
        R = R + torch.diag((torch.abs(d) < self.eps).to(R.dtype) * self.eps)
        g = self.beta * self.Q[:j, 0]
        y = torch.linalg.solve_triangular(R, g.unsqueeze(1), upper=True).squeeze(1)
        corr = _combine(y, self.V[:j])
        self.x.add_(self._precondition(corr) if self.right else corr)
        self.it.add_(j)

    # --- the host loop --------------------------------------------------------
    def _cycle(self, it: int) -> np.ndarray:
        """One restart cycle after its start; returns its last flag row."""
        return run_loop(self.graphs, self.ring, min(self.m, self.maxiter - it), self._lookahead,
                        lambda k: [("precond_op", self._precond_op),
                                   (("arnoldi", k), functools.partial(self._arnoldi, k))])

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None) -> KrylovResult:
        self._setup(b)
        self.b.copy_(b)
        if x0 is None:
            self.x.zero_()
        else:
            self.x.copy_(x0)
        STATS.solves += 1
        self.graphs.run("init", self._init)
        self.ring.post(self.m)
        row = self.ring.read(self.m)
        it, started = 0, False
        while row[ABOVE] and it < self.maxiter and not row[DIVERGED]:  # the outer loop
            if started:  # the true residual, formed by this cycle's start, forced it
                STATS.true_restarts += 1
            else:
                self.graphs.run("start", self._start)
            row = self._cycle(it)
            j = int(row[J])
            if j == 0:  # the cycle stopped before its first iteration: so does JAX's loop
                break
            self.graphs.run(("finish", j), functools.partial(self._finish, j))
            it += j
            started = bool(self.check and row[BELOW] and not row[DIVERGED])
            if started:  # the estimate met tol: the next start's ‖b − A x‖ decides
                self.graphs.run("start", self._start)
                self.ring.post(self.m)
                row = self.ring.read(self.m)
        return KrylovResult(self.x.clone(), it, float(row[RES]),
                            bool(row[BELOW] and not row[DIVERGED]))

    __call__ = solve


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
    true_residual: bool = False,
) -> GMRES:
    """GMRES for a fixed operator/preconditioner pair: solve(b, x0=None).
    allreduce: sums a tensor over the ranks of a row-sharded solve;
    true_residual: side="right" stops only where ‖b − A x‖ meets the
    tolerance."""
    return GMRES(A, M, restart=restart, rtol=rtol, atol=atol, maxiter=maxiter, divtol=divtol,
                 side=side, allreduce=allreduce, true_residual=true_residual)


def gmres(A, b, x0=None, *, M=None, restart: int = 30, rtol: float = 1e-5,
          atol: float = 1e-5, maxiter: int = 1000, side: str = "left",
          allreduce=None, true_residual: bool = False) -> KrylovResult:
    """One-shot convenience wrapper around make_gmres."""
    return make_gmres(A, M, restart=restart, rtol=rtol, atol=atol, maxiter=maxiter,
                      side=side, allreduce=allreduce, true_residual=true_residual)(b, x0)
