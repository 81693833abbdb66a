"""Generic time loop mirroring the reference drivers' structure (PyTorch
counterpart of circulantpreconditioner_tpu/models/runner.py).

Step until it ≥ ntmax, t > tmax, or stationarity ‖ΔU‖₂ < precision; log and
call `on_output` every output_freq steps. With chunk > 1 the host
synchronises once per chunk. A captured step (utils/graphs.CapturedStep: the
direct and explicit steppers of the models and the sharded drivers) runs as
CUDA graphs on the card: one replay per step, or one per chunk (the JAX
package's jax.jit(lax.scan), one program per chunk length), the state in the
step's buffer between them. The implicit steppers, whose Krylov loops the
host drives, are called step by step, their steps of a chunk queued back to
back. On a row-sharded state (parallel/) each rank's step returns the norm
of its own block of ΔU, and `global_norms` makes the global ‖ΔU‖₂ of them,
once per step or chunk (inside a captured step's graph), so that every rank
stops at the same step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.utils.device import synchronize
from circulantpreconditioner_tpu_torch.utils.graphs import CapturedStep
from circulantpreconditioner_tpu_torch.utils.profiling import host_span, host_spanned


@dataclass
class TimeLoopResult:
    state: torch.Tensor
    time: float
    iterations: int
    stationary: bool
    step_seconds: list[float] = field(default_factory=list)
    diagnostics: list[dict] = field(default_factory=list)


def _host(v):
    """Python number / list of an extra (a tensor or a Python value)."""
    return v.tolist() if isinstance(v, torch.Tensor) else v


@host_spanned("port.time_loop")
def run_time_loop(
    step: Callable,  # U -> (U_new, dnorm[, extra...])
    U0: torch.Tensor,
    dt: float,
    tmax: float = 0.05,
    ntmax: int = 2_000_000,
    precision: float = 1e-5,
    output_freq: int = 1,
    on_output: Callable | None = None,  # (it, t, U_host, extras) -> None
    log: Callable | None = print,
    chunk: int | None = None,
    global_norms: Callable | None = None,  # local dnorms (tensor) -> global ones
) -> TimeLoopResult:
    """chunk > 1 runs that many steps per host synchronisation. Per-step
    dnorms still come back for the stationarity test; if it trips mid-chunk
    the loop stops with the chunk-end state (the extra steps past a
    stationary point are no-ops by definition). The loop runs in the host
    span "port.time_loop", its host work between steps or chunks in
    "port.loop.host" (utils/profiling.py)."""
    if chunk is not None and chunk > 1:
        return _run_time_loop_chunked(step, U0, dt, tmax=tmax, ntmax=ntmax,
                                      precision=precision, chunk=chunk,
                                      on_output=on_output, log=log,
                                      global_norms=global_norms)
    captured = isinstance(step, CapturedStep)
    if captured:
        step.start(U0, global_norms)
    U = U0
    t = 0.0
    it = 0
    stationary = False
    result = TimeLoopResult(U, t, it, stationary)
    while it < ntmax and t <= tmax and not stationary:
        t0 = time.perf_counter()
        if captured:
            U_new, dnorm, extras = step.state, step.advance(1)[0], []
        else:
            U_new, dnorm, *extras = step(U)
            if global_norms is not None:
                dnorm = global_norms(torch.as_tensor(dnorm).reshape(1))[0]
        synchronize(U_new.device)
        dt_wall = time.perf_counter() - t0
        with host_span("port.loop.host"):
            U = U_new
            t += dt
            it += 1
            dn = float(dnorm)
            stationary = dn < precision
            # implicit steppers return (.., iters, resnorm, converged): log a
            # failed linear solve and continue, like the reference's KSP branch
            if len(extras) >= 3 and not bool(extras[2]):
                if log is not None:
                    log(f"!! step {it}: linear solver did NOT converge "
                        f"(iters={int(extras[0])}, residual={float(extras[1]):.3e})")
            if it % output_freq == 0 or it >= ntmax or stationary or t >= tmax:
                result.step_seconds.append(dt_wall)
                result.diagnostics.append({"it": it, "t": t, "dnorm": dn,
                                           "extras": [_host(e) for e in extras]})
                if log is not None:
                    log(f"-- step {it}, time {t:.6g}, dt {dt:.3g}, |dU| {dn:.3e}, "
                        f"solve wall {dt_wall*1e3:.3f} ms")
                if on_output is not None:
                    on_output(it, t, U.cpu().numpy(), extras)
    with host_span("port.loop.host"):
        result.state = U.clone() if captured else U
    result.time = t
    result.iterations = it
    result.stationary = stationary
    return result


def _run_time_loop_chunked(step, U0, dt, *, tmax, ntmax, precision, chunk, on_output, log,
                           global_norms=None):
    captured = isinstance(step, CapturedStep)
    if captured:
        step.start(U0, global_norms)
    U = U0
    t = 0.0
    it = 0
    stationary = False
    result = TimeLoopResult(U, t, it, stationary)
    while it < ntmax and t <= tmax and not stationary:
        n = min(chunk, ntmax - it, max(int((tmax - t) / dt) + 1, 1))
        t0 = time.perf_counter()
        if captured:
            U, dnorms, extras = step.state, step.advance(n), []  # one replay
        else:
            dnorms, extras = [], []
            for _ in range(n):
                U, dnorm, *ex = step(U)
                dnorms.append(torch.as_tensor(dnorm).reshape(()))
                extras = ex
            dnorms = torch.stack(dnorms)
            if global_norms is not None:
                dnorms = global_norms(dnorms)
        with host_span("port.loop.host"):
            dnorms = dnorms.cpu().numpy()  # the chunk's one synchronisation
            dt_wall = time.perf_counter() - t0
            it += n
            t += n * dt
            hit = np.nonzero(dnorms < precision)[0]
            stationary = hit.size > 0
            dn = float(dnorms[hit[0]] if stationary else dnorms[-1])
            last_extras = [_host(e) for e in extras]
            if len(last_extras) >= 3 and not bool(last_extras[2]):
                if log is not None:
                    log(f"!! step {it}: linear solver did NOT converge "
                        f"(iters={int(last_extras[0])}, residual={float(last_extras[1]):.3e})")
            result.step_seconds.append(dt_wall / n)
            result.diagnostics.append({"it": it, "t": t, "dnorm": dn, "extras": last_extras})
            if log is not None:
                log(f"-- step {it}, time {t:.6g}, dt {dt:.3g}, |dU| {dn:.3e}, "
                    f"wall/step {dt_wall / n * 1e3:.3f} ms ({n}-step device chunk)")
            if on_output is not None:
                on_output(it, t, U.cpu().numpy(), last_extras)
    with host_span("port.loop.host"):
        result.state = U.clone() if captured else U
    result.time = t
    result.iterations = it
    result.stationary = stationary
    return result


def scan_steps(step: Callable, U0: torch.Tensor, n_steps: int):
    """Run `n_steps` applications of `step` back to back with no host
    synchronisation (a captured step: one graph replay); returns (U_final,
    dnorms (n_steps,))."""
    if isinstance(step, CapturedStep):
        step.start(U0)
        dnorms = step.advance(n_steps)
        return step.state.clone(), dnorms.clone()
    U = U0
    dnorms = []
    for _ in range(n_steps):
        U, dnorm, *_ = step(U)
        dnorms.append(torch.as_tensor(dnorm).reshape(()))
    return U, torch.stack(dnorms)
