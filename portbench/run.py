"""Run one cell of the benchmark once, on the machine it is started on.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as `setup_s`, from the process's start): the route's model,
operator, preconditioner and stepper built through the port's public API, the
cells' centres, `warm_requests` requests of the warm-up stream and the finish
graphs of the stepper's GMRES that they did not reach, which capture every
graph the cell's requests replay. The window: requests back to back (a closed
loop, one user running the driver), each a fresh initial state made on the
device and the port's time loop over it, until `--seconds` have passed; the
last request runs to its end. Then the peak memory is read, the loaded modules
checked, the port's state freed, and the sampled answers judged against the
plain reference (portbench/reference/); the loaded modules are checked again
before the result is returned.

With --trace 0 the result line holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read with torch.profiler over the first
TRACE_SECONDS of the window (the whole window's counters besides, and the
wall per step of the window's untraced rest, which the tracer does not slow). The last
line of standard output is one JSON object; the numbers compared to decide
`correct` are printed last on standard error and last in that line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from portbench import spec, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "circulantpreconditioner_tpu")
TRACE_SECONDS = 2.0


def forbidden_modules(names=None) -> list[str]:
    """The top-level names of loaded modules that the benchmark may not load,
    compared whole (circulantpreconditioner_tpu_torch is not
    circulantpreconditioner_tpu)."""
    top = {n.split(".")[0] for n in (sys.modules if names is None else names)}
    return sorted(top & set(FORBIDDEN))


def refuse_forbidden(when: str) -> None:
    """Exit, printing no result, if a module the benchmark may not load is
    loaded."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules the benchmark may not load were loaded {when}: "
                         f"{', '.join(found)}")


def eprint(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Sampler:
    """The requests whose answers are checked: a uniform sample of `k`
    drawn from the seed (reservoir sampling: the window's length need not be
    known) and, where the requests iterate, the one that took the most
    iterations. Inputs and outputs are copied into buffers on the device."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = int(k), traffic.rng(seed, traffic.SAMPLING)
        self.u0, self.u1, self.hard, self.hard_iters = [], [], None, 0

    def offer(self, i: int, U0, U1, iters: int) -> None:
        slot = i if i < self.k else int(self.rng.integers(0, i + 1))
        if slot < self.k:
            if slot == len(self.u0):
                self.u0.append(U0.clone())
                self.u1.append(U1.clone())
            else:
                self.u0[slot].copy_(U0)
                self.u1[slot].copy_(U1)
        if iters > self.hard_iters:
            if self.hard is None:
                self.hard = (U0.clone(), U1.clone())
            else:
                self.hard[0].copy_(U0)
                self.hard[1].copy_(U1)
            self.hard_iters = iters

    def host(self) -> tuple[np.ndarray, np.ndarray]:
        """(inputs, outputs) as float64 (n, samples) arrays."""
        pairs = list(zip(self.u0, self.u1)) + ([self.hard] if self.hard else [])
        u0 = np.stack([a.double().cpu().numpy() for a, _ in pairs], axis=1)
        u1 = np.stack([b.double().cpu().numpy() for _, b in pairs], axis=1)
        self.u0 = self.u1 = self.hard = None
        return u0, u1


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0].rsplit(",", 1)[-1].strip() if out and "," in out[0] else "not read"


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float = T_START) -> dict:
    """One run of `cell`; returns the result object (see the module
    docstring). `device` is the card, or the CPU in the tests."""
    import torch

    from circulantpreconditioner_tpu_torch.utils import graphs
    from portbench.metrics import Context
    from portbench.reference import checks, family
    from portbench.routes import capture_gmres_finishes, dtype_of

    t0 = time.perf_counter()
    check = checks.kind(cell.limits["check"], cell.config, cell.mix)
    route = importlib.import_module(f"portbench.routes.{cell.mix['route']}").build(
        cell.config, cell.mix, device)
    t1 = time.perf_counter()
    mesh = cell.config["mesh"]
    make = traffic.StateMaker(cell.config, family(mesh).cell_centres(mesh), device,
                              dtype_of(cell.config))
    t2 = time.perf_counter()
    warm = traffic.Requests(cell.mix, cell.config, seed, traffic.WARMUP)
    for _ in range(int(cell.mix["warm_requests"])):
        route(make(*warm.next()))
    capture_gmres_finishes(route.stepper)
    _sync(device)
    eprint(f"set-up: imports {t0 - t_start:.3f} s, route {t1 - t0:.3f} s, centres "
           f"{t2 - t1:.3f} s, warm-up {time.perf_counter() - t2:.3f} s")

    requests = traffic.Requests(cell.mix, cell.config, seed, traffic.WINDOW)
    sampler = Sampler(cell.limits["samples"], seed)
    span = torch.profiler.record_function if trace else (lambda name: contextlib.nullcontext())
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    stats0 = graphs.STATS.snapshot()
    times, iterations, failed, traced_steps = [], [], 0, 0
    untraced_t0, untraced_steps = None, 0  # the window's rest after the trace
    setup_s = time.perf_counter() - t_start
    t_w0 = t_end = time.perf_counter()
    while t_end - t_w0 < seconds:
        t0 = time.perf_counter()
        with span("portbench.request"):
            U0 = make(*requests.next())
            with span("portbench.step"):
                U1, iters, converged = route(U0)
            sampler.offer(len(times), U0, U1, sum(iters))
            _sync(device)
        t_end = time.perf_counter()
        times.append(t_end - t0)
        iterations += iters
        failed += not converged
        if prof is not None:
            traced_steps += route.steps
            if t_end - t_w0 >= min(seconds, TRACE_SECONDS):
                prof.stop()
                events, prof = prof.profiler.kineto_results.events(), None
                untraced_t0 = t_end = time.perf_counter()
        elif untraced_t0 is not None:
            untraced_steps += route.steps
    window_s = t_end - t_w0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    refuse_forbidden("by the close of the window")
    stats = {k: v - stats0[k] for k, v in graphs.STATS.snapshot().items()
             if isinstance(v, (int, float))}
    steps = len(times) * route.steps
    eprint(f"window: {len(times)} requests, {steps} steps in {window_s:.3f} s; "
           f"set-up {setup_s:.3f} s; graph captures in the window: {stats['captures']}; "
           f"not converged: {failed}")

    u0, u1 = sampler.host()
    route.release()
    del route, make, sampler
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = check.compare(u0, u1, device)
    eprint(f"reference: {len(readings)} answers judged in {time.perf_counter() - t_ref:.3f} s")
    name, limit = f"{cell.limits['check']}_max", float(cell.limits["limit"])
    value = float(max(readings)) if readings else float("inf")

    metrics, extra = {}, {}
    if not trace:
        values = {"step_ms": window_s / steps * 1e3,
                  "step_p95_ms": float(np.percentile(times, 95)) * 1e3,
                  "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        from portbench import trace as trace_mod

        tr = trace_mod.read(events, traced_steps)
        untraced_step_s = (t_end - untraced_t0) / untraced_steps if untraced_steps else None
        eprint(f"trace: {tr.steps} steps, {tr.step_kernels} kernels in the step calls, "
               f"event kinds {tr.kinds}")
        eprint(f"wall a step: traced {tr.window_s / tr.steps * 1e3:.6f} ms; untraced "
               + (f"{untraced_step_s * 1e3:.6f} ms ({untraced_steps} steps)"
                  if untraced_step_s else "none (the window ended in the trace)"))
        ctx = Context(cell.config, cell.mix, steps, iterations, stats, tr, untraced_step_s)
        for m in cell.per_layer:
            v = importlib.import_module(f"portbench.metrics.{m['name']}").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    on_card = device.type == "cuda"
    result = {
        "correct": bool(readings) and value <= limit,
        "attempted": len(times),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak, **extra,
                   "power_limit": _power_limit() if on_card else "none"},
    }
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit}}
    eprint(f"readings of {name}: {[float(r) for r in readings]}")
    eprint(f"check {name} {value!r} limit {limit!r}")
    refuse_forbidden("by the reference or the metrics' readers")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        eprint("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        eprint(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} present")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
