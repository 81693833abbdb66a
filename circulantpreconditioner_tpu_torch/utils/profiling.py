"""Profiling and observability, the reference's PetscTime/-log_view analog:
the counterpart of circulantpreconditioner_tpu/utils/profiling.py.

- `timed`: wall-clock context manager that waits for the device's queued
  work before it stops the clock (torch.cuda.synchronize once CUDA is in
  use; nothing on the CPU, whose work is done when the call returns).
- `trace`: a torch.profiler trace of a code block (the CPU and, where there
  is one, the GPU), exported as a Chrome trace (chrome://tracing, Perfetto)
  into `logdir`.
- `StepMetrics`: per-step structured metrics (JSON lines), replacing the
  reference's printf diagnostics (solve time, KSP iterations, residual).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(result: dict, key: str):
    """`with timed(d, "solve"): ...` → d["solve"] = seconds, device work
    queued inside the block included."""
    _synchronize()  # work queued before the block is not the block's
    t0 = time.perf_counter()
    yield
    _synchronize()
    result[key] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block with torch.profiler and write its Chrome trace to
    `logdir` (default: torch_trace under the temporary directory) as
    trace_<pid>_<ms>.json. Yields logdir."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield logdir
        finally:
            _synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


@dataclass
class StepMetrics:
    """Append-only JSON-lines metrics sink."""

    path: str | None = None
    records: list[dict] = field(default_factory=list)

    def log(self, **kv) -> dict:
        rec = dict(ts=time.time(), **kv)
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def summary(self) -> dict:
        out: dict = {"steps": len(self.records)}
        for key in ("solve_s", "iters", "resnorm"):
            vals = [r[key] for r in self.records if key in r]
            if vals:
                out[key] = {"median": float(np.median(vals)), "max": float(np.max(vals))}
        return out
