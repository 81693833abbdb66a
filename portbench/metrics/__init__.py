"""Per-layer metrics: `portbench.metrics.<name>.read(ctx)` returns the
metric's value from what the traced run recorded, or None where it finds
nothing to read (the harness then leaves the metric out of the line).

A reader sees a `Context`: the cell's configuration and traffic mix, the
window's requests (Krylov iterations of each step, solves), the differences
of the port's counters (`utils.graphs.STATS`) over the window, the
profiler's `Trace` of the traced part of the window (portbench/trace.py),
and the wall per step of the window's untraced rest.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from portbench.trace import Trace


@dataclass
class Context:
    config: dict
    mix: dict
    steps: int  # time steps completed in the window
    iterations: list = field(default_factory=list)  # Krylov iterations of each step
    stats: dict = field(default_factory=dict)  # utils.graphs.STATS over the window
    trace: Trace | None = None
    untraced_step_s: float | None = None  # wall per step of the window's untraced rest
