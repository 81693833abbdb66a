"""pc_ms_per_step: device milliseconds per time step inside the
preconditioner's applies, M's calls in solvers/gmres.py (the device span
"port.pc", inclusive: the V-cycle's levels or the projection and pbjacobi,
and the operator applies they make), over the traced part of the window,
where the span accumulates (utils/profiling.py)."""


def read(ctx):
    s = ctx.stats.get("span_port_pc_incl_s", 0)
    if not s or ctx.trace is None or not ctx.trace.steps:
        return None
    return s * 1e3 / ctx.trace.steps
