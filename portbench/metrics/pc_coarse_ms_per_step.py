"""pc_coarse_ms_per_step: device milliseconds per time step in the
preconditioner's coarse part (the device span "port.pc.coarse",
inclusive): the V-cycle below its fine level, the bottom solve included,
or the multiplicative PC's DCT projection; over the traced part of the
window (utils/profiling.py)."""


def read(ctx):
    s = ctx.stats.get("span_port_pc_coarse_incl_s", 0)
    if not s or ctx.trace is None or not ctx.trace.steps:
        return None
    return s * 1e3 / ctx.trace.steps
