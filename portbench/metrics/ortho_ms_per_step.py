"""ortho_ms_per_step: device milliseconds per time step in GMRES's
orthogonalisation, the Arnoldi step functions (the device span
"port.gmres.ortho", inclusive: CGS2, the Givens update, the stopping
tests), over the traced part of the window (utils/profiling.py)."""


def read(ctx):
    s = ctx.stats.get("span_port_gmres_ortho_incl_s", 0)
    if not s or ctx.trace is None or not ctx.trace.steps:
        return None
    return s * 1e3 / ctx.trace.steps
