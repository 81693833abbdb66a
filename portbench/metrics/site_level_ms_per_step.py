"""site_level_ms_per_step: device milliseconds per time step in the grid
V-cycle's supercell level (the device span "port.pc.site", inclusive): its
point-block smoothing of each cell, its residuals, the restriction of the
cells of each site to the site and the prolongation back; the levels below
it (the device span "port.pc.coarse") are left out. Over the traced part of
the window (utils/profiling.py)."""


def read(ctx):
    s = ctx.stats.get("span_port_pc_site_incl_s", 0)
    if not s or ctx.trace is None or not ctx.trace.steps:
        return None
    return s * 1e3 / ctx.trace.steps
