"""host_wait_ms_per_solve: host milliseconds blocked on the Krylov loop's
flag ring (utils.graphs.STATS.wait_seconds) per solve (STATS.solves), over
the window."""


def read(ctx):
    solves, s = ctx.stats.get("solves", 0), ctx.stats.get("wait_seconds", 0)
    if not solves or not s:
        return None
    return s * 1e3 / solves
