"""host_waits_per_solve: the host's waits on the Krylov loop's flag ring
(utils.graphs.STATS.waits) per solve (STATS.solves), over the window."""


def read(ctx):
    solves = ctx.stats.get("solves", 0)
    if not solves:
        return None
    return ctx.stats.get("waits", 0) / solves
