"""true_restarts_per_solve: the GMRES restart cycles that the true residual
forced (utils.graphs.STATS.true_restarts: a right-preconditioned solve
whose cycle estimate met the tolerance while ‖b − A x‖ did not) per solve
(STATS.solves), over the window. None where the program keeps no such
counter."""


def read(ctx):
    solves = ctx.stats.get("solves", 0)
    if not solves or "true_restarts" not in ctx.stats:
        return None
    return ctx.stats["true_restarts"] / solves
