"""gmres_iters: GMRES iterations per solve, the mean over the window of the
iterations the port's implicit stepper returns."""


def read(ctx):
    if not ctx.iterations:
        return None
    return sum(ctx.iterations) / len(ctx.iterations)
