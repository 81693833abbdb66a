"""kernels_per_step: device kernels launched by the calls into the port
(inside the "portbench.step" spans, graph replays included) in the traced
window, per time step completed there."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.steps == 0 or tr.step_kernels == 0:
        return None
    return tr.step_kernels / tr.steps
