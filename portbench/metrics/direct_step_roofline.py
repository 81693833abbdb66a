"""direct_step_roofline: the direct circulant step's least time (the
larger of its bytes over the memory rate and its FFT operations over the
float32 peak; portbench/roofline.py) over its device time: every device
operation the steps' calls ran in the traced window, per step. The work is
the problem's, whatever implements the step."""

from portbench import roofline


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.step_device_s <= 0:
        return None
    shape = ctx.config["mesh"]["n"]
    least, _ = roofline.bound(roofline.direct_step_flops(shape),
                              roofline.direct_step_bytes(shape))
    return 100.0 * least * tr.steps / tr.step_device_s
