"""device_idle_pct: the share of the untraced wall in which no operation runs
on the device (kernels, copies, sets): 1 − (device busy time per time step
in the traced part of the window, the union of the device operations'
intervals) / (wall per time step in the window's untraced rest). The wall
comes from the untraced rest because the tracer's records slow the host's
launches, which would count as idle. The two parts hold different requests,
so where the device is saturated the reading lies within about a point of 0
either side."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.steps or not ctx.untraced_step_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.steps / ctx.untraced_step_s)
