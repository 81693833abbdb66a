"""circulant_pc_roofline: the dense circulant collapse (the FFT
preconditioner of a grid whose velocity has one nonzero component: x = M b
with M the n×n inverse along that axis, one K4 launch at "high") against
its bytes bound. An apply needs at least b read once, x written once and M
read once, in float32; times the entries of the device span
"port.pc.circulant", over its inclusive device time in the traced part of
the window. None where the span is absent or the configuration's
preconditioner is not the dense collapse."""

import math

from portbench import roofline


def least_bytes(n, velocity, itemsize: int = 4) -> int | None:
    """One apply's bytes on the grid n = (nx, ny, nz) with `velocity`
    (x, y, z); None unless exactly one component is nonzero."""
    axes = [i for i, a in enumerate(velocity) if float(a) != 0.0]
    if len(axes) != 1:
        return None
    cells = math.prod(int(v) for v in n)
    side = int(n[axes[0]])
    return (2 * cells + side * side) * itemsize


def read(ctx):
    n = ctx.stats.get("span_port_pc_circulant_n", 0)
    s = ctx.stats.get("span_port_pc_circulant_incl_s", 0)
    if not n or s <= 0 or "velocity" not in ctx.config:
        return None
    nbytes = least_bytes(ctx.config["mesh"]["n"], ctx.config["velocity"])
    if nbytes is None:
        return None
    return 100.0 * nbytes * n / roofline.PEAK_BYTES / s
