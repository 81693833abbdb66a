"""op_apply_roofline: the implicit operator I + D against its bytes bound.
Each apply (the device span "port.op", wherever it runs: GMRES's A, the
V-cycle's fine level, the multiplicative PC's residual) needs at least
K2's bytes on the configuration's grid (portbench/roofline.py::k2_bytes:
D's coefficients, x read once, y written once; the identity adds none),
over the span's inclusive device time, traced part of the window. The
work is the operator's, whatever kernel implements it."""

import math

from portbench import roofline


def read(ctx):
    n, s = ctx.stats.get("span_port_op_n", 0), ctx.stats.get("span_port_op_incl_s", 0)
    if not n or s <= 0:
        return None
    cells = math.prod(int(v) for v in ctx.config["mesh"]["n"])
    m = 4  # the wave system's unknowns per cell in 3D: p and q
    nbytes = roofline.k2_bytes(cells, m, 6) * n
    return 100.0 * nbytes / roofline.PEAK_BYTES / s
