"""k2_roofline: kernel K2 (csrc/plane_stencil.cu, the wave normal-form
stencil SpMV) against its bytes bound: each K2 launch in the traced window
reads D's coefficients and x and writes y on the configuration's grid
(portbench/roofline.py::k2_bytes; K2 runs on the fine grid only), over the
device time of the kernels named k2_plane_stencil."""

import math

from portbench import roofline

NAME = "k2_plane_stencil"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    launches = sum(n for k, n in tr.kernel_count.items() if NAME in k)
    seconds = sum(s for k, s in tr.kernel_seconds.items() if NAME in k)
    if launches == 0 or seconds <= 0:
        return None
    cells = math.prod(int(v) for v in ctx.config["mesh"]["n"])
    m = 4  # the wave system's unknowns per cell in 3D: p and q
    nbytes = roofline.k2_bytes(cells, m, 6) * launches
    return 100.0 * nbytes / roofline.PEAK_BYTES / seconds
