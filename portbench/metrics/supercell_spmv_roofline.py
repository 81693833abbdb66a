"""supercell_spmv_roofline: the supercell SpMV y = D x of a tetrahedral mesh
(the 6 tets of each hex of an nx × ny × nz lattice one grid site) against
its bytes bound. Each apply (the device span "port.supercell" around
`SupercellStencilOperator._apply_gt`, wherever it runs: GMRES's A, the
V-cycle's residuals at its supercell level) needs at least the bytes that
`roofline.k2_bytes` counts for the normal form, in float32: per cell the
m×m diagonal block, x read once and y written once (m² + 2m numbers), and
per side of each interior face the neighbour's scalar and normal (m
numbers), so that no later normal-form kernel can read above 100 %. Over
the span's inclusive device time, traced part of the window."""

import math

from portbench import roofline


def interior_faces(n) -> int:
    """The faces between two tets of the 6-tet split of an n = (nx, ny, nz)
    hex lattice: 4 faces a tet, less the 4·(nx·ny + ny·nz + nx·nz)
    triangles on the boundary (two a boundary quad), each interior one
    counted from both sides."""
    nx, ny, nz = (int(v) for v in n)
    boundary = 4 * (nx * ny + ny * nz + nx * nz)
    return (4 * 6 * nx * ny * nz - boundary) // 2


def least_bytes(n, m: int = 4, itemsize: int = 4) -> int:
    """One apply's bytes on the lattice n, m unknowns a cell."""
    cells = 6 * math.prod(int(v) for v in n)
    return (cells * (m * m + 2 * m) + 2 * interior_faces(n) * m) * itemsize


def read(ctx):
    n, s = ctx.stats.get("span_port_supercell_n", 0), ctx.stats.get("span_port_supercell_incl_s", 0)
    if not n or s <= 0:
        return None
    mesh = ctx.config["mesh"]["n"]
    return 100.0 * least_bytes(mesh, len(mesh) + 1) * n / roofline.PEAK_BYTES / s
