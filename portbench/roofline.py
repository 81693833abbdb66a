"""Peaks of the card and the least-time arithmetic of the rooflines.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
full 700 W power limit; the run records the card's own limit beside them):
3.35 TB/s of HBM3, 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s
TF32 and 989 TFLOP/s bf16 on them. `bound` is the port's bench.py::bound:
the larger of the operations over the peak of their type and the bytes,
each input read once and each output written once, over the memory rate.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    """(least seconds the card could take, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def direct_step_bytes(shape_xyz, itemsize: int = 4) -> int:
    """A direct circulant step x = C⁻¹ b on an (nx, ny, nz) grid: the state
    read once, the state written once and the spectrum read once, the
    complex half spectrum of the real transform (nz·ny·(nx//2 + 1) complex
    values). Whatever implements the step (cuFFT, K1, the dense collapse
    through K4), this is its work."""
    nx, ny, nz = (int(v) for v in shape_xyz)
    cells = nx * ny * nz
    return 2 * cells * itemsize + nz * ny * (nx // 2 + 1) * 2 * itemsize


def direct_step_flops(shape_xyz) -> float:
    """The operations of the same step by FFT: 2 · 2.5·N·log2(N) real
    operations for the forward and inverse real transforms plus the complex
    product by the spectrum (6 per complex value of the half spectrum)."""
    import math

    nx, ny, nz = (int(v) for v in shape_xyz)
    cells = nx * ny * nz
    return 2 * 2.5 * cells * math.log2(cells) + 6 * nz * ny * (nx // 2 + 1)


def k2_bytes(cells: int, m: int, offsets: int, itemsize: int = 4) -> int:
    """One launch of K2 (the wave normal-form stencil SpMV, y = D x, field
    major) on a grid of `cells` sites with m unknowns each and `offsets`
    neighbours: D's coefficients (the m×m diagonal blocks, one scalar per
    neighbour and its (m−1)-vector of normal components) read once, x read
    once, y written once."""
    return (m * m + offsets + offsets * (m - 1) + 2 * m) * cells * itemsize
