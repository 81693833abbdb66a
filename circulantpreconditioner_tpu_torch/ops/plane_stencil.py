"""Wave normal-form stencil SpMV: kernel K2, hand-written in CUDA C++ for
Hopper (csrc/plane_stencil.cu).

PyTorch counterpart of circulantpreconditioner_tpu/ops/pallas_stencil.py.
`make_plane_stencil_matvec(Wn)` takes a flat-layout 3D
`WaveNormalStencilOperator` whose neighbour offsets reach at most one plane
(|o| ≤ nx·ny, true for 7-point stencils in lexicographic order) and returns
a field-major matvec that accepts (m, N), (m, nz, ny, nx) or flat (m·N,)
input and returns the same shape; None when the operator misses that
contract. The TPU kernel's other rule, nx·ny % 128 == 0, is a Mosaic lane
rule and is dropped.

On a CUDA tensor the matvec launches K2 (one thread per cell, the
coefficients streamed once) and counts the launch in
`PlaneStencilMatvec.launches`; on a CPU tensor it runs K2's plain version,
`WaveNormalStencilOperator.matvec_fm` (`torch.roll` per offset). There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from circulantpreconditioner_tpu_torch.ops.stencil import WaveNormalStencilOperator

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
MAX_OFFSETS = 6


def make_plane_stencil_matvec(Wn: WaveNormalStencilOperator):
    """The field-major matvec of Wn, or None when Wn is not flat-layout 3D
    with every |offset| ≤ nx·ny (and at most 6 offsets)."""
    if Wn.layout != "flat" or len(Wn.shape_zyx) != 3:
        return None
    nz, ny, nx = Wn.shape_zyx
    offs = tuple(int(o) for o in Wn.offsets)
    if len(offs) > MAX_OFFSETS or any(abs(o) > ny * nx for o in offs):
        return None
    return PlaneStencilMatvec(Wn)


class PlaneStencilMatvec:
    """Callable y = D x for field-major x; see the module docstring."""

    launches = 0  # K2 launches made by plane_stencil_cuda

    def __init__(self, Wn: WaveNormalStencilOperator):
        self.op = Wn
        self.m = Wn.m
        self.N = Wn.shape_zyx[0] * Wn.shape_zyx[1] * Wn.shape_zyx[2]

    def __call__(self, g: torch.Tensor) -> torch.Tensor:
        shp = g.shape
        if g.numel() != self.m * self.N:
            raise ValueError(f"K2: input has {g.numel()} values, the operator takes "
                             f"m·N = {self.m}·{self.N}")
        g2 = g.reshape(self.m, self.N)
        if g2.device.type == "cpu":
            out = self.op.matvec_fm(g2)
        else:
            out = plane_stencil_cuda(self.op, g2)
        return out.reshape(shp)


def _check_kernel_inputs(Wn: WaveNormalStencilOperator, g: torch.Tensor) -> None:
    if g.device.type != "cuda":
        raise ValueError(f"K2 needs a CUDA tensor, got one on {g.device}")
    if g.dtype not in _DTYPE_CODE:
        raise ValueError(f"K2 computes in float32 or float64, got {g.dtype}")
    m, K = Wn.m, len(Wn.offsets)
    N = Wn.shape_zyx[0] * Wn.shape_zyx[1] * Wn.shape_zyx[2]
    expected = ((m, N), (m, m, N), (K, N), (K, m - 1, N))
    for name, t, shape in zip(("x", "diag", "s", "nvec"), (g, *Wn.arrays), expected):
        if t.device != g.device:
            raise ValueError(f"K2: {name} is on {t.device}, x on {g.device}")
        if t.dtype != g.dtype:
            raise ValueError(f"K2: {name} is {t.dtype}, x is {g.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"K2: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"K2: {name} is not contiguous")


def plane_stencil_cuda(Wn: WaveNormalStencilOperator, g: torch.Tensor) -> torch.Tensor:
    """Launch K2 on g (m, N) on PyTorch's current stream; counts one launch."""
    from circulantpreconditioner_tpu_torch.native.build import load_library

    _check_kernel_inputs(Wn, g)
    lib = load_library()
    m, N = g.shape
    diag, s, nvec = Wn.arrays
    offs = [int(o) for o in Wn.offsets] + [0] * (MAX_OFFSETS - len(Wn.offsets))
    out = torch.empty_like(g)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.k2_plane_stencil(g.data_ptr(), diag.data_ptr(), s.data_ptr(), nvec.data_ptr(),
                               out.data_ptr(), N, m - 1, len(Wn.offsets), *offs, Wn.c0,
                               _DTYPE_CODE[g.dtype], g.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err} "
                           f"({lib.k2_error_string(err).decode()})")
    PlaneStencilMatvec.launches += 1
    return out
