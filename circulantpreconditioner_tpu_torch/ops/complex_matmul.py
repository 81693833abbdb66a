"""Complex matrix product from separate real and imaginary planes: kernel K3,
hand-written in CUDA C++ for Hopper (csrc/complex_matmul.cu).

PyTorch counterpart of circulantpreconditioner_tpu/ops/pallas_kernels.py
(`complex_matmul`, Pallas kernel `_cmm_kernel`):

    (o_re + i·o_im) = (a_re + i·a_im) @ (b_re + i·b_im),   (M, K) · (K, N).

`complex_matmul` launches K3 on a CUDA tensor and counts the launch in
`ComplexMatmulKernel.launches`; on a CPU tensor it runs K3's plain version,
`complex_matmul_reference` (four `torch.matmul`s). There is no fallback from
the kernel to the plain version: an operand the kernel cannot take raises.
The JAX wrapper's rule that M, N and K be multiples of 128 (a Mosaic tiling
rule, below which it falls back to plain dots) is dropped: K3 masks the
ragged edges itself.
"""

from __future__ import annotations

import torch

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
MAX_ROWS = 65535 * 64  # the launch grid's y extent times the 64-row tile


class ComplexMatmulKernel:
    """Launch count of K3: `complex_matmul_cuda` adds one per launch."""

    launches = 0


def complex_matmul_reference(a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor,
                             b_im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: o_re = a_re@b_re − a_im@b_im, o_im = a_re@b_im + a_im@b_re."""
    return a_re @ b_re - a_im @ b_im, a_re @ b_im + a_im @ b_re


def _check_kernel_inputs(a_re, a_im, b_re, b_im) -> None:
    if a_re.device.type != "cuda":
        raise ValueError(f"K3 needs CUDA tensors, got one on {a_re.device}")
    if a_re.dtype not in _DTYPE_CODE:
        raise ValueError(f"K3 computes in float32 or float64, got {a_re.dtype}")
    if a_re.ndim != 2 or b_re.ndim != 2:
        raise ValueError(f"K3 takes (M, K) and (K, N) matrices, got shapes "
                         f"{tuple(a_re.shape)} and {tuple(b_re.shape)}")
    M, K = a_re.shape
    K2, N = b_re.shape
    if K != K2:
        raise ValueError(f"K3: inner dimensions differ, {K} and {K2}")
    if min(M, N, K) == 0 or M > MAX_ROWS:
        raise ValueError(f"K3 takes 1 ≤ M ≤ {MAX_ROWS} and N, K ≥ 1, got M={M} N={N} K={K}")
    for name, t, shape in (("a_re", a_re, (M, K)), ("a_im", a_im, (M, K)),
                           ("b_re", b_re, (K, N)), ("b_im", b_im, (K, N))):
        if t.device != a_re.device:
            raise ValueError(f"K3: {name} is on {t.device}, a_re on {a_re.device}")
        if t.dtype != a_re.dtype:
            raise ValueError(f"K3: {name} is {t.dtype}, a_re is {a_re.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"K3: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"K3: {name} is not contiguous")


def complex_matmul_cuda(a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor,
                        b_im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on PyTorch's current stream; counts one launch."""
    from circulantpreconditioner_tpu_torch.native.build import load_library

    _check_kernel_inputs(a_re, a_im, b_re, b_im)
    lib = load_library()
    M, K = a_re.shape
    N = b_re.shape[1]
    o_re = torch.empty((M, N), device=a_re.device, dtype=a_re.dtype)
    o_im = torch.empty_like(o_re)
    stream = torch.cuda.current_stream(a_re.device).cuda_stream
    err = lib.k3_complex_matmul(a_re.data_ptr(), a_im.data_ptr(), b_re.data_ptr(),
                                b_im.data_ptr(), o_re.data_ptr(), o_im.data_ptr(), M, N, K,
                                _DTYPE_CODE[a_re.dtype], a_re.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err} "
                           f"({lib.k3_error_string(err).decode()})")
    ComplexMatmulKernel.launches += 1
    return o_re, o_im


def complex_matmul(a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor,
                   b_im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) · (K, N) complex product: K3 on a CUDA tensor, its plain
    version on a CPU tensor."""
    if a_re.device.type == "cpu":
        return complex_matmul_reference(a_re, a_im, b_re, b_im)
    return complex_matmul_cuda(a_re, a_im, b_re, b_im)
