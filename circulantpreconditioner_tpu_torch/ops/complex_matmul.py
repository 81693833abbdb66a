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

Arithmetic. In float32, K3 runs on the tensor cores in 3×TF32: every operand
x is split into x_hi = tf32(x) and x_lo = tf32(x − x_hi), TF32 being float32
rounded to nearest (ties away from zero) at 10 mantissa bits, and each real
product is a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, summed in float32: the 12
products of each 8-deep step on the tensor cores, the steps' sums in float32
rounded to nearest (csrc/complex_matmul.cu says why). Its error against
float64 is that of a float32 product (about 4e-7 · max|o| at the staged
solver's shapes); one TF32 pass would err by about 2.5e-4. The TPU kernel ran
one bf16 pass. `complex_matmul_tf32x3_emulation` repeats this arithmetic on
the CPU for the tests, with every sum rounded to nearest; no path of the
solver calls it. In float64, K3 runs on the CUDA cores in full float64.
"""

from __future__ import annotations

import torch

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
MAX_ROWS = 65535 * 64  # the float64 launch grid's y extent times its 64-row tile


class ComplexMatmulKernel:
    """Launch count of K3: `complex_matmul_cuda` adds one per launch."""

    launches = 0


def complex_matmul_reference(a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor,
                             b_im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: o_re = a_re@b_re − a_im@b_im, o_im = a_re@b_im + a_im@b_re."""
    return a_re @ b_re - a_im @ b_im, a_re @ b_im + a_im @ b_re


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32, as cvt.rna.tf32.f32 does: round to nearest at 10
    mantissa bits, ties away from zero, by integer arithmetic on the bits
    (the 13 low bits of the result are zero)."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000  # add half of the dropped 13 bits' range to |x|
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32).reshape(x.shape)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_hi, x_lo) = (tf32(x), tf32(x − x_hi)): x_hi + x_lo equals x to about
    2⁻²² relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def complex_matmul_tf32x3_emulation(a_re: torch.Tensor, a_im: torch.Tensor,
                                    b_re: torch.Tensor, b_im: torch.Tensor,
                                    terms: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's float32 arithmetic on the CPU: each real product as
    a_hi·b_hi + a_hi·b_lo + a_lo·b_hi (terms=3) or a_hi·b_hi alone (terms=1,
    one TF32 pass), each term a float32 matmul of TF32 values (their
    products are exact in float32)."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    (arh, arl), (aih, ail) = tf32_split(a_re), tf32_split(a_im)
    (brh, brl), (bih, bil) = tf32_split(b_re), tf32_split(b_im)

    def prod(ah, al, bh, bl):
        return ah @ bh if terms == 1 else ah @ bh + ah @ bl + al @ bh

    return (prod(arh, arl, brh, brl) - prod(aih, ail, bih, bil),
            prod(arh, arl, bih, bil) + prod(aih, ail, brh, brl))


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
