"""The precision tiers' products, and kernel K4: the split-bf16 product,
hand-written in CUDA C++ for Hopper (csrc/tier_matmul.cu).

`tier_matmul(a, b, precision, axis)` is the one entry point for every
product that the JAX package computes with `precision=`: it contracts axis
`axis` of the tensor a with the (K, N) matrix b, the axis replaced by N,

    out[..., n, ...] = Σ_k a[..., k, ...] · b[k, n],

or, with b shaped (B, K, N), one matrix per index of a's leading axis (the
DCT sweeps' per-component transforms). With a 2D and axis −1 it is a @ b.
What it computes follows the tier table (utils/device.py `TIER_FORMS`): on a
CUDA float32 tensor "high" runs K4 in three bf16 passes, "default" in one,
and "highest" a full fp32 product; on the CPU, and in float64, every tier is
a full-precision product (XLA's CPU backend ignores the tier too).

K4 computes the bf16 forms of the JAX package's Pallas kernel
(circulantpreconditioner_tpu/ops/fused_circulant.py::_mk_ops) and of XLA's
Precision.HIGH and DEFAULT on the TPU's matrix unit: each operand split into
hi = bf16(a), rounded to nearest even, and lo = bf16(a − hi), then
lo·hi + hi·lo + hi·hi ("high") or hi·hi ("default") summed in fp32.
`tier_matmul_kernel` launches K4 on a CUDA tensor and counts the launch in
`TierMatmulKernel.launches`; on a CPU tensor it runs K4's plain version,
`tier_matmul_reference`, which splits by `.to(torch.bfloat16)` and runs
three fp32 products in `_mk_ops`' order (each product of two bf16 values is
exact in fp32, so it is `_mk_ops`' arithmetic up to the order of the sums).
There is no fallback from the kernel to the plain version: an operand the
kernel cannot take raises. K4 reads a strided view of a without a copy where
the dimensions before and after the axis each collapse to one stride (every
call of the solvers); another view is copied first.

b is a constant at every call site. K4 takes it split once (`split_words`:
the bf16 hi and lo bits of b, laid out as a block of K4 holds them in shared
memory), and `tier_matmul_cuda` keeps the split beside the b tensor it was
made from (a weak reference to b's base tensor, made anew when b changes in
place; a split made during a CUDA-graph capture is captured, not kept). The
split rounds as the kernel would, so the numbers are those of a split in the
kernel.
"""

from __future__ import annotations

import math

import torch
from torch.utils.weak import WeakIdKeyDictionary

from circulantpreconditioner_tpu_torch.utils.device import check_precision, tier_form

PASSES = {"high": 3, "default": 1}  # bf16 passes of K4 per tier
MAX_BATCH = 65535  # K4's launch grid's z extent
TBN, KC, WC = 128, 128, 2  # K4's column tile, depth chunk, warps along the columns


class TierMatmulKernel:
    """Launch count of K4: `tier_matmul_cuda` adds one per launch."""

    launches = 0


def _axis(a: torch.Tensor, b: torch.Tensor, axis: int) -> int:
    if b.ndim not in (2, 3):
        raise ValueError(f"b must be (K, N) or (B, K, N), got shape {tuple(b.shape)}")
    axis = axis % a.ndim
    if b.ndim == 3 and (axis == 0 or a.shape[0] != b.shape[0]):
        raise ValueError(f"a per-batch b {tuple(b.shape)} needs a's leading axis of "
                         f"{b.shape[0]} and another axis to contract, got a "
                         f"{tuple(a.shape)}, axis {axis}")
    if a.shape[axis] != b.shape[-2]:
        raise ValueError(f"a's axis {axis} has {a.shape[axis]} entries, b's rows "
                         f"{b.shape[-2]}")
    return axis


def contract(a: torch.Tensor, b: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The full-precision product of `tier_matmul` (one einsum)."""
    axis = _axis(a, b, axis)
    idx = "abcdefghijklm"[:a.ndim]
    out = idx[:axis] + "z" + idx[axis + 1:]
    b_idx = (idx[0] if b.ndim == 3 else "") + idx[axis] + "z"
    return torch.einsum(f"{idx},{b_idx}->{out}", a, b)


def bf16_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (bf16(x), bf16(x − hi)) as float32, rounded to nearest even,
    as the JAX package's `astype(jnp.bfloat16)`."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def tier_matmul_reference(a: torch.Tensor, b: torch.Tensor, precision: str,
                          axis: int = -1) -> torch.Tensor:
    """Plain version of K4 (and of tier `precision` wherever it runs): "high"
    as hi·hi + lo·hi + hi·lo, "default" as hi·hi, "highest" as one product."""
    check_precision(precision)
    if precision == "highest":
        return contract(a, b, axis)
    (ah, al), (bh, bl) = bf16_split(a), bf16_split(b)
    if precision == "default":
        return contract(ah, bh, axis)
    return contract(ah, bh, axis) + contract(al, bh, axis) + contract(ah, bl, axis)


def b_layout(K: int, N: int) -> tuple[int, int, int, int]:
    """K4's split layout of a (K, N) matrix: (NP rows per column tile, column
    tiles, K chunks, S words per row) as csrc/tier_matmul.cu reads it."""
    nt = -(-(-(-min(N, TBN) // 8)) // WC)  # n8 tiles per warp
    return nt * WC * 8, -(-N // TBN), -(-K // KC), -(-min(K, KC) // 16) * 8 + 4


def split_words(b: torch.Tensor) -> torch.Tensor:
    """b (K, N) or (B, K, N), float32 → K4's split: int32 words shaped
    (B or 1, column tile, K chunk, plane hi/lo, NP, S); word w of row n in
    chunk c holds the bf16 bits of b[k, n] (low half) and b[k + 1, n], k =
    128·c + 2w, zero beyond K and N."""
    bb = b if b.ndim == 3 else b[None]
    nb, K, N = bb.shape
    NP, nct, nkc, S = b_layout(K, N)
    kw = (KC if nkc > 1 else -(-K // 16) * 16) // 2  # words of a chunk's row before padding
    t = torch.zeros((nb, nct * NP, nkc * kw * 2), device=b.device, dtype=torch.float32)
    t[:, :N, :K] = bb.transpose(1, 2)
    planes = []
    for x in bf16_split(t):
        bits = x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
        w = bits[..., 0::2] | (bits[..., 1::2] << 16)
        planes.append(torch.where(w >= 2**31, w - 2**32, w).to(torch.int32))
    w = torch.stack(planes, 1).reshape(nb, 2, nct, NP, nkc, kw)
    w = torch.nn.functional.pad(w, (0, S - kw))
    return w.permute(0, 2, 4, 1, 3, 5).contiguous()


# b's base tensor → {(shape, strides, offset): (version, split)}
_SPLITS: WeakIdKeyDictionary = WeakIdKeyDictionary()


def _split_of(b: torch.Tensor) -> torch.Tensor:
    """split_words(b), made once per constant (see the module docstring)."""
    root = b if b._base is None else b._base
    key = (tuple(b.shape), b.stride(), b.storage_offset())
    held = _SPLITS.get(root, {})
    if key in held and held[key][0] == b._version:
        return held[key][1]
    words = split_words(b)
    if not torch.cuda.is_current_stream_capturing():
        _SPLITS[root] = {**held, key: (b._version, words)}
    return words


def _collapse(shape, strides) -> tuple[int, int] | None:
    """(size, stride) of dimensions that flatten to one stride, else None."""
    dims = [(n, s) for n, s in zip(shape, strides) if n != 1]
    for (_, s), (n2, s2) in zip(dims, dims[1:]):
        if s != s2 * n2:
            return None
    return math.prod(shape), (dims[-1][1] if dims else 0)


def _views(a: torch.Tensor, axis: int, batched: bool):
    """(batch, P, K, Q) sizes and (batch, P, K, Q) strides of a for K4, or
    None where P's or Q's dimensions do not flatten to one stride."""
    lead = 1 if batched else 0
    p = _collapse(a.shape[lead:axis], a.stride()[lead:axis])
    q = _collapse(a.shape[axis + 1:], a.stride()[axis + 1:])
    if p is None or q is None:
        return None
    nb, sb = (a.shape[0], a.stride(0)) if batched else (1, 0)
    return (nb, p[0], a.shape[axis], q[0]), (sb, p[1], a.stride(axis), q[1])


def _check_kernel_inputs(a: torch.Tensor, b: torch.Tensor, precision: str) -> None:
    if precision not in PASSES:
        raise ValueError(f"K4 runs the tiers {sorted(PASSES)}, got {precision!r}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"K4 computes in float32, got {a.dtype} and {b.dtype}")
    if a.device.type != "cuda":
        raise ValueError(f"K4 needs CUDA tensors, got one on {a.device}")
    if b.device != a.device:
        raise ValueError(f"K4: b is on {b.device}, a on {a.device}")


def tier_matmul_cuda(a: torch.Tensor, b: torch.Tensor, precision: str,
                     axis: int = -1) -> torch.Tensor:
    """Launch K4 on PyTorch's current stream; counts one launch."""
    from circulantpreconditioner_tpu_torch.native.build import load_library

    _check_kernel_inputs(a, b, precision)
    axis = _axis(a, b, axis)
    batched = b.ndim == 3
    if batched and b.shape[0] > MAX_BATCH:
        raise ValueError(f"K4 takes at most {MAX_BATCH} matrices, got {b.shape[0]}")
    views = _views(a, axis, batched)
    if views is None:
        a = a.contiguous()
        views = _views(a, axis, batched)
    (nb, P, K, Q), (sab, sap, sak, saq) = views
    N = b.shape[-1]
    out = torch.empty(a.shape[:axis] + (N,) + a.shape[axis + 1:], device=a.device,
                      dtype=a.dtype)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    lib = load_library()
    words = _split_of(b)
    if words.shape[-1] != lib.k4_row_words(K):
        raise RuntimeError(f"K4's split layout of B ({words.shape[-1]} words per row) differs "
                           f"from the kernel's ({lib.k4_row_words(K)})")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.k4_tier_matmul(a.data_ptr(), words.data_ptr(), out.data_ptr(), nb, P, K, Q, N,
                             sab, sap, sak, saq, int(not batched), PASSES[precision],
                             a.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {err} "
                           f"({lib.k4_error_string(err).decode()})")
    TierMatmulKernel.launches += 1
    return out


def tier_matmul_kernel(a: torch.Tensor, b: torch.Tensor, precision: str,
                       axis: int = -1) -> torch.Tensor:
    """K4 at tier "high" or "default": the kernel on a CUDA tensor, its plain
    version on a CPU tensor."""
    if a.device.type == "cpu":
        if precision not in PASSES:
            raise ValueError(f"K4 runs the tiers {sorted(PASSES)}, got {precision!r}")
        return tier_matmul_reference(a, b, precision, axis)
    return tier_matmul_cuda(a, b, precision, axis)


def tier_matmul(a: torch.Tensor, b: torch.Tensor, precision: str,
                axis: int = -1) -> torch.Tensor:
    """Axis `axis` of a contracted with b at tier `precision`, in the form
    the tier table gives a's device and dtype (see the module docstring)."""
    if tier_form(a.device, a.dtype, precision) in ("full", "fp32"):
        return contract(a, b, axis)
    return tier_matmul_kernel(a, b, precision, axis)
