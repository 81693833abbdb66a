"""Point-block Jacobi on field-major vectors: kernel K6, hand-written in CUDA
C++ for Hopper (csrc/block_jacobi.cu).

    out = zn + ω·Dinv·(r − y)        (zn, y optional: absent reads as 0)

in one launch, on field-major flat vectors of g cells a site and b ≤ 8
fields a cell: x.reshape(g·b, S) is the field view, cell g·s + k owning rows
k·b … k·b + b−1 of column s (g = 1: x.reshape(b, N)). Dinv is read where its
caller keeps it, in one of two layouts:

- "cell": (g·S, b, b), cell g·s + k's block (the grid V-cycle's
  `_block_diag_inv`, on the hex fine level and a tet mesh's site level);
- "field": (g, b, b, S), or (b, b, S) when g = 1 (`pbjacobi_fm`).

`run` is the dispatch the call sites share: K6 on a CUDA tensor, which
raises on what it cannot take (b > 8, a dtype other than float32 and
float64, Dinv in another dtype than r: `refusal`), and the site's own plain
version (its einsum) on the CPU. `utils.graphs.STATS` counts the applies K6
ran (`block_jacobi_fused`) and those that took the plain version
(`block_jacobi_plain`); each launch counts in `BlockJacobiKernel.launches`.
The JAX package has no Pallas kernel here: XLA runs its einsum.
"""

from __future__ import annotations

from typing import Callable

import torch

from circulantpreconditioner_tpu_torch.utils.graphs import STATS

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_LAYOUT_CODE = {"cell": 0, "field": 1}
MAX_B = 8


class BlockJacobiKernel:
    """The launch counter of K6 (utils/graphs.kernel_launches)."""

    launches = 0


def block_size(Dinv: torch.Tensor, layout: str) -> int:
    """b, the fields a cell, of a Dinv in `layout`."""
    return Dinv.shape[-1] if layout == "cell" else Dinv.shape[-2]


def refusal(b: int, dtype: torch.dtype, dinv_dtype: torch.dtype) -> str | None:
    """Why K6 cannot take a block size and the dtypes of r and Dinv; None when
    it can."""
    if b > MAX_B:
        return f"K6 takes b ≤ {MAX_B} fields a cell, got b = {b}"
    if dtype not in _DTYPE_CODE:
        return f"K6 computes in float32 or float64, r is {dtype}"
    if dinv_dtype != dtype:
        return f"K6: Dinv is {dinv_dtype}, r is {dtype}"
    return None


def run(plain: Callable[[torch.Tensor], torch.Tensor], Dinv: torch.Tensor, layout: str, g: int,
        omega: float, r: torch.Tensor, zn: torch.Tensor | None = None,
        y: torch.Tensor | None = None) -> torch.Tensor:
    """zn + ω·Dinv·(r − y): K6 on a CUDA tensor, zn + plain(r − y) on the
    CPU, `plain` the call site's ω·Dinv·v."""
    if r.is_cuda:
        out = apply_cuda(Dinv, layout, g, omega, r, zn, y)
        STATS.block_jacobi_fused += 1
        return out
    STATS.block_jacobi_plain += 1
    z = plain(r if y is None else r - y)
    return z if zn is None else zn + z


def _check(x: torch.Tensor, name: str, numel: int, like: torch.Tensor) -> None:
    if x.dtype != like.dtype:
        raise ValueError(f"K6: {name} is {x.dtype}, r is {like.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"K6 needs CUDA tensors, {name} is on {x.device}")
    if x.device != like.device:
        raise ValueError(f"K6: {name} is on {x.device}, r on {like.device}")
    if x.numel() != numel:
        raise ValueError(f"K6: {name} has {x.numel()} values, expected {numel}")
    if not x.is_contiguous():
        raise ValueError(f"K6: {name} is not contiguous")


def apply_cuda(Dinv: torch.Tensor, layout: str, g: int, omega: float, r: torch.Tensor,
               zn: torch.Tensor | None = None, y: torch.Tensor | None = None) -> torch.Tensor:
    """zn + ω·Dinv·(r − y) by K6, one launch into a new tensor; raises on
    what it cannot take."""
    from circulantpreconditioner_tpu_torch.native.build import load_library

    if layout not in _LAYOUT_CODE:
        raise ValueError(f"K6: layout is 'cell' or 'field', got {layout!r}")
    b, g = block_size(Dinv, layout), int(g)
    why = refusal(b, r.dtype, Dinv.dtype)
    if why:
        raise ValueError(why)
    if g < 1 or r.numel() % (g * b):
        raise ValueError(f"K6: r's {r.numel()} values are not g·b = {g * b} rows")
    S = r.numel() // (g * b)
    _check(r, "r", g * b * S, r)
    _check(Dinv, "Dinv", g * S * b * b, r)
    for x, name in ((zn, "zn"), (y, "y")):
        if x is not None:
            _check(x, name, r.numel(), r)
    lib = load_library()
    out = torch.empty_like(r)
    err = lib.k6_block_jacobi(r.data_ptr(), None if y is None else y.data_ptr(),
                              None if zn is None else zn.data_ptr(), Dinv.data_ptr(),
                              out.data_ptr(), S, g, b, _LAYOUT_CODE[layout], float(omega),
                              _DTYPE_CODE[r.dtype], r.device.index or 0,
                              torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: cudaError {err} "
                           f"({lib.k6_error_string(err).decode()})")
    BlockJacobiKernel.launches += 1
    return out
