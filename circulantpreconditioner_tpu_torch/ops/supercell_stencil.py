"""The wave normal form of the supercell SpMV: kernel K7, hand-written in CUDA
C++ for Hopper (csrc/supercell_stencil.cu).

`apply(op, x)` is y = D x for a `SupercellNormalOperator` (ops/stencil.py,
the tet meshes' 6 cells a grid site) on field-major x, (M, N) or flat
(M·N,), returning the same shape. On a CUDA tensor it launches K7 (one
thread per cell and site, the tables streamed once, one write of y) and
counts the apply in `utils.graphs.STATS.supercell_fused` and the launch in
`SupercellStencilKernel.launches`; on a CPU tensor it runs K7's plain
version, `SupercellNormalOperator.plain_fm` (`STATS.supercell_plain`, which
also counts the block-sparse SupercellStencilOperator's applies). There is no
fallback from the kernel to the plain version: `supercell_stencil_cuda`
raises on what K7 cannot take (a CPU tensor, a dtype other than float32 and
float64, a shape or table that is not the operator's, a tensor that is not
contiguous, and a table beyond the 3-D tet split's: m = 4 fields a cell, at
most 6 cells a site and 4 face slots a cell). The JAX package has no Pallas kernel here: its supercell
stencil is jnp.
"""

from __future__ import annotations

import torch

from circulantpreconditioner_tpu_torch.utils.graphs import STATS

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
FIELDS = 4  # m = dim + 1, dim = 3
MAX_CELLS = 6  # g, cells a site: the 6 tets of a hex
MAX_SLOTS = 4  # F, face slots a cell: a tet's 4 faces


class SupercellStencilKernel:
    """The launch counter of K7 (utils/graphs.kernel_launches)."""

    launches = 0


def apply(op, x: torch.Tensor) -> torch.Tensor:
    """y = D x: K7 on a CUDA tensor, the plain version on the CPU."""
    if x.numel() != op.M * op.N:
        raise ValueError(f"K7: input has {x.numel()} values, the operator takes "
                         f"M·N = {op.M}·{op.N}")
    g2 = x.reshape(op.M, op.N)
    if g2.is_cuda:
        out = supercell_stencil_cuda(op, g2)
        STATS.supercell_fused += 1
    else:
        out = op.plain_fm(g2)
        STATS.supercell_plain += 1
    return out.reshape(x.shape)


def _check_kernel_inputs(op, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K7 computes in float32 or float64, got {x.dtype}")
    g, m, F, N = op.g, op.m, op.F, op.N
    if m != FIELDS or g > MAX_CELLS or F > MAX_SLOTS:
        raise ValueError(f"K7 takes {FIELDS} fields a cell, at most {MAX_CELLS} cells a site "
                         f"and {MAX_SLOTS} slots a cell; the operator has {m}, {g} and {F}")
    if any(not -N < o < N for r in op.slot_offset for o in r) or any(
            not 0 <= c < g for r in op.slot_col for c in r):
        raise ValueError("K7: a slot's offset lies outside (-N, N) or its cell outside [0, g)")
    expected = ((g * m, N), (g, m, m, N), (g, F, N), (g, F, m - 1, N), (2, g, F))
    for name, t, shape in zip(("x", "diag", "s", "nvec", "table"), (x, *op.arrays, op.table),
                              expected):
        if tuple(t.shape) != shape:
            raise ValueError(f"K7: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device.type != "cuda":
            raise ValueError(f"K7 needs CUDA tensors, {name} is on {t.device}")
        if t.device != x.device:
            raise ValueError(f"K7: {name} is on {t.device}, x on {x.device}")
        want = torch.int32 if name == "table" else x.dtype
        if t.dtype != want:
            raise ValueError(f"K7: {name} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"K7: {name} is not contiguous")


def supercell_stencil_cuda(op, x: torch.Tensor) -> torch.Tensor:
    """Launch K7 on x (M, N) on PyTorch's current stream; counts one launch."""
    from circulantpreconditioner_tpu_torch.native.build import load_library

    _check_kernel_inputs(op, x)
    lib = load_library()
    diag, s, nvec = op.arrays
    out = torch.empty_like(x)
    err = lib.k7_supercell_stencil(x.data_ptr(), diag.data_ptr(), s.data_ptr(), nvec.data_ptr(),
                                   op.table.data_ptr(), out.data_ptr(), op.N, op.g, op.m - 1,
                                   op.F, op.c0, _DTYPE_CODE[x.dtype], x.device.index or 0,
                                   torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K7 launch failed: cudaError {err} "
                           f"({lib.k7_error_string(err).decode()})")
    SupercellStencilKernel.launches += 1
    return out
