"""One coarse level of the grid V-cycle in three sweeps: kernel K5,
hand-written in CUDA C++ for Hopper (csrc/vcycle_sweep.cu).

A V(1,1) visit of a `GridVCyclePC` level below the fine one
(solvers/aggregation_pc.py) is, on field-major flat vectors of the level's
m fields over its N sites:

- `smooth_cuda`: z = ω·Dinv·r;
- `restrict_cuda`: rc = cnt_inv·Σ_box (r − A z), the next level's right-hand
  side;
- `sweep_cuda`: z' = z + P zc, then z' + ω·Dinv·(r − A z'); without zc one
  more smoothing step z + ω·Dinv·(r − A z).

A is the level's `VaryingStencilOperator` in the flat layout; every vector,
the next level's included, is field-major. The plain versions, with the same
stage boundaries, are the stage functions of solvers/aggregation_pc.py,
which run them on CPU tensors; there is no
fallback from the kernel to them on the card. Each launch counts in
`VCycleSweepKernel.launches`. The JAX package has no Pallas kernel here:
XLA fuses its jnp V-cycle.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
MAX_M = 8
MAX_OFFSETS = 7


def takes(stencil, dtype: torch.dtype) -> bool:
    """True when K5 can run a level whose operator is `stencil` in `dtype`:
    a 3D flat-layout `VaryingStencilOperator` of m ≤ 8 with at most 7
    offsets, whose coefficients are float32 or float64 in that dtype."""
    return (getattr(stencil, "layout", None) == "flat" and len(stencil.shape_zyx) == 3
            and stencil.m <= MAX_M and len(stencil.offsets) <= MAX_OFFSETS
            and dtype in _DTYPE_CODE and stencil.coefs[0].dtype == dtype)


class VCycleSweepKernel:
    """The launch counter of K5 (utils/graphs.kernel_launches)."""

    launches = 0


def _n_sites(stencil) -> int:
    nz, ny, nx = stencil.shape_zyx
    return nz * ny * nx


def _check(x: torch.Tensor, name: str, numel: int, like: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"K5 needs CUDA tensors, {name} is on {x.device}")
    if x.device != like.device:
        raise ValueError(f"K5: {name} is on {x.device}, r on {like.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K5 computes in float32 or float64, {name} is {x.dtype}")
    if x.dtype != like.dtype:
        raise ValueError(f"K5: {name} is {x.dtype}, r is {like.dtype}")
    if x.numel() != numel:
        raise ValueError(f"K5: {name} has {x.numel()} values, expected {numel}")
    if not x.is_contiguous():
        raise ValueError(f"K5: {name} is not contiguous")


def _check_stencil(stencil, r: torch.Tensor) -> None:
    if not takes(stencil, r.dtype):
        raise ValueError("K5 takes a 3D flat-layout varying stencil of m ≤ 8 with at most "
                         f"7 offsets in the dtype of r ({r.dtype})")
    m, N = stencil.m, _n_sites(stencil)
    for k, C in enumerate(stencil.coefs):
        _check(C, f"coefs[{k}]", m * m * N, r)


def _grid(stencil, cshape_xyz) -> ctypes.Array:
    nz, ny, nx = stencil.shape_zyx
    cx, cy, cz = (int(v) for v in cshape_xyz)
    if (cx, cy, cz) != (-(-nx // 2), -(-ny // 2), -(-nz // 2)):
        raise ValueError(f"K5: the next level's grid {(cx, cy, cz)} is not the 2×2×2 boxes "
                         f"of {(nx, ny, nz)}")
    return (ctypes.c_int * 6)(nx, ny, nz, cx, cy, cz)


def _stencil_args(stencil) -> tuple:
    K = len(stencil.offsets)
    coefs = (ctypes.c_void_p * K)(*(C.data_ptr() for C in stencil.coefs))
    offsets = (ctypes.c_longlong * K)(*(int(o) for o in stencil.offsets))
    return coefs, offsets, K


def _launched(lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"K5 launch failed: cudaError {err} "
                           f"({lib.k5_error_string(err).decode()})")
    VCycleSweepKernel.launches += 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def smooth_cuda(Dinv: torch.Tensor, r: torch.Tensor, omega: float) -> torch.Tensor:
    """z = ω·Dinv·r on the field-major flat r (m·N values), Dinv (N, m, m);
    one launch."""
    from circulantpreconditioner_tpu_torch.native.build import load_library

    N, m = Dinv.shape[0], Dinv.shape[-1]
    _check(r, "r", m * N, r)
    _check(Dinv, "Dinv", N * m * m, r)
    lib = load_library()
    z = torch.empty_like(r)
    _launched(lib, lib.k5_smooth(r.data_ptr(), Dinv.data_ptr(), z.data_ptr(), N, m,
                                 float(omega), _DTYPE_CODE[r.dtype], r.device.index or 0,
                                 _stream(r)))
    return z


def restrict_cuda(stencil, cnt_inv: torch.Tensor, cshape_xyz, r: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """rc = cnt_inv·Σ_box (r − A z) on the next level's grid, (m, Nc)
    field-major flat; one launch."""
    from circulantpreconditioner_tpu_torch.native.build import load_library

    m, N = stencil.m, _n_sites(stencil)
    grid = _grid(stencil, cshape_xyz)
    Nc = grid[3] * grid[4] * grid[5]
    _check(r, "r", m * N, r)
    _check(z, "z", m * N, r)
    _check(cnt_inv, "cnt_inv", Nc, r)
    _check_stencil(stencil, r)
    lib = load_library()
    coefs, offsets, K = _stencil_args(stencil)
    rc = torch.empty(m * Nc, dtype=r.dtype, device=r.device)
    _launched(lib, lib.k5_restrict(r.data_ptr(), z.data_ptr(), coefs, offsets, K,
                                   cnt_inv.data_ptr(), rc.data_ptr(), grid, m,
                                   _DTYPE_CODE[r.dtype], r.device.index or 0, _stream(r)))
    return rc


def sweep_cuda(stencil, Dinv: torch.Tensor, cshape_xyz, omega: float, r: torch.Tensor,
               z: torch.Tensor, zc: torch.Tensor | None = None) -> torch.Tensor:
    """z' = z + P zc (no prolongation when zc is None), then
    z' + ω·Dinv·(r − A z'); one launch into a new tensor."""
    from circulantpreconditioner_tpu_torch.native.build import load_library

    m, N = stencil.m, _n_sites(stencil)
    grid = _grid(stencil, cshape_xyz)
    Nc = grid[3] * grid[4] * grid[5]
    _check(r, "r", m * N, r)
    _check(z, "z", m * N, r)
    _check(Dinv, "Dinv", N * m * m, r)
    if zc is not None:
        _check(zc, "zc", m * Nc, r)
    _check_stencil(stencil, r)
    lib = load_library()
    coefs, offsets, K = _stencil_args(stencil)
    out = torch.empty_like(r)
    _launched(lib, lib.k5_sweep(r.data_ptr(), z.data_ptr(), None if zc is None else zc.data_ptr(),
                                coefs, offsets, K, Dinv.data_ptr(), out.data_ptr(), grid, m,
                                float(omega), _DTYPE_CODE[r.dtype],
                                r.device.index or 0, _stream(r)))
    return out
