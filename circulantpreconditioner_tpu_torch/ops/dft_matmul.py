"""Circulant solve as staged DFT-by-matmul (PyTorch counterpart of
circulantpreconditioner_tpu/ops/dft_matmul.py).

For the x axis the half-spectrum transform is used:
    X[k] = Σ_j u[j] W^{jk},  W = e^{−2πi/nx},  k = 0..nx//2,
packed as (re, im) planes; y and z use full complex DFT matrices. The inverse
x transform back to real uses the hermitian weights w_k (1 for k = 0 and for
k = nx/2 when nx is even, else 2):
    u[j] = (1/nx) Σ_k w_k [re[k] cos(2πjk/nx) − im[k] sin(2πjk/nx)].
All tables are built in float64 on the host and cast once.

Precision tiers. The JAX package names three tiers after the TPU's matrix
unit: "highest" (float32, six bf16 passes), "high" (bf16x3, about 16 mantissa
bits) and "default" (one bf16 pass, 8 bits). Every axis transform of the
einsum route is a `tier_matmul` (ops/tier_matmul.py): on a CUDA float32
tensor "high" and "default" run kernel K4 (three and one bf16 passes, the
TPU's arithmetic) and "highest" full fp32; on the CPU and in float64 every
tier is full precision, as XLA's CPU backend computes it (the table is
utils/device.py `TIER_FORMS`). The per-frequency m × m block products of
`MatmulBlockCirculantSolver` stay fp32 in every tier: they are small batched
matvecs that K4's tiles do not fit.

`use_kernel=True` sends the complex y and z stages through kernel K3
(ops/complex_matmul.py): each stage collapses the spectrum to (rows, n), as
the JAX code does, and takes one K3 launch, so a 3D solve with no elided axis
launches K3 four times. In float32 K3 computes in 3×TF32 on the tensor cores
in every tier, as accurate as float32 (about 4e-7 · max|o| against float64 at
n = 100 and 128); the JAX kernel route ran one bf16 pass whatever the tier.
The x stages take the tier through K4 on this route too.
`MatmulBlockCirculantSolver` is the block-circulant (m × m blocks, the
periodic wave system) companion.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops.circulant import (
    BlockCirculantOperator,
    CirculantTransportOperator,
    np_eigenvalue_diagonal,
)
from circulantpreconditioner_tpu_torch.ops.complex_matmul import complex_matmul
from circulantpreconditioner_tpu_torch.ops.tier_matmul import tier_matmul
from circulantpreconditioner_tpu_torch.utils.device import check_precision, check_real_dtype


def _np_dft_mats(n: int):
    k = np.arange(n)
    W = np.exp(-2j * np.pi * np.outer(k, k) / n)
    Winv = np.exp(2j * np.pi * np.outer(k, k) / n) / n
    return W.real, W.imag, Winv.real, Winv.imag


def _np_rdft_mats(n: int):
    nr = n // 2 + 1
    j = np.arange(n)
    k = np.arange(nr)
    ang = -2 * np.pi * np.outer(j, k) / n
    F_re = np.cos(ang)  # (n, nr)
    F_im = np.sin(ang)
    w = np.full(nr, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    angi = 2 * np.pi * np.outer(k, j) / n
    B_re = (w[:, None] * np.cos(angi)) / n  # (nr, n): u = re@B_re + im@B_im
    B_im = (-w[:, None] * np.sin(angi)) / n
    return F_re, F_im, B_re, B_im


def _to(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float64)).to(device=device, dtype=dtype)


def _axis_cdft(re, im, C, S, axis, precision, kernel=False):
    """Complex DFT along `axis` by matmul: (re + i·im) ← (re + i·im)·(C + i·S),
    four `tier_matmul`s at `precision`. kernel=True moves the axis last,
    collapses to (rows, n) and takes one complex_matmul (K3 on a CUDA tensor),
    then undoes the collapse."""
    if kernel:
        n = re.shape[axis]
        rm, im_m = torch.movedim(re, axis, -1), torch.movedim(im, axis, -1)
        lead = rm.shape[:-1]
        o_re, o_im = complex_matmul(rm.reshape(-1, n).contiguous(),
                                    im_m.reshape(-1, n).contiguous(), C, S)
        k = o_re.shape[-1]
        return (torch.movedim(o_re.reshape(lead + (k,)), -1, axis),
                torch.movedim(o_im.reshape(lead + (k,)), -1, axis))
    mm = lambda x, M: tier_matmul(x, M, precision, axis)  # noqa: E731
    return mm(re, C) - mm(im, S), mm(re, S) + mm(im, C)


class MatmulCirculantSolver:
    """x = C⁻¹ b for real b with every transform as a dense matmul; up to 3D,
    axis order zyx. `axes` lists the z/y axes actually transformed (positions
    in shape_zyx[:-1]); axes with λ = 0 may be elided exactly. use_kernel:
    the complex y/z stages through complex_matmul (K3 on the GPU)."""

    def __init__(self, shape_zyx, arrays, precision: str = "highest",
                 axes: tuple[int, ...] | None = None, use_kernel: bool = False):
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.arrays = arrays  # (inv_re, inv_im, F_re, F_im, B_re, B_im, mats)
        self.precision = check_precision(precision)
        self.axes = tuple(axes) if axes is not None else tuple(range(len(arrays[-1])))
        self.use_kernel = bool(use_kernel)

    @classmethod
    def create(cls, shape_zyx: Sequence[int], lambdas_zyx: Sequence[float], *,
               device: torch.device, dtype: torch.dtype, precision: str = "highest",
               elide_zero_axes: bool = False, use_kernel: bool = False):
        check_real_dtype(dtype)
        shape_zyx = tuple(int(v) for v in shape_zyx)
        lam = np_eigenvalue_diagonal(shape_zyx, lambdas_zyx, rfft=True)
        den = lam.real**2 + lam.imag**2
        leaves = [lam.real / den, -lam.imag / den, *_np_rdft_mats(shape_zyx[-1])]
        axes = []
        for i, n in enumerate(shape_zyx[:-1]):
            if elide_zero_axes and float(lambdas_zyx[i]) == 0.0:
                continue  # exact: Λ does not depend on this axis's frequency
            leaves.extend(_np_dft_mats(n))
            axes.append(i)
        return cls.from_numpy_arrays(shape_zyx, leaves, device=device, dtype=dtype,
                                     precision=precision, axes=tuple(axes),
                                     use_kernel=use_kernel)

    @classmethod
    def from_numpy_arrays(cls, shape_zyx, arrays, *, device: torch.device,
                          dtype: torch.dtype, precision: str = "highest",
                          axes: tuple[int, ...] | None = None, use_kernel: bool = False):
        """From the JAX solver's `arrays` flattened in order (its pytree
        leaves): inv_re, inv_im, F_re, F_im, B_re, B_im, then (C, S, Ci, Si)
        for each transformed z/y axis."""
        check_real_dtype(dtype)
        t = [_to(a, device, dtype) for a in arrays]
        mats = tuple(tuple(t[i:i + 4]) for i in range(6, len(t), 4))
        return cls(shape_zyx, (*t[:6], mats), precision, axes, use_kernel)

    @classmethod
    def from_operator(cls, op: CirculantTransportOperator, precision: str = "highest"):
        return cls.create(op.shape_zyx, op.lambdas_zyx, device=op.device, dtype=op.dtype,
                          precision=precision)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = C⁻¹ b for real b shaped (*shape_zyx) or flat."""
        was_flat = b.ndim == 1
        g = b.reshape(self.shape_zyx)
        inv_re, inv_im, F_re, F_im, B_re, B_im, mats = self.arrays
        mm = lambda x, M: tier_matmul(x, M, self.precision)  # noqa: E731  (along x)
        re, im = mm(g, F_re), mm(g, F_im)
        for ax_i, (C, S, _, _) in zip(self.axes, mats):
            re, im = _axis_cdft(re, im, C, S, ax_i, self.precision, self.use_kernel)
        re, im = re * inv_re - im * inv_im, re * inv_im + im * inv_re
        for ax_i, (_, _, Ci, Si) in zip(self.axes, mats):
            re, im = _axis_cdft(re, im, Ci, Si, ax_i, self.precision, self.use_kernel)
        x = mm(re, B_re) + mm(im, B_im)
        return x.reshape(-1) if was_flat else x

    def as_preconditioner(self):
        return self.solve


class MatmulBlockCirculantSolver:
    """Block-circulant direct solver ((m × m) blocks: the periodic wave
    system) with every DFT axis as a dense matmul and the pre-inverted
    half-spectrum block symbol applied as a batched complex matvec. Companion
    to ops/circulant.py::BlockCirculantOperator, which uses torch.fft."""

    def __init__(self, shape_zyx, m: int, arrays, precision: str = "highest"):
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.m = int(m)
        self.arrays = arrays  # (inv_re, inv_im, F_re, F_im, B_re, B_im, mats)
        self.precision = check_precision(precision)

    @classmethod
    def from_stencil(cls, shape_zyx: Sequence[int], offsets, blocks, *,
                     device: torch.device, dtype: torch.dtype, precision: str = "highest"):
        shape_zyx = tuple(int(v) for v in shape_zyx)
        m = np.asarray(blocks).shape[-1]
        sym = BlockCirculantOperator.np_symbol(shape_zyx, offsets, blocks)
        sym = sym[..., :shape_zyx[-1] // 2 + 1, :, :]  # hermitian symmetry: half x-spectrum
        inv = np.linalg.inv(sym)
        leaves = [inv.real, inv.imag, *_np_rdft_mats(shape_zyx[-1])]
        for n in shape_zyx[:-1]:
            leaves.extend(_np_dft_mats(n))
        return cls.from_numpy_arrays(shape_zyx, m, leaves, device=device, dtype=dtype,
                                     precision=precision)

    @classmethod
    def from_numpy_arrays(cls, shape_zyx, m: int, arrays, *, device: torch.device,
                          dtype: torch.dtype, precision: str = "highest"):
        """From the JAX solver's `arrays` flattened in order (its pytree
        leaves): inv_re, inv_im, F_re, F_im, B_re, B_im, then (C, S, Ci, Si)
        for each z/y axis."""
        check_real_dtype(dtype)
        t = [_to(a, device, dtype) for a in arrays]
        mats = tuple(tuple(t[i:i + 4]) for i in range(6, len(t), 4))
        return cls(shape_zyx, m, (*t[:6], mats), precision)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """b flat cell-major (N·m,) or shaped (*shape_zyx, m); real."""
        was_flat = b.ndim == 1
        g = b.reshape(self.shape_zyx + (self.m,))
        inv_re, inv_im, F_re, F_im, B_re, B_im, mats = self.arrays
        x_ax = len(self.shape_zyx) - 1  # the x axis, before the block axis m
        mm = lambda x, M: tier_matmul(x, M, self.precision, x_ax)  # noqa: E731
        re, im = mm(g, F_re), mm(g, F_im)  # the x-axis half-spectrum forward
        for ax_i, (C, S, _, _) in enumerate(mats):
            re, im = _axis_cdft(re, im, C, S, ax_i, self.precision)
        blk = lambda M, v: torch.einsum("...ij,...j->...i", M, v)  # noqa: E731  (fp32)
        re, im = (blk(inv_re, re) - blk(inv_im, im), blk(inv_re, im) + blk(inv_im, re))
        for ax_i, (_, _, Ci, Si) in enumerate(mats):
            re, im = _axis_cdft(re, im, Ci, Si, ax_i, self.precision)
        x = mm(re, B_re) + mm(im, B_im)
        return x.reshape(-1) if was_flat else x

    def as_preconditioner(self):
        return self.solve
