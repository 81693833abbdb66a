"""Axis elision and dense spectral collapse for circulant solves (PyTorch
counterpart of circulantpreconditioner_tpu/ops/spectral_collapse.py).

Λ(k) = 1 + Σᵢ λᵢ·ĉ(kᵢ) does not depend on the frequencies of axes with
λᵢ = 0, so their DFTs cancel exactly:
- one nonzero λ: C⁻¹ is ONE real n×n matrix M = Re(F⁻¹·diag(1/Λ₁d)·F) applied
  along that axis (built in float64 on the host);
- some zero λs: the staged solver skips the zero z/y axes;
- all λ = 0: C = I.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops.circulant import np_eigenvalue_diagonal
from circulantpreconditioner_tpu_torch.ops.dft_matmul import MatmulCirculantSolver, _to
from circulantpreconditioner_tpu_torch.ops.tier_matmul import tier_matmul
from circulantpreconditioner_tpu_torch.utils.device import check_precision, check_real_dtype
from circulantpreconditioner_tpu_torch.utils.profiling import device_span


class IdentitySolver:
    """C = I (all λ zero): the solve is a no-op."""

    def __init__(self, shape_zyx):
        self.shape_zyx = tuple(int(v) for v in shape_zyx)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return b

    def as_preconditioner(self):
        return self.solve


class DenseCirculantSolver:
    """Single-nonzero-axis circulant solve as one dense matmul along that
    axis: x = M·b with M = Re(F⁻¹ diag(1/Λ₁d) F) precomputed in float64, at
    the precision tier (`tier_matmul`: one K4 launch per solve at "high" and
    "default" on a CUDA float32 tensor; M is read through its transpose's
    strides, no copy), inside the device span "port.pc.circulant"."""

    def __init__(self, shape_zyx, axis: int, arrays, precision: str = "highest"):
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.axis = int(axis)  # index into shape_zyx of the transformed axis
        self.arrays = arrays  # (M,) — (n, n) real, rows = output index
        self.precision = check_precision(precision)

    @classmethod
    def create(cls, shape_zyx: Sequence[int], lambdas_zyx: Sequence[float], *,
               device: torch.device, dtype: torch.dtype, precision: str = "highest"):
        shape_zyx = tuple(int(v) for v in shape_zyx)
        nonzero = [i for i, l in enumerate(lambdas_zyx) if float(l) != 0.0]
        if len(nonzero) != 1:
            raise ValueError("DenseCirculantSolver needs exactly one nonzero λ; "
                             f"got {lambdas_zyx}")
        axis = nonzero[0]
        n = shape_zyx[axis]
        lam1 = np_eigenvalue_diagonal((n,), (float(lambdas_zyx[axis]),), rfft=False)
        k = np.arange(n)
        W = np.exp(-2j * np.pi * np.outer(k, k) / n)
        Winv = np.exp(2j * np.pi * np.outer(k, k) / n) / n
        M = Winv @ np.diag(1.0 / lam1) @ W
        # C is real ⇒ so is its inverse; the imaginary residue is fp noise
        if np.abs(M.imag).max() >= 1e-12 * max(1.0, np.abs(M.real).max()):
            raise ArithmeticError("dense circulant inverse is not real")
        return cls.from_numpy_arrays(shape_zyx, axis, [M.real], device=device, dtype=dtype,
                                     precision=precision)

    @classmethod
    def from_numpy_arrays(cls, shape_zyx, axis: int, arrays, *, device: torch.device,
                          dtype: torch.dtype, precision: str = "highest"):
        """From the JAX solver's `arrays` as numpy: [M]."""
        check_real_dtype(dtype)
        return cls(shape_zyx, axis, (_to(arrays[0], device, dtype),), precision)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        was_flat = b.ndim == 1
        g = b.reshape(self.shape_zyx)
        (M,) = self.arrays
        with device_span("port.pc.circulant", b.device):
            x = tier_matmul(g, M.T, self.precision, self.axis)
        return x.reshape(-1) if was_flat else x

    def as_preconditioner(self):
        return self.solve


def make_circulant_solver(shape_zyx: Sequence[int], lambdas_zyx: Sequence[float], *,
                          device: torch.device, dtype: torch.dtype,
                          precision: str = "highest", elide_zero_axes: bool = True,
                          fused: bool = False):
    """Pick the exact formulation of C⁻¹ for this λ pattern (same dispatch as
    the JAX factory). elide_zero_axes=False forces the full multi-axis DFT
    pipeline; fused=True takes the fused 3D kernel for the all-axes case."""
    check_real_dtype(dtype)
    lambdas = tuple(float(l) for l in lambdas_zyx)
    shape = tuple(int(v) for v in shape_zyx)
    nonzero = [i for i, l in enumerate(lambdas) if l != 0.0]
    if elide_zero_axes and not nonzero:
        return IdentitySolver(shape)
    if elide_zero_axes and len(nonzero) == 1:
        return DenseCirculantSolver.create(shape, lambdas, device=device, dtype=dtype,
                                           precision=precision)
    if fused and len(shape) == 3:
        from circulantpreconditioner_tpu_torch.ops.fused_circulant import FusedCirculantSolver

        return FusedCirculantSolver.create(shape, lambdas, device=device, dtype=dtype,
                                           precision=precision)
    # λx = 0 with several other axes nonzero still runs the x transform
    # (the rfft axis carries the real↔complex boundary); only z/y elide.
    return MatmulCirculantSolver.create(shape, lambdas, device=device, dtype=dtype,
                                        precision=precision,
                                        elide_zero_axes=elide_zero_axes)
