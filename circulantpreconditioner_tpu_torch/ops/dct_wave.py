"""Wall-boundary (reflective) block direct solver for the wave system by
mixed DCT-II/DST-II transforms (PyTorch counterpart of
circulantpreconditioner_tpu/ops/dct_wave.py).

On a uniform cartesian grid with mirror walls the implicit upwind wave
operator I + D is exactly block-diagonalised by real transforms: the
pressure and the tangential velocities in DCT-II modes cos(πk(i+½)/n), the
axis-d normal velocity in DST-II modes sin(πm(i+½)/n) along axis d. Per
frequency t the operator couples (P, Q_d) through a real (dim+1)² block

    B(t) = C + Σ_d [ 2cosθ_d · S_d − σ_d(c) · 2sinθ_d · K_d ],   θ_d = π t_d / n_d,

with S_d and K_d the symmetric and antisymmetric halves of the ±e_d blocks of
`wave_block_stencil` and σ_d(c) = −1 iff component c is q_d. The blocks are
built and inverted once on the host; a solve is one batched matmul per axis
and direction plus one batched block contraction. The axis sweeps take the
precision tier through `tier_matmul` (ops/tier_matmul.py; K4 at "high" and
"default" on a CUDA float32 tensor, one launch per sweep, the per-component
transforms as K4's batch); the block contraction, small per-frequency
matvecs, stays fp32 in every tier.

The cosine family (n modes, k = 0..n−1) and the sine family (m = 1..n) share
one frequency axis of F = n + 1 slots. The JAX package rounds F up to a
multiple of 8, a TPU layout choice; its extra slots hold zero transform rows
whose inverse blocks are never read back, so `from_numpy_arrays` crops them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops.dft_matmul import _to
from circulantpreconditioner_tpu_torch.ops.tier_matmul import tier_matmul
from circulantpreconditioner_tpu_torch.utils.device import check_precision, check_real_dtype


def _freq_slots(n: int) -> int:
    """Frequency extent: the n cosine modes k = 0..n−1 and the n sine modes
    m = 1..n on one axis of n+1 slots."""
    return n + 1


def _np_cos_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """DCT-II forward (F, n) with a zero row n, and its left inverse (n, F)
    with a zero column n."""
    F = _freq_slots(n)
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    T = np.zeros((F, n))
    T[:n] = np.cos(np.pi * k * (i + 0.5) / n)
    I = np.zeros((n, F))
    I[:, :n] = np.linalg.inv(T[:n])
    return T, I


def _np_sin_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """DST-II forward (F, n) with modes m = 1..n in rows 1..n (row 0 zero),
    and its left inverse (n, F)."""
    F = _freq_slots(n)
    m = np.arange(1, n + 1)[:, None]
    i = np.arange(n)[None, :]
    T = np.zeros((F, n))
    T[1:n + 1] = np.sin(np.pi * m * (i + 0.5) / n)
    I = np.zeros((n, F))
    I[:, 1:n + 1] = np.linalg.inv(T[1:n + 1])
    return T, I


def _np_wall_block_tensor(shape_zyx, dim, dt, c0, spacing_xyz) -> np.ndarray:
    """Pre-inverted real frequency blocks, shape (*(F_a,), nb, nb); slot n_a
    has θ = π."""
    from circulantpreconditioner_tpu_torch.ops.assembly import wave_block_stencil

    ndim = len(shape_zyx)
    if ndim != dim:
        raise ValueError(f"grid rank {ndim} differs from dim {dim}")
    nb = dim + 1
    offsets, blocks = wave_block_stencil(dim, dt, c0, spacing_xyz)
    bmap = {tuple(off): blk for off, blk in zip(offsets, np.asarray(blocks))}
    C = bmap[(0,) * ndim]
    S, K = {}, {}
    for a in range(ndim):  # zyx axis position
        ep = tuple(1 if i == a else 0 for i in range(ndim))
        em = tuple(-1 if i == a else 0 for i in range(ndim))
        S[a] = 0.5 * (bmap[ep] + bmap[em])  # −λ|A|/2 (diffusive part)
        K[a] = 0.5 * (bmap[ep] - bmap[em])  # +λA/2 (advective part)
    # σ_a(c): −1 iff component c is the q of the xyz axis mapped to a
    sigma = np.ones((ndim, nb))
    for d in range(dim):
        sigma[ndim - 1 - d, 1 + d] = -1.0

    out_shape = tuple(_freq_slots(n) for n in shape_zyx)
    B = np.zeros(out_shape + (nb, nb))
    B[...] = C
    for a, n in enumerate(shape_zyx):
        F = out_shape[a]
        th = np.pi * np.arange(F) / n
        bshape = [1] * ndim
        bshape[a] = F
        cos2 = (2 * np.cos(th)).reshape(bshape + [1, 1])
        sin2 = (2 * np.sin(th)).reshape(bshape + [1, 1])
        B = B + cos2 * S[a] - sin2 * (K[a] * sigma[a][None, :])
    return np.linalg.inv(B)


class DCTBlockWaveSolver:
    """Exact direct solver for the wall-boundary cartesian wave operator
    I + D, all-real transforms. Companion to
    ops/dft_matmul.py::MatmulBlockCirculantSolver (the periodic variant)."""

    def __init__(self, shape_zyx, nb: int, arrays, precision: str = "high"):
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.nb = int(nb)
        self.arrays = arrays  # (inv_blocks (nb, nb, *F), per-axis (T, I) stacks)
        self.precision = check_precision(precision)

    @classmethod
    def create(cls, shape_zyx: Sequence[int], dim: int, dt: float, c0: float, spacing_xyz, *,
               device: torch.device, dtype: torch.dtype, precision: str = "high"):
        shape_zyx = tuple(int(v) for v in shape_zyx)
        ndim = len(shape_zyx)
        nb = dim + 1
        inv = _np_wall_block_tensor(shape_zyx, dim, dt, c0, spacing_xyz)
        # component axes leading (i, j, *grid), as the block contraction reads them
        inv = np.moveaxis(inv, (-2, -1), (0, 1))
        # per-axis per-component transform stacks (nb, F, n): component
        # 1 + (ndim − 1 − a) takes the sine family, the others the cosine one
        leaves = [inv]
        for a, n in enumerate(shape_zyx):
            Tc, Ic = _np_cos_mats(n)
            Ts, Is = _np_sin_mats(n)
            sin_comp = 1 + (ndim - 1 - a)
            leaves.append(np.stack([Ts if c == sin_comp else Tc for c in range(nb)]))
            leaves.append(np.stack([Is if c == sin_comp else Ic for c in range(nb)]))
        return cls.from_numpy_arrays(shape_zyx, nb, leaves, device=device, dtype=dtype,
                                     precision=precision)

    @classmethod
    def from_numpy_arrays(cls, shape_zyx, nb: int, arrays, *, device: torch.device,
                          dtype: torch.dtype, precision: str = "high"):
        """From the JAX solver's `arrays` flattened in order (its pytree
        leaves): inv_blocks, then (T, I) for each grid axis. Frequency slots
        beyond n_a + 1 per axis (the JAX package's 8-alignment) are cropped."""
        check_real_dtype(dtype)
        F = tuple(_freq_slots(int(n)) for n in shape_zyx)
        arrays = [np.asarray(a) for a in arrays]
        crop = [arrays[0][(slice(None),) * 2 + tuple(slice(f) for f in F)]]
        for a, f in enumerate(F):
            crop += [arrays[1 + 2 * a][:, :f, :], arrays[2 + 2 * a][:, :, :f]]
        t = [_to(a, device, dtype) for a in crop]
        mats = tuple((t[i], t[i + 1]) for i in range(1, len(t), 2))
        return cls(shape_zyx, nb, (t[0], mats), precision)

    @property
    def m(self) -> int:
        """Block size (the MatmulBlockCirculantSolver name)."""
        return self.nb

    def solve_fm(self, gb: torch.Tensor) -> torch.Tensor:
        """Field-major solve: gb (nb, *shape_zyx) → the same shape; real."""
        inv, mats = self.arrays
        ndim = len(self.shape_zyx)
        sub = "zyx"[3 - ndim:]

        def sweep(gb, a, fwd):
            T = mats[a][0 if fwd else 1]  # (nb, w, a): component c's transform T[c]
            return tier_matmul(gb, T.transpose(1, 2), self.precision, 1 + a)

        for a in range(ndim):
            gb = sweep(gb, a, fwd=True)
        gb = torch.einsum(f"ij{sub},j{sub}->i{sub}", inv, gb)  # fp32 in every tier
        for a in range(ndim):
            gb = sweep(gb, a, fwd=False)
        return gb

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """b shaped (*shape_zyx, nb) or flat (N·nb,) cell-major; real."""
        was_flat = b.ndim == 1
        g = b.reshape(self.shape_zyx + (self.nb,))
        x = torch.movedim(self.solve_fm(torch.movedim(g, -1, 0)), 0, -1)
        return x.reshape(-1) if was_flat else x

    def as_preconditioner(self):
        return self.solve
