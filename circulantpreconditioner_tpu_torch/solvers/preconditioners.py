"""Preconditioners M⁻¹ as plain callables (PyTorch counterpart of the Jacobi,
point-block Jacobi and composite parts of
circulantpreconditioner_tpu/solvers/preconditioners.py; ILU(0) and the
block-Jacobi ILU wait for ROADMAP.md, slice 2, item 17)."""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops.csr import BSRMatrix, CSRMatrix


def _diag_apply(dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return dinv * r


def jacobi(A: CSRMatrix):
    """Diagonal scaling M⁻¹ = diag(A)⁻¹ (rows with a zero diagonal keep 1)."""
    d = A.diagonal()
    dinv = torch.where(torch.abs(d) > 0, 1.0 / d, 1.0)
    return functools.partial(_diag_apply, dinv)


def _block_diag_apply(Dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.einsum("nij,nj->ni", Dinv, r.reshape(-1, Dinv.shape[-1])).reshape(-1)


def _inverted_diagonal_blocks(A: BSRMatrix, shift: float) -> np.ndarray:
    D = A.block_diagonal().cpu().numpy()  # (n_brows, b, b)
    if shift:
        D = D + shift * np.eye(A.block_size)[None, :, :]
    return np.linalg.inv(D)


def pbjacobi(A: BSRMatrix, shift: float = 0.0):
    """Point-block Jacobi (PETSc PCPBJACOBI): the (b×b) diagonal blocks are
    inverted once on the host; the apply is a batched small matvec.
    shift=1.0 preconditions I + A (the implicit FV systems)."""
    Dinv = _inverted_diagonal_blocks(A, shift)
    return functools.partial(_block_diag_apply, torch.as_tensor(Dinv).to(
        device=A.blocks.device, dtype=A.blocks.dtype))


def _block_diag_apply_fm(DinvT: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ijn,jn->in", DinvT, r.reshape(DinvT.shape[0], -1)).reshape(-1)


def pbjacobi_fm(A: BSRMatrix, shift: float = 0.0):
    """pbjacobi for field-major flat vectors (x.reshape(b, n) is the field
    view); the inverted blocks are stored (b, b, n)."""
    DinvT = np.ascontiguousarray(_inverted_diagonal_blocks(A, shift).transpose(1, 2, 0))
    return functools.partial(_block_diag_apply_fm, torch.as_tensor(DinvT).to(
        device=A.blocks.device, dtype=A.blocks.dtype))


def _cell_major_adapter_apply(apply_cm, m: int, r: torch.Tensor) -> torch.Tensor:
    z = apply_cm(r.reshape(m, -1).T.reshape(-1))
    return z.reshape(-1, m).T.reshape(-1)


def cell_major_adapter(apply_cm: Callable, m: int):
    """Wrap a cell-major preconditioner for field-major flat vectors: one
    (N,m)↔(m,N) relayout pair per apply."""
    return functools.partial(_cell_major_adapter_apply, apply_cm, int(m))


def _additive_apply(appliers, r):
    out = appliers[0](r)
    for M in appliers[1:]:
        out = out + M(r)
    return out


def additive(*appliers: Callable):
    """Additive combination M⁻¹ = Σ Mᵢ⁻¹ (PETSc PCCOMPOSITE ADDITIVE)."""
    return functools.partial(_additive_apply, tuple(appliers))


def _multiplicative_apply(A, coarse, smoother, r):
    z = coarse(r)
    return z + smoother(r - A(z))


def multiplicative(A: Callable, coarse: Callable, smoother: Callable):
    """Multiplicative two-level cycle z = Mc r; z += Ms (r − A z) (PETSc
    PCCOMPOSITE MULTIPLICATIVE)."""
    return functools.partial(_multiplicative_apply, A, coarse, smoother)
