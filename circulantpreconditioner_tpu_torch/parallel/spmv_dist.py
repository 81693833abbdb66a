"""Row-partitioned distributed SpMV over a rank mesh (PyTorch counterpart of
circulantpreconditioner_tpu/parallel/spmv_dist.py): PETSc's MPI row-block
Mat/Vec layout (MatCreateAIJ with PETSC_DECIDE, and the VecScatter halo
exchange inside MatMult).

Rows are split into P contiguous blocks, padded to equal size; each rank
holds its block of rows in padded-ELL form and its block of every vector.
`ShardedELLMatrix` all-gathers the source vector; `HaloELLMatrix` exchanges
only the w entries each neighbour's rows reach (bandwidth w ≤ one block).
Padded tail rows are all zero, so they stay zero and never pollute a dot
product. `shard_vector` gives this rank's block of a global vector;
`unshard_vector` gathers the whole vector to every rank (the JAX package's
np.asarray of a sharded array).
"""

from __future__ import annotations

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix
from circulantpreconditioner_tpu_torch.parallel.mesh_utils import RankMesh, shard_on_axis


def pad_rows(cols: np.ndarray, vals: np.ndarray, n_padded: int):
    """ELL tables with zero rows appended up to n_padded."""
    pad = n_padded - cols.shape[0]
    if pad:
        cols = np.concatenate([cols, np.zeros((pad, cols.shape[1]), cols.dtype)])
        vals = np.concatenate([vals, np.zeros((pad, vals.shape[1]), vals.dtype)])
    return cols, vals


def host_ell(A: CSRMatrix) -> tuple[np.ndarray, np.ndarray]:
    """A's ELL tables (cols, vals) as host arrays."""
    ell = A.to_ell()
    return ell.cols.cpu().numpy(), ell.vals.cpu().numpy()


class _RowSharded:
    """The vector layout of the row-sharded operators: n_padded = P · block
    rows, rank r holding rows [r·block, (r+1)·block)."""

    mesh: RankMesh
    axis: str
    n: int
    n_padded: int
    dtype: torch.dtype

    def shard_vector(self, x) -> torch.Tensor:
        """This rank's block of a global length-n vector, zero-padded to n_padded."""
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if x.shape[0] != self.n_padded:
            x = torch.cat([x, x.new_zeros(self.n_padded - x.shape[0])])
        return shard_on_axis(x, self.mesh, self.axis, 0, self.dtype)

    def unshard_vector(self, x: torch.Tensor) -> torch.Tensor:
        """The global length-n vector, on every rank."""
        return self.mesh.all_gather(x, self.axis)[: self.n]

    def __matmul__(self, x):
        return self.matvec(x)


class ShardedELLMatrix(_RowSharded):
    """Row-sharded padded-ELL operator: y = A x, each rank all-gathering x."""

    def __init__(self, A: CSRMatrix, mesh: RankMesh, axis: str = "shard",
                 row_multiple: int = 1):
        self.mesh = mesh
        self.axis = axis
        self.dtype = A.data.dtype
        n, _ = A.shape
        Pn = mesh.shape[axis]
        self.n = n
        # pad so each rank's row count is a multiple of row_multiple (lets
        # per-rank block preconditioners reshape (-1, b))
        q = Pn * max(int(row_multiple), 1)
        self.n_padded = ((n + q - 1) // q) * q
        cols, vals = pad_rows(*host_ell(A), self.n_padded)
        self.cols = shard_on_axis(cols, mesh, axis, 0)
        self.vals = shard_on_axis(vals, mesh, axis, 0, self.dtype)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x: this rank's block → this rank's block of A x."""
        x_full = self.mesh.all_gather(x, self.axis)
        return (self.vals * x_full[self.cols]).sum(dim=1)


class HaloELLMatrix(_RowSharded):
    """Row-sharded SpMV with a nearest-neighbour halo exchange: the PETSc
    VecScatter ghost update inside MatMult. Needs the bandwidth
    w = max|col − row| within one row block (a lexicographically ordered FV
    mesh cut into slabs: w ≈ nx·ny ≤ N/P); a block is grown up to twice its
    size to fit w, beyond which the constructor raises ValueError (use
    ShardedELLMatrix). Each rank then takes the last w entries of its left
    neighbour and the first w of its right one; column indices are
    localised to that extended window on the host. The wrap around the
    ring is zeroed at both ends of the row range."""

    def __init__(self, A: CSRMatrix, mesh: RankMesh, axis: str = "shard",
                 row_multiple: int = 1):
        self.mesh = mesh
        self.axis = axis
        self.dtype = A.data.dtype
        n, _ = A.shape
        Pn = mesh.shape[axis]
        self.n = n
        rm = max(int(row_multiple), 1)
        B = ((n + Pn * rm - 1) // (Pn * rm)) * rm
        cols, vals = host_ell(A)
        active = vals != 0.0
        band = np.abs(cols - np.arange(n)[:, None])[active]
        w = int(band.max()) if band.size else 0
        if w > B:
            # grow the row block (extra zero padding) so that a one-neighbour
            # exchange still serves bandwidths a little above a block
            B_fit = ((w + rm - 1) // rm) * rm
            if B_fit > 2 * B:
                raise ValueError(f"bandwidth {w} exceeds 2x row-block {B}; use ShardedELLMatrix")
            B = B_fit
        self.n_padded = B * Pn
        self.block = B
        self.halo = w
        cols, vals = pad_rows(cols, vals, self.n_padded)
        # localise: rank p sees the window [p·B − w, (p+1)·B + w)
        shard_of_row = np.arange(self.n_padded) // B
        local_cols = cols - (shard_of_row[:, None] * B - w)
        # inactive (padding) entries may fall outside the window: point them at 0
        local_cols = np.where(vals != 0.0, local_cols, 0)
        assert (local_cols >= 0).all() and (local_cols < B + 2 * w).all()
        self.cols = shard_on_axis(local_cols, mesh, axis, 0)
        self.vals = shard_on_axis(vals, mesh, axis, 0, self.dtype)
        r = mesh.coords[axis]
        self._zero_left, self._zero_right = r == 0, r == Pn - 1

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        w = self.halo
        from_left, from_right = self.mesh.ring_exchange(x[x.shape[0] - w:], x[:w], self.axis)
        # zero the wrap-around contributions at the global ends
        if self._zero_left:
            from_left = torch.zeros_like(from_left)
        if self._zero_right:
            from_right = torch.zeros_like(from_right)
        x_ext = torch.cat([from_left, x, from_right])
        return (self.vals * x_ext[self.cols]).sum(dim=1)
