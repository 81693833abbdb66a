"""CSR and block-CSR sparse matrices with gather + segment-sum SpMV (PyTorch
counterparts of CSRMatrix and BSRMatrix in circulantpreconditioner_tpu/ops/
csr.py), and the padded-ELL form the distributed SpMVs shard
(parallel/spmv_dist.py). Assembly stays on the host in NumPy; duplicate COO
entries are summed (ADD_VALUES semantics)."""

from __future__ import annotations

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.utils.device import check_real_dtype


def coo_to_csr_arrays(n_rows: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """Sum-duplicate COO → sorted CSR arrays (host-side, NumPy)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows):
        key = rows * (cols.max() + 1 if len(cols) else 1) + cols
        uniq_mask = np.empty(len(key), dtype=bool)
        uniq_mask[0] = True
        np.not_equal(key[1:], key[:-1], out=uniq_mask[1:])
        idx = np.cumsum(uniq_mask) - 1
        out_vals = np.zeros(int(idx[-1]) + 1, dtype=vals.dtype)
        np.add.at(out_vals, idx, vals)
        rows, cols, vals = rows[uniq_mask], cols[uniq_mask], out_vals
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, cols, vals


class CSRMatrix:
    """Compressed-sparse-row matrix with device-resident arrays."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
                 shape: tuple[int, int], row_ids: torch.Tensor):
        self.indptr = indptr  # (n_rows+1,) int64
        self.indices = indices  # (nnz,) int64
        self.data = data  # (nnz,)
        self.shape = (int(shape[0]), int(shape[1]))
        self.row_ids = row_ids  # (nnz,) int64: row of each stored entry

    @classmethod
    def from_coo(cls, n_rows: int, n_cols: int, rows, cols, vals, *,
                 device: torch.device, dtype: torch.dtype):
        check_real_dtype(dtype)
        indptr, indices, data = coo_to_csr_arrays(n_rows, rows, cols, vals)
        row_ids = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        as_i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        return cls(as_i(indptr), as_i(indices),
                   torch.as_tensor(np.asarray(data, dtype=np.float64)).to(device=device,
                                                                          dtype=dtype),
                   (n_rows, n_cols), as_i(row_ids))

    @classmethod
    def from_scipy(cls, A, *, device: torch.device, dtype: torch.dtype):
        check_real_dtype(dtype)
        A = A.tocsr()
        row_ids = np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))
        as_i = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
        return cls(as_i(A.indptr), as_i(A.indices),
                   torch.as_tensor(np.asarray(A.data, dtype=np.float64)).to(device=device,
                                                                            dtype=dtype),
                   tuple(A.shape), as_i(row_ids))

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.data.cpu().numpy(), self.indices.cpu().numpy(),
                              self.indptr.cpu().numpy()), shape=self.shape)

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x via gather + index_add (segment sum). x may be (n,) or
        (n, k): the columns are transformed independently."""
        gathered = x[self.indices]
        contrib = self.data[:, None] * gathered if x.ndim == 2 else self.data * gathered
        y = torch.zeros((self.shape[0],) + tuple(x.shape[1:]), dtype=contrib.dtype,
                        device=contrib.device)
        return y.index_add_(0, self.row_ids, contrib)

    def diagonal(self) -> torch.Tensor:
        """diag(A) (for Jacobi PCs); rows lacking a stored diagonal get 0."""
        vals = torch.where(self.row_ids == self.indices, self.data, 0.0)
        y = torch.zeros(self.shape[0], dtype=self.data.dtype, device=self.data.device)
        return y.index_add_(0, self.row_ids, vals)

    def to_ell(self) -> "ELLMatrix":
        """Padded-ELL form, built on the host: row r's stored entries in CSR
        order, then zero-valued padding with column 0 up to the longest row."""
        indptr = self.indptr.cpu().numpy()
        n = self.shape[0]
        deg = np.diff(indptr)
        k = int(deg.max()) if n else 0
        rows = self.row_ids.cpu().numpy()
        pos = np.arange(len(rows)) - indptr[rows]  # place of each entry in its row
        cols = np.zeros((n, k), dtype=np.int64)
        vals = np.zeros((n, k), dtype=np.float64)
        cols[rows, pos] = self.indices.cpu().numpy()
        vals[rows, pos] = self.data.cpu().double().numpy()
        dev = self.data.device
        return ELLMatrix(torch.as_tensor(cols, device=dev),
                         torch.as_tensor(vals).to(device=dev, dtype=self.data.dtype),
                         self.shape)


class ELLMatrix:
    """Padded ELLPACK: (n_rows, k) column and value tables, zero-padded, so
    that y[r] = Σ_k vals[r, k] · x[cols[r, k]] is one regular gather."""

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor, shape: tuple[int, int]):
        self.cols = cols  # (n_rows, k) int64, padded with 0
        self.vals = vals  # (n_rows, k), padded with 0.0
        self.shape = (int(shape[0]), int(shape[1]))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return (self.vals * x[self.cols]).sum(dim=1)


def _sum_blocks(idx: np.ndarray, blocks: np.ndarray, n_out: int) -> np.ndarray:
    """out[k] = Σ_{idx[i] = k} blocks[i] for (n, b, b) blocks: one bincount
    per block entry, which sums in input order like np.add.at and runs far
    faster than it on millions of blocks."""
    b = blocks.shape[-1]
    out = np.empty((n_out, b, b), dtype=np.float64)
    for i in range(b):
        for j in range(b):
            out[:, i, j] = np.bincount(idx, weights=blocks[:, i, j], minlength=n_out)
    return out


class BSRMatrix:
    """Block-CSR with dense (b×b) blocks: the wave system's (dim+1)-blocks.

    Unknowns are cell-major interleaved (cell j owns rows j·b … j·b+b−1),
    as in the reference (WaveSystem.cxx addValue, :78-90)."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor, blocks: torch.Tensor,
                 shape: tuple[int, int], brow_ids: torch.Tensor):
        self.indptr = indptr  # (n_brows+1,) int64: block rows
        self.indices = indices  # (nblocks,) int64: block columns
        self.blocks = blocks  # (nblocks, b, b)
        self.shape = (int(shape[0]), int(shape[1]))  # scalar shape
        self.brow_ids = brow_ids  # (nblocks,) int64: block row of each block

    @classmethod
    def from_block_coo(cls, n_brows: int, n_bcols: int, brows, bcols, blocks, *,
                       device: torch.device, dtype: torch.dtype):
        """Duplicate (brow, bcol) blocks are summed (ADD_VALUES semantics)."""
        check_real_dtype(dtype)
        brows = np.asarray(brows, dtype=np.int64)
        bcols = np.asarray(bcols, dtype=np.int64)
        blocks = np.asarray(blocks, dtype=np.float64)
        b = blocks.shape[-1]
        order = np.lexsort((bcols, brows))
        brows, bcols, blocks = brows[order], bcols[order], blocks[order]
        if len(brows):
            key = brows * n_bcols + bcols
            uniq = np.empty(len(key), dtype=bool)
            uniq[0] = True
            np.not_equal(key[1:], key[:-1], out=uniq[1:])
            idx = np.cumsum(uniq) - 1
            blocks = _sum_blocks(idx, blocks, int(idx[-1]) + 1)
            brows, bcols = brows[uniq], bcols[uniq]
        indptr = np.zeros(n_brows + 1, dtype=np.int64)
        np.add.at(indptr, brows + 1, 1)
        indptr = np.cumsum(indptr)
        brow_ids = np.repeat(np.arange(n_brows, dtype=np.int64), np.diff(indptr))
        as_i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        return cls(as_i(indptr), as_i(bcols),
                   torch.as_tensor(blocks).to(device=device, dtype=dtype),
                   (n_brows * b, n_bcols * b), as_i(brow_ids))

    @property
    def block_size(self) -> int:
        return int(self.blocks.shape[-1])

    @property
    def n_brows(self) -> int:
        return int(self.indptr.shape[0]) - 1

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x, x flat cell-major (n_bcols·b,)."""
        b = self.block_size
        gathered = x.reshape(-1, b)[self.indices]  # (nblocks, b)
        contrib = torch.einsum("nij,nj->ni", self.blocks, gathered)
        yb = torch.zeros((self.n_brows, b), dtype=contrib.dtype, device=contrib.device)
        return yb.index_add_(0, self.brow_ids, contrib).reshape(-1)

    def block_diagonal(self) -> torch.Tensor:
        """(n_brows, b, b) diagonal blocks (for point-block Jacobi)."""
        is_diag = (self.brow_ids == self.indices)[:, None, None]
        sel = torch.where(is_diag, self.blocks, 0.0)
        out = torch.zeros((self.n_brows,) + tuple(self.blocks.shape[1:]),
                          dtype=self.blocks.dtype, device=self.blocks.device)
        return out.index_add_(0, self.brow_ids, sel)

    def coo_numpy(self):
        """(block rows, block columns, blocks) as host arrays."""
        return (self.brow_ids.cpu().numpy(), self.indices.cpu().numpy(),
                self.blocks.cpu().numpy())

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.bsr_matrix((self.blocks.cpu().numpy(), self.indices.cpu().numpy(),
                              self.indptr.cpu().numpy()), shape=self.shape).tocsr()

    def to_csr(self, dtype: torch.dtype | None = None) -> CSRMatrix:
        return CSRMatrix.from_scipy(self.to_scipy(), device=self.blocks.device,
                                    dtype=dtype or self.blocks.dtype)

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()
