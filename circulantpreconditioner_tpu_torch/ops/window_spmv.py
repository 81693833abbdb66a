"""Clustered-window dense SpMV (PyTorch counterpart of
circulantpreconditioner_tpu/ops/window_spmv.py).

The assembled block operator is re-laid so that an apply is a row gather
plus one batched matrix-vector product: G consecutive block rows form a
cluster, `unit` consecutive block columns a source unit, and each cluster
keeps the exact union of the U source units its rows touch as one dense
(G·b, U·unit·b) window matrix W (the sparse column structure becomes zero
entries). An apply gathers the U units per cluster and computes
y[c] = W[c] @ window[c]. The projection preconditioners of
solvers/circulant_pc.py take this form for their P and P_back
(`matvec_multi`, nb residual components through a scalar P).

The host build is the JAX package's, step for step, so W and the source
unit ids equal the JAX ones; there is no hand-written kernel here (the JAX
package has no Pallas kernel for it either).
"""

from __future__ import annotations

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.utils.device import check_real_dtype


class WindowedBlockOperator:
    """y = A x for a block matrix re-laid as per-cluster dense windows. x is
    the flat cell-major vector ((n_cells·b,), the layout BSRMatrix.matvec
    takes), or an (n_cells·b, m) multivector for `matvec_multi`."""

    def __init__(self, n_brows: int, b: int, G: int, unit: int, src: torch.Tensor,
                 W: torch.Tensor, n_bcols: int | None = None):
        self.n_brows = int(n_brows)
        self.b = int(b)
        self.G = int(G)
        self.unit = int(unit)
        self.src = src  # (ncl, U) int64: source unit ids per cluster
        self.W = W  # (ncl, G·b, U·unit·b) dense window matrices
        self.n_bcols = n_bcols  # None: square

    @property
    def shape(self) -> tuple[int, int]:
        nc = self.n_bcols if self.n_bcols is not None else self.n_brows
        return (self.n_brows * self.b, nc * self.b)

    @property
    def window_bytes(self) -> int:
        return self.W.numel() * self.W.element_size()

    @classmethod
    def from_block_coo(cls, n_brows: int, brows, bcols, blocks, G: int = 8,
                       unit: int | None = None, *, device: torch.device, dtype: torch.dtype,
                       n_bcols: int | None = None):
        """Build from block COO (duplicates summed), on the host. unit=None
        takes the smallest unit with ≥ 8 scalars per gathered row. n_bcols
        builds a rectangular operator (the projection matrices)."""
        check_real_dtype(dtype)
        brows = np.asarray(brows, dtype=np.int64)
        bcols = np.asarray(bcols, dtype=np.int64)
        blocks = np.asarray(blocks, dtype=np.float64)
        b = blocks.shape[-1]
        if unit is None:
            unit = max(1, -(-8 // b))
        ncl = -(-n_brows // G)

        order = np.argsort(brows // G, kind="stable")
        brows, bcols, blocks = brows[order], bcols[order], blocks[order]
        cl = brows // G
        ucols = bcols // unit
        starts = np.searchsorted(cl, np.arange(ncl + 1))

        unions = []
        U = 1
        for c in range(ncl):
            u = np.unique(ucols[starts[c]:starts[c + 1]])
            unions.append(u)
            U = max(U, len(u))

        src = np.zeros((ncl, U), dtype=np.int64)
        W = np.zeros((ncl, G * b, U * unit * b), dtype=np.float64)
        n_src = n_bcols if n_bcols is not None else n_brows
        nu_src = max(-(-n_src // unit), 1)
        for c in range(ncl):
            u = unions[c]
            src[c, :len(u)] = u
            # pad slots repeat u[0] (their W entries stay zero); a cluster
            # with no stored block points at its own first unit
            fill = u[0] if len(u) else min(c * G // unit, nu_src - 1)
            src[c, len(u):] = fill
            s, e = starts[c], starts[c + 1]
            r = (brows[s:e] - c * G) * b  # local row offset
            k = (np.searchsorted(u, ucols[s:e]) * unit + bcols[s:e] % unit) * b
            for i in range(b):
                for j in range(b):
                    np.add.at(W[c], (r + i, k + j), blocks[s:e, i, j])
        return cls(n_brows, b, G, unit, torch.as_tensor(src, device=device),
                   torch.as_tensor(W).to(device=device, dtype=dtype), n_bcols)

    @classmethod
    def from_bsr(cls, A, G: int = 8, unit: int | None = None, dtype: torch.dtype | None = None):
        rows, cols, blocks = A.coo_numpy()
        return cls.from_block_coo(A.n_brows, rows, cols, blocks, G=G, unit=unit,
                                  device=A.blocks.device, dtype=dtype or A.blocks.dtype)

    @classmethod
    def from_csr(cls, A, G: int = 8, unit: int | None = None, dtype: torch.dtype | None = None):
        """Scalar (b = 1) variant from a CSRMatrix (rectangular supported)."""
        sp = A.to_scipy().tocoo()
        n_rows, n_cols = A.shape
        return cls.from_block_coo(n_rows, sp.row, sp.col, sp.data.reshape(-1, 1, 1), G=G,
                                  unit=unit, device=A.data.device, dtype=dtype or A.data.dtype,
                                  n_bcols=None if n_cols == n_rows else n_cols)

    def _gather_windows(self, x: torch.Tensor) -> torch.Tensor:
        """(ncl, U·unit·b[, m]) source windows from x ((n_src·b,) or (n_src·b, m))."""
        n_src = self.n_bcols if self.n_bcols is not None else self.n_brows
        ncl = self.src.shape[0]
        nu = -(-n_src // self.unit)
        pad = nu * self.unit * self.b - n_src * self.b
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        xv = x.reshape((nu, self.unit * self.b) + tuple(x.shape[1:]))
        return xv[self.src].reshape((ncl, -1) + tuple(x.shape[1:]))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_brows * self.b
        win = self._gather_windows(x)
        y = torch.bmm(self.W, win.unsqueeze(-1)).squeeze(-1)
        # output rows are padded to whole clusters; the pad rows of W are zero
        return y.reshape(-1)[:n]

    def matvec_multi(self, x: torch.Tensor) -> torch.Tensor:
        """y = A X for a multivector x (n_src·b, m) → (n_rows·b, m)."""
        n = self.n_brows * self.b
        y = torch.bmm(self.W, self._gather_windows(x))
        return y.reshape(-1, x.shape[1])[:n]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)
