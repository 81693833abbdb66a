"""Row-sharded clustered-window SpMV with a halo exchange (PyTorch counterpart
of circulantpreconditioner_tpu/parallel/window_dist.py): the distributed
unstructured MatMult for the RCM-ordered tet meshes.

ops/window_spmv.WindowedBlockOperator re-lays an RCM-ordered operator as
per-cluster dense windows over exact source-unit unions. This module shards
it as HaloELLMatrix shards the assembled operator (PETSc's row-block layout
and VecScatter ghost update):

- clusters are split into P contiguous blocks; each rank holds its
  (Bc, G·b, U·unit·b) windows and its (Bc, U) source-unit table;
- after RCM the units a rank's clusters reference lie within wu units of its
  own range, so an apply exchanges wu unit-rows with each neighbour, never
  the whole vector;
- the local apply is the single-device operator's gather and batched
  matrix-vector product, on the halo-extended window.
"""

from __future__ import annotations

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator
from circulantpreconditioner_tpu_torch.parallel.mesh_utils import RankMesh, shard_on_axis
from circulantpreconditioner_tpu_torch.parallel.spmv_dist import _RowSharded


class HaloWindowOperator(_RowSharded):
    """y = A x, row-sharded, for a WindowedBlockOperator-form matrix. Raises
    ValueError when the unit halo exceeds a rank's block of units (RCM
    bandwidth too large for a one-neighbour exchange: use ShardedELLMatrix)."""

    def __init__(self, W: WindowedBlockOperator, mesh: RankMesh, axis: str = "shard"):
        self.mesh = mesh
        self.axis = axis
        self.dtype = W.W.dtype
        Pn = mesh.shape[axis]
        b, G, unit = W.b, W.G, W.unit
        if G % unit:
            raise ValueError("G must be a multiple of unit for aligned shards")
        src = W.src.cpu().numpy()
        Wmat = W.W.cpu().numpy()
        ncl = src.shape[0]
        self.n = W.n_brows * b

        # pad clusters so each rank owns Bc of them (the extra clusters have
        # zero windows, and their src points at their OWN first unit, so the
        # padding never widens the halo)
        Bc = -(-ncl // Pn)
        upc = G // unit  # units per cluster
        pad = Bc * Pn - ncl
        if pad:
            own_first = (np.arange(ncl, ncl + pad) * upc)[:, None]
            src = np.concatenate([src, np.broadcast_to(own_first, (pad, src.shape[1]))
                                  .astype(src.dtype)])
            Wmat = np.concatenate([Wmat, np.zeros((pad,) + Wmat.shape[1:], Wmat.dtype)])
        Bu = Bc * upc  # units per rank
        self.n_units = Bc * Pn * upc
        self.n_padded = self.n_units * unit * b
        self.block_rows = Bc * G * b  # scalar rows per rank
        self._Bu, self._ub = Bu, unit * b

        # halo width in units: how far any referenced unit strays from the
        # owning rank's unit range
        own = np.repeat(np.arange(Pn), Bc)[:, None]  # the rank of each cluster
        lo = own * Bu
        hi = lo + Bu
        wu = int(max(np.maximum(lo - src, 0).max(initial=0),
                     np.maximum(src - (hi - 1), 0).max(initial=0)))
        if wu > Bu:
            raise ValueError(f"unit halo {wu} exceeds device block {Bu}; RCM bandwidth too "
                             "large for one-neighbour exchange — use ShardedELLMatrix")
        self.halo_units = wu
        # localise: rank p sees the unit window [p·Bu − wu, p·Bu + Bu + wu)
        src_loc = src - (own * Bu - wu)
        assert (src_loc >= 0).all() and (src_loc < Bu + 2 * wu).all()
        self.src = shard_on_axis(src_loc, mesh, axis, 0)
        self.W = shard_on_axis(Wmat, mesh, axis, 0)
        r = mesh.coords[axis]
        self._zero_left, self._zero_right = r == 0, r == Pn - 1

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        wu = self.halo_units
        xu = x.reshape(self._Bu, self._ub)
        from_left, from_right = self.mesh.ring_exchange(xu[self._Bu - wu:], xu[:wu], self.axis)
        if self._zero_left:
            from_left = torch.zeros_like(from_left)
        if self._zero_right:
            from_right = torch.zeros_like(from_right)
        x_ext = torch.cat([from_left, xu, from_right])
        win = x_ext[self.src].reshape(self.src.shape[0], -1)  # (Bc, U·unit·b)
        return torch.bmm(self.W, win.unsqueeze(-1)).reshape(-1)
