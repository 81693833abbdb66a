"""z-slab distributed varying-stencil SpMV with a plane halo exchange
(PyTorch counterpart of circulantpreconditioner_tpu/parallel/stencil_dist.py).

The distributed analog of ops/stencil.VaryingStencilOperator: the grid's z
axis is split over the ranks, and a matvec's only communication is one plane
of state each way around the ring: the VecScatter halo of the reference's
PETSc MatMult, for the topologically structured FVCA6 meshes.

The plane halos always wrap around the ring. On periodic meshes that is the
right neighbour; on wall/Neumann meshes the wrapped plane meets the
all-zero coefficients of the boundary layer (the single-device flat
layout's argument), so one code path serves both. With one rank the halo
planes are the rank's own opposite planes: the periodic wrap, real data.
"""

from __future__ import annotations

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops.stencil import VaryingStencilOperator
from circulantpreconditioner_tpu_torch.parallel.mesh_utils import RankMesh, shard_on_axis


class SlabStencilOperator:
    """y = A x over a z-slab-sharded grid, built from a single-device
    VaryingStencilOperator of either layout (its coefficients re-laid out as
    (m, m, nz, ny, nx), each rank keeping its z-slab). States are this
    rank's slab (nz/P, ny, nx, m), cell-major within each site."""

    def __init__(self, V: VaryingStencilOperator, mesh: RankMesh, axis: str = "shard"):
        nz, ny, nx = V.shape_zyx
        self.Pn = mesh.shape[axis]
        if nz % self.Pn:
            raise ValueError(f"nz={nz} must divide over {self.Pn} devices")
        self.shape_zyx = V.shape_zyx
        self.m = V.m
        self.mesh = mesh
        self.axis = axis
        self.dtype = V.coefs[0].dtype
        self.offsets, coefs = self._grid_last(V)
        self.coefs = tuple(shard_on_axis(C, mesh, axis, 2) for C in coefs)

    @staticmethod
    def _grid_last(V: VaryingStencilOperator):
        """Per-offset zyx tuples and (m, m, nz, ny, nx) coefficients."""
        nz, ny, nx = V.shape_zyx
        m = V.m
        if V.layout == "grid_last":
            return tuple(V.offsets), tuple(V.coefs)
        # flat offsets come from the 7-point set {0, ±1, ±nx, ±nx·ny}
        table = {0: (0, 0, 0), 1: (0, 0, 1), -1: (0, 0, -1), nx: (0, 1, 0), -nx: (0, -1, 0),
                 nx * ny: (1, 0, 0), -nx * ny: (-1, 0, 0)}
        return (tuple(table[int(off)] for off in V.offsets),
                tuple(C.reshape(m, m, nz, ny, nx) for C in V.coefs))

    def shard_vector(self, x) -> torch.Tensor:
        """Flat cell-major global state → this rank's slab (nz/P, ny, nx, m)."""
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return shard_on_axis(x.reshape(self.shape_zyx + (self.m,)), self.mesh, self.axis, 0,
                             self.dtype)

    def unshard_vector(self, x: torch.Tensor) -> torch.Tensor:
        """The flat cell-major global state, on every rank."""
        return self.mesh.all_gather(x, self.axis).reshape(-1)

    def matvec(self, x_loc: torch.Tensor) -> torch.Tensor:
        """x_loc (nz/P, ny, nx, m) → the same shape."""
        gt = x_loc.movedim(-1, 0)  # (m, nz/P, ny, nx)
        # the previous rank's top plane and the next rank's bottom plane
        lo, hi = self.mesh.ring_exchange(gt[:, -1:].contiguous(), gt[:, :1].contiguous(),
                                         self.axis)
        xp = torch.cat([lo, gt, hi], dim=1)
        nzP = gt.shape[1]
        m = self.m
        ys = [torch.zeros(gt.shape[1:], dtype=x_loc.dtype, device=x_loc.device)
              for _ in range(m)]
        for (dz, dy, dx), C in zip(self.offsets, self.coefs):
            nbr = xp[:, 1 + dz: 1 + dz + nzP]
            if dy:
                nbr = torch.roll(nbr, -dy, dims=2)
            if dx:
                nbr = torch.roll(nbr, -dx, dims=3)
            for i in range(m):
                acc = ys[i]
                for j in range(m):
                    acc = acc + C[i, j] * nbr[j]
                ys[i] = acc
        return torch.stack(ys).movedim(0, -1)

    def __call__(self, x):
        return self.matvec(x)
