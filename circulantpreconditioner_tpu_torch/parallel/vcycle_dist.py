"""The geometric grid V-cycle on a z-slab-sharded state: the counterpart of
what GSPMD makes of circulantpreconditioner_tpu/solvers/aggregation_pc.py
`GridVCyclePC` when the JAX package hands it a vector sharded as
NamedSharding(mesh, PS("shard")) (its bench_suite.py `_scale_worker`, and
__graft_entry__.py stage (e)).

The hierarchy is the one-device `GridVCyclePC`'s, built on the host by
`from_grid_model` (the Galerkin operators, Dinv, cnt_inv, bot_inv), and not
rebuilt: each rank keeps its z-slab of every sharded level, so the
arithmetic per cell is the one device's and only the sums' order can differ.

The layout is field-major, as `GridVCyclePC.apply_fm` and the bench rows'
GMRES: a level's vector on a rank is its z-slab of the field view, (b, nz/P,
ny, nx) flattened. z is the slowest grid axis, so a slab holds the cells
that GSPMD gives a device of the cell-major flat vector when nz % P == 0:
no padding. nz % P ≠ 0 raises, as parallel/stencil_dist.py does.

- **Sharded levels**, while the rank's slab holds an even number of planes,
  2 or more: the ω-damped block-Jacobi smoothing on the rank's sites; the
  level's operator the 7-point stencil on the slab extended by one halo
  plane each way (`SlabFmStencil`: one `RankMesh.ring_exchange`, the
  wrapped-halo argument of parallel/stencil_dist.py); restriction and
  prolongation of 2×2×2 boxes local, since no box crosses a rank.
- **Replicated levels**, from the first level whose slab is odd or thinner
  than two planes: that level's residual is all-gathered
  (`RankMesh.all_gather`), every rank runs the rest of the V-cycle on the
  whole coarse grid identically (the one-device levels and the dense bottom
  product), and keeps its slab of the correction. Where the bottom is
  reached by a local restriction, the gather comes at the bottom.

The fine level's operator is the production one: for the wave system
(`from_wave_model`) kernel K2 (csrc/plane_stencil.cu) on each rank's slab
and its two halo planes, whose coefficients are zero. K2's neighbours reach
at most one plane, so the interior planes come out exact; the halo planes'
outputs are discarded. With V(1, 1) an apply issues two ring exchanges per
sharded level (the residuals before the restriction and before the
post-smoothing) and one all-gather; each can be captured in a CUDA graph
with the rest of a sharded GMRES (utils/graphs.py). There is no CPU
fallback and no fallback to the one-device V-cycle: on the card every level
runs on the rank's GPU.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops.plane_stencil import make_plane_stencil_matvec
from circulantpreconditioner_tpu_torch.ops.stencil import (
    VaryingStencilOperator,
    WaveNormalStencilOperator,
)
from circulantpreconditioner_tpu_torch.parallel.mesh_utils import RankMesh
from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import (
    GridVCyclePC,
    _GridLevel,
    _vcycle,
)


def _slab_planes(a: torch.Tensor, nz: int, z0: int, nzP: int) -> torch.Tensor:
    """A coefficient array whose last axis is the grid (nz·ny·nx, x fastest)
    cut to the planes [z0, z0 + nzP), with one zero plane on each side."""
    g = a.reshape(a.shape[:-1] + (nz, -1))[..., z0:z0 + nzP, :]
    return torch.nn.functional.pad(g, (0, 0, 1, 1)).reshape(a.shape[:-1] + (-1,)).contiguous()


class SlabFmStencil:
    """y = shift·x + A x on field-major z-slabs, A a flat-layout 7-point
    stencil of the whole grid (a `VaryingStencilOperator`, or a
    `WaveNormalStencilOperator`, which runs in kernel K2). Each rank applies
    A to its slab extended by the plane each neighbour sends it
    (`ring_exchange`), the extension's coefficients zero, and keeps the
    interior planes. The halo planes wrap around the ring: on a wall mesh the
    wrapped plane meets the boundary layer's zero coefficients, as in the
    single-device flat layout. With one rank they are its own opposite
    planes."""

    def __init__(self, op, mesh: RankMesh, axis: str = "shard", shift: float | None = None):
        if op.layout != "flat" or len(op.shape_zyx) != 3:
            raise ValueError(f"SlabFmStencil needs a flat-layout 3D stencil, got layout "
                             f"{op.layout!r} on {op.shape_zyx}")
        nz, ny, nx = op.shape_zyx
        P = mesh.shape[axis]
        if nz % P:
            raise ValueError(f"nz={nz} must divide over {P} devices")
        self.mesh, self.axis, self.shift = mesh, axis, shift
        # self.op: A on the slab and its halo planes; self.ext_apply: its
        # field-major apply on (m, (nzP + 2)·ny·nx)
        self.m, self.nzP, self.plane = op.m, nz // P, ny * nx
        z0 = mesh.coords[axis] * self.nzP
        ext_zyx = (self.nzP + 2, ny, nx)
        if isinstance(op, WaveNormalStencilOperator):
            arrays = tuple(_slab_planes(a, nz, z0, self.nzP) for a in op.arrays)
            self.op = WaveNormalStencilOperator(ext_zyx, op.c0, op.offsets, "flat", arrays)
            # K2 on a CUDA tensor, its plain version on a CPU tensor
            self.ext_apply = make_plane_stencil_matvec(self.op)
            if self.ext_apply is None:
                raise ValueError("the slab's wave normal form misses kernel K2's contract "
                                 f"(offsets {op.offsets})")
        elif isinstance(op, VaryingStencilOperator):
            coefs = tuple(_slab_planes(C, nz, z0, self.nzP) for C in op.coefs)
            self.op = VaryingStencilOperator(ext_zyx, op.m, op.offsets, coefs, "flat")
            self.ext_apply = self.op.matvec_fm
        else:
            raise TypeError(f"SlabFmStencil takes a varying or wave normal-form stencil, got "
                            f"{type(op).__name__}")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: this rank's field-major slab, flat (m·nzP·ny·nx,) → the same."""
        g = x.reshape(self.m, self.nzP, self.plane)
        # the previous rank's top plane and the next rank's bottom plane
        lo, hi = self.mesh.ring_exchange(g[:, -1].contiguous(), g[:, 0].contiguous(), self.axis)
        ext = torch.cat([lo.unsqueeze(1), g, hi.unsqueeze(1)], dim=1).reshape(self.m, -1)
        y = self.ext_apply(ext).reshape(self.m, self.nzP + 2, self.plane)[:, 1:-1].reshape(-1)
        if self.shift is None:
            return y
        return x + y if self.shift == 1.0 else self.shift * x + y


class SlabGridVCyclePC:
    """M⁻¹ r by one V-cycle of a one-device `GridVCyclePC`'s hierarchy on
    field-major z-slabs; see the module docstring. `fine` is the fine
    level's slab operator (shift included), `shape_xyz` the fine grid."""

    def __init__(self, pc: GridVCyclePC, fine: Callable, mesh: RankMesh, shape_xyz,
                 axis: str = "shard"):
        if any(not isinstance(L, _GridLevel) for L in pc.levels):
            raise ValueError("SlabGridVCyclePC shards grid levels only (cells_per_site = 1)")
        self.pc, self.fine, self.mesh, self.axis = pc, fine, mesh, axis
        self.b = b = pc.b
        P = mesh.shape[axis]
        rank = mesh.coords[axis]
        shapes = [tuple(L.shape_xyz) for L in pc.levels]
        shapes.append(tuple(pc.levels[-1].cshape_xyz) if pc.levels
                      else tuple(int(v) for v in shape_xyz))
        nz0 = shapes[0][2]
        if nz0 % P:
            raise ValueError(f"nz={nz0} must divide over {P} devices")
        self.shapes_xyz = shapes
        levels = []
        for L, (nx, ny, nz) in zip(pc.levels, shapes):
            nzP = nz // P
            if nzP < 2 or nzP % 2:
                break
            z0 = rank * nzP
            cx, cy, _ = L.cshape_xyz
            Dinv = L.Dinv.reshape(nz, ny * nx, b, b)[z0:z0 + nzP].reshape(-1, b, b).contiguous()
            A_fm = fine if not levels else SlabFmStencil(L.stencil, mesh, axis)
            levels.append(_GridLevel(
                Dinv=Dinv, cnt_inv=L.cnt_inv[z0 // 2:(z0 + nzP) // 2].contiguous(),
                shape_xyz=(nx, ny, nzP), cshape_xyz=(cx, cy, nzP // 2), b=b, A_fm=A_fm))
        self.levels = tuple(levels)
        # the gather: the first replicated level (len(pc.levels): the bottom)
        self.gather_level = k = len(levels)
        nx, ny, nz = shapes[k]
        self._gz = (nz, nz // P, rank * (nz // P), ny * nx)
        self.gather_values = b * nx * ny * nz

    @classmethod
    def from_wave_model(cls, model, mesh: RankMesh, axis: str = "shard",
                        pc: GridVCyclePC | None = None, bottom_max: int = 600):
        """The V-cycle of the implicit wave system A = I + D on a Kershaw
        mesh: the one-device hierarchy `pc` (by default built as the bench
        rows build it, with the model's production operators), and A on the
        fine slabs as the wave normal form in kernel K2 (`self.fine`, the
        sharded GMRES's operator too)."""
        shape_xyz = model.mesh.topology_shape
        if pc is None:
            pc = GridVCyclePC.from_grid_model(
                model.divergence, shape_xyz, cells_per_site=1, A0_apply=model.implicit_matvec(),
                A0_apply_fm=model.implicit_matvec_fm(), shift=1.0, bottom_max=bottom_max,
                dtype=model.dtype)
        Wn = model.normal_operator
        if Wn is None:
            raise ValueError("the wave normal-form decomposition failed for this mesh: no K2 "
                             "fine level")
        return cls(pc, SlabFmStencil(Wn, mesh, axis, shift=1.0), mesh, shape_xyz, axis)

    # --- the fine level's slabs -------------------------------------------------
    def shard(self, g) -> torch.Tensor:
        """Field-major (b, N) or flat global vector → this rank's flat slab."""
        g = g if isinstance(g, torch.Tensor) else torch.as_tensor(np.asarray(g))
        nx, ny, nz = self.shapes_xyz[0]
        nzP = nz // self.mesh.shape[self.axis]
        z0 = self.mesh.coords[self.axis] * nzP
        slab = g.reshape(self.b, nz, ny * nx)[:, z0:z0 + nzP]
        return slab.reshape(-1).to(device=self.mesh.device, dtype=self.pc.bot_inv.dtype)

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        """The flat field-major global vector, on every rank."""
        nx, ny, _ = self.shapes_xyz[0]
        return self._gather(x, ny * nx)

    def _gather(self, x: torch.Tensor, plane: int) -> torch.Tensor:
        g = x.reshape(self.b, -1, plane).transpose(0, 1).contiguous()
        return self.mesh.all_gather(g, self.axis).transpose(0, 1).reshape(-1)

    # --- the apply --------------------------------------------------------------
    def _replicated(self, r: torch.Tensor) -> torch.Tensor:
        """The bottom of the sharded levels: gather, the rest of the V-cycle
        on the whole grid, keep this rank's slab."""
        nz, nzP, z0, plane = self._gz
        full = self._gather(r, plane)
        pc = self.pc
        z = _vcycle(pc.levels, pc.bot_inv, pc.n_smooth, pc.omega, self.gather_level, full)
        return z.reshape(self.b, nz, plane)[:, z0:z0 + nzP].reshape(-1)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """z = M⁻¹ r on this rank's flat field-major fine slab."""
        return _vcycle(self.levels, self._replicated, self.pc.n_smooth, self.pc.omega, 0, r)

    __call__ = apply

    def describe(self) -> str:
        """The levels, planes per rank, and where the residual is gathered."""
        P = self.mesh.shape[self.axis]
        parts = [f"{nx}x{ny}x{nz} ({nz // P} planes)" for nx, ny, nz in
                 self.shapes_xyz[:len(self.levels)]]
        nx, ny, nz = self.shapes_xyz[self.gather_level]
        where = "bottom" if self.gather_level == len(self.pc.levels) else "level"
        return (", ".join(parts) + ("; " if parts else "") + f"gather at the {where} "
                f"{nx}x{ny}x{nz} ({self.gather_values} values)")
