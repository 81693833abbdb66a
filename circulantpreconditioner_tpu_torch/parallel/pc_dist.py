"""Distributed preconditioners: the circulant projection PC and point-block
Jacobi over a rank mesh, for the row-sharded GMRES (PyTorch counterpart of
circulantpreconditioner_tpu/parallel/pc_dist.py).

This is the composition the reference was building toward and never
finished: a preconditioner applied INSIDE a distributed Krylov solve. The
reference runs GMRES + BJACOBI distributed (WaveSystem_SphericalExplosion_
impl_mpi.cxx:32-34, :139-189), and its stated end goal was the FFT
preconditioner inside the parallel KSP (ToDo.md:1, PCSHELLFft_3D.cxx:10-24,
FFTW-MPI providing the distributed FFT). Here:

- `sharded_pbjacobi`: point-block Jacobi, each rank holding the inverted
  diagonal blocks of its rows (no communication per apply);
- `SlabBlockCirculantSolver`: the z-slab block-circulant direct solve with
  every transform a dense matmul on (re, im) pairs, the distributed twin of
  ops/dft_matmul.MatmulBlockCirculantSolver; one all-to-all each way (the
  y ↔ z transpose), re and im stacked into one message;
- `DistributedBlockCirculantPC`: M⁻¹ = P_back · C⁻¹ · P, with P's rows
  (cartesian cells, x fastest) split so that each rank's rows are its
  z-slab, P_back's rows (the mesh's cells) split like the vector, and the
  slab solve in place. With halo=True an apply is four all-to-alls: a
  personalised exchange of the residual rows each slab's P rows reference
  (the VecScatter analog), the solver's transpose pair, and a personalised
  exchange of the cartesian rows each rank's P_back rows reference. No
  all-gather: the volume exchanged is the projection stencils' footprint.
  halo=False all-gathers both vectors instead.

The cartesian grid is derived as in the single-device PC
(solvers/circulant_pc.derive_grid_context), with n_z and n_y rounded up to
multiples of the rank count so that the slabs and the transpose tile evenly.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.mesh.core import Mesh as FVMesh
from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix
from circulantpreconditioner_tpu_torch.ops.dft_matmul import (
    _axis_cdft,
    _np_dft_mats,
    _np_rdft_mats,
)
from circulantpreconditioner_tpu_torch.ops.tier_matmul import tier_matmul
from circulantpreconditioner_tpu_torch.parallel.mesh_utils import (
    RankMesh,
    replicated,
    shard_on_axis,
)
from circulantpreconditioner_tpu_torch.parallel.spmv_dist import host_ell, pad_rows
from circulantpreconditioner_tpu_torch.utils.device import check_precision


def _build_exchange(cols: np.ndarray, n_src_blocks: int, Pn: int):
    """Personalised-exchange plan for a row-sharded gather (the VecScatter
    analog: exchange exactly the rows needed, never replicate).

    `cols` is the (n_dst_rows, K) ELL column table of a projection matrix,
    whose values index block rows of a source vector of `n_src_blocks` block
    rows, split contiguously over Pn ranks; destination rows are split
    likewise (n_dst_rows % Pn == 0). Returns:

      send_idx   (Pn, Pn, H) int64: send_idx[j, i] = the LOCAL block rows
                 source rank j sends to destination rank i (padded with 0;
                 the remapped columns never point at a pad slot);
      cols_remap (n_dst_rows, K) int64: cols rewritten to index the
                 all-to-all receive buffer flattened to (Pn·H,): after rank
                 i computes recv = all_to_all(src_loc[send_idx[i]]), it holds
                 recv.reshape(Pn·H, ...)[cols_remap[r]] == src[cols[r]] for
                 every destination row r it owns;
      H          int: the most rows any pair of ranks exchanges (the halo).
    """
    n_dst = cols.shape[0]
    if n_src_blocks % Pn or n_dst % Pn:
        raise ValueError("source and destination rows must shard evenly")
    Bs = n_src_blocks // Pn
    Bd = n_dst // Pn
    reqs = []  # reqs[i][j]: sorted unique global cols rank i needs from rank j
    H = 1
    for i in range(Pn):
        needed = np.unique(cols[i * Bd:(i + 1) * Bd].ravel())
        owner = needed // Bs
        per_src = [needed[owner == j] for j in range(Pn)]
        reqs.append(per_src)
        H = max(H, max(len(r) for r in per_src))
    send_idx = np.zeros((Pn, Pn, H), np.int64)
    cols_remap = np.empty(cols.shape, dtype=np.int64)
    for i in range(Pn):
        # buffer slot of each needed global col: j·H + its rank in reqs[i][j]
        needed = np.concatenate(reqs[i])  # sorted overall (owners ascend)
        pos = np.concatenate([j * H + np.arange(len(reqs[i][j]), dtype=np.int64)
                              for j in range(Pn)])
        for j in range(Pn):
            rj = reqs[i][j]
            send_idx[j, i, :len(rj)] = rj - j * Bs
        blk = cols[i * Bd:(i + 1) * Bd]
        cols_remap[i * Bd:(i + 1) * Bd] = pos[np.searchsorted(needed, blk)]
    if Pn * H >= n_src_blocks:
        # every pair is padded to the largest halo H, so one skewed projection
        # footprint can inflate the buffer (Pn·H rows per rank) past the
        # all-gather volume the halo path is meant to avoid: say so
        warnings.warn(
            f"halo exchange buffer Pn*H = {Pn}*{H} rows >= source size "
            f"{n_src_blocks}: projection footprint is too skewed for the "
            "personalized exchange to beat all_gather (consider halo=False)",
            RuntimeWarning, stacklevel=2)
    return send_idx, cols_remap, H


def _pad_ell(A: CSRMatrix, n_rows_padded: int):
    """Host (cols, vals) ELL arrays padded with zero rows to n_rows_padded."""
    return pad_rows(*host_ell(A), n_rows_padded)


def _block_diag_apply(D_loc: torch.Tensor, r_loc: torch.Tensor) -> torch.Tensor:
    b = D_loc.shape[-1]
    return torch.einsum("nij,nj->ni", D_loc, r_loc.reshape(-1, b)).reshape(-1)


def sharded_pbjacobi(Dinv: np.ndarray, n_padded: int, mesh: RankMesh,
                     axis: str = "shard", dtype: torch.dtype = torch.float32):
    """Point-block Jacobi on a row-sharded padded vector.

    Dinv: (n_brows, b, b) inverted diagonal blocks (of BSRMatrix.block_diagonal()
    plus the shift, as in solvers/preconditioners.pbjacobi). Padded rows get
    identity blocks, so the zero tail stays zero. Needs n_padded % (P·b) == 0
    (build the sharded operator with row_multiple=b). The apply is local: the
    PETSc PCPBJACOBI-in-parallel analog."""
    Dinv = np.asarray(Dinv)
    b = Dinv.shape[-1]
    Pn = mesh.shape[axis]
    if n_padded % (Pn * b):
        raise ValueError(f"n_padded={n_padded} must be a multiple of P·b={Pn * b}")
    D = np.tile(np.eye(b), (n_padded // b, 1, 1))
    D[: Dinv.shape[0]] = Dinv
    return functools.partial(_block_diag_apply, shard_on_axis(D, mesh, axis, 0, dtype))


class SlabBlockCirculantSolver:
    """z-slab distributed block-circulant direct solve, all matmul.

    The field (nz, ny, nx, m) is real, each rank holding its z-slab:

        half-spectrum x-DFT (matmul, nx → nxr)       local
        complex y-DFT (matmul)                       local
        all-to-all: split ky, gather z               (re, im) in one message
        complex z-DFT (matmul)                       local
        (m × m) block solve by the pre-inverted symbol, split on ky
        inverse z-DFT → all-to-all back → inverse y → inverse x

    Needs nz % P == 0 and ny % P == 0; m = 1 is the scalar solver. The axis
    transforms take the precision tier through `tier_matmul`
    (ops/tier_matmul.py: K4 at "high" and "default" on a CUDA float32
    tensor); the (m × m) block solve stays fp32 in every tier."""

    def __init__(self, shape_zyx, m: int, inv_sym: np.ndarray, mesh: RankMesh,
                 axis: str = "shard", dtype: torch.dtype = torch.float32,
                 precision: str = "high"):
        nz, ny, nx = (int(v) for v in shape_zyx)
        Pn = mesh.shape[axis]
        if nz % Pn or ny % Pn:
            raise ValueError(f"nz={nz} and ny={ny} must be divisible by P={Pn}")
        self.shape_zyx = (nz, ny, nx)
        self.m = int(m)
        self.mesh = mesh
        self.axis = axis
        self.dtype = dtype
        self.precision = check_precision(precision)
        nxr = nx // 2 + 1
        assert inv_sym.shape == (nz, ny, nxr, m, m), inv_sym.shape
        # the symbol lives after the transpose: split on ky
        self.inv_re = shard_on_axis(np.ascontiguousarray(inv_sym.real), mesh, axis, 1, dtype)
        self.inv_im = shard_on_axis(np.ascontiguousarray(inv_sym.imag), mesh, axis, 1, dtype)
        mats = _np_rdft_mats(nx) + _np_dft_mats(ny) + _np_dft_mats(nz)
        (self.F_re, self.F_im, self.B_re, self.B_im, self.Cy, self.Sy, self.Cyi, self.Syi,
         self.Cz, self.Sz, self.Czi, self.Szi) = (replicated(M, mesh, dtype) for M in mats)

    @classmethod
    def from_stencil(cls, shape_zyx, offsets, blocks, mesh: RankMesh, axis: str = "shard",
                     dtype: torch.dtype = torch.float32, precision: str = "high"):
        from circulantpreconditioner_tpu_torch.ops.circulant import BlockCirculantOperator

        shape_zyx = tuple(int(v) for v in shape_zyx)
        m = np.asarray(blocks).shape[-1]
        sym = BlockCirculantOperator.np_symbol(shape_zyx, offsets, blocks)
        nxr = shape_zyx[-1] // 2 + 1
        inv = np.linalg.inv(sym[..., :nxr, :, :])
        return cls(shape_zyx, m, inv, mesh, axis, dtype, precision)

    def shard(self, b) -> torch.Tensor:
        """This rank's z-slab (nz/P, ny, nx, m) of a global field (or flat
        cell-major vector)."""
        b = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
        return shard_on_axis(b.reshape(self.shape_zyx + (self.m,)), self.mesh, self.axis, 0,
                             self.dtype)

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        """The global (nz, ny, nx, m) field, on every rank."""
        return self.mesh.all_gather(x, self.axis)

    def _transpose(self, re, im, split, concat):
        """(re, im) through one all-to-all, stacked in one message."""
        both = self.mesh.all_to_all(torch.stack([re, im]), self.axis, split + 1, concat + 1)
        return both[0], both[1]

    def _local_solve(self, b_loc: torch.Tensor) -> torch.Tensor:
        """b_loc (nz/P, ny, nx, m) real → x_loc of the same shape."""
        p = self.precision
        mm = lambda v, M: tier_matmul(v, M, p, 2)  # noqa: E731  (along x)
        re, im = mm(b_loc, self.F_re), mm(b_loc, self.F_im)
        re, im = _axis_cdft(re, im, self.Cy, self.Sy, 1, p)
        re, im = self._transpose(re, im, 1, 0)  # (nz, ny/P, nxr, m)
        re, im = _axis_cdft(re, im, self.Cz, self.Sz, 0, p)
        ire, iim = self.inv_re, self.inv_im  # (ire + i·iim) @ (re + i·im), fp32
        ein = lambda M, v: torch.einsum("...ij,...j->...i", M, v)  # noqa: E731
        re, im = ein(ire, re) - ein(iim, im), ein(ire, im) + ein(iim, re)
        re, im = _axis_cdft(re, im, self.Czi, self.Szi, 0, p)
        re, im = self._transpose(re, im, 0, 1)  # (nz/P, ny, nxr, m)
        re, im = _axis_cdft(re, im, self.Cyi, self.Syi, 1, p)
        return mm(re, self.B_re) + mm(im, self.B_im)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """b: this rank's slab (nz/P, ny, nx, m), or its flat cell-major form."""
        nz, ny, nx = self.shape_zyx
        x = self._local_solve(b.reshape(nz // self.mesh.shape[self.axis], ny, nx, self.m))
        return x.reshape(-1) if b.ndim == 1 else x


def _derive_slab_grid(mesh: FVMesh, Pn: int):
    """Cartesian PC grid for Pn ranks: n_side per axis as in
    derive_grid_context, with n_z and n_y rounded up to multiples of Pn."""
    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import derive_grid_context

    n_xyz, spacing, _, bbox = derive_grid_context(mesh, [0.0] * mesh.dim, 1.0)
    n_xyz = list(n_xyz)
    dim = mesh.dim
    # the zyx axes that must divide, z (slabs) and y (transpose), are the
    # last two in xyz order
    for d in range(max(dim - 2, 0), dim):
        n_xyz[d] = ((n_xyz[d] + Pn - 1) // Pn) * Pn
    spacing = tuple((bbox[d, 1] - bbox[d, 0]) / n_xyz[d] for d in range(dim))
    return tuple(n_xyz), spacing, bbox


class DistributedBlockCirculantPC:
    """Distributed block-circulant projection PC for the wave system:
    M⁻¹ = P_back · C_slab⁻¹ · P, every part sharded.

    The multi-device flagship composition (reference ToDo.md:1 with
    PCSHELLFft_3D.cxx and the BJACOBI MPI driver): r is the row-sharded
    residual of the sharded GMRES; P's rows (cartesian cells, x fastest)
    are split so that each rank's rows are its z-slab; the slab solve runs
    in place; P_back's rows (the mesh's cells) are split like the vector.
    halo=True (the default): four all-to-alls per apply, no all-gather;
    halo=False: two all-gathers (the replicating form, for comparison).

    Use as the coarse term of an additive composite with sharded_pbjacobi
    and side="right" GMRES, as the single-device circulant2l mode does."""

    def __init__(self, fv_mesh: FVMesh, dt: float, c0: float, dmesh: RankMesh,
                 n_padded: int, axis: str = "shard", dtype: torch.dtype = torch.float32,
                 samples_per_axis: int = 3, precision: str = "high", halo: bool = True):
        from circulantpreconditioner_tpu_torch.ops.assembly import wave_block_stencil
        from circulantpreconditioner_tpu_torch.solvers.circulant_pc import (
            build_projection_matrices,
        )

        if fv_mesh.dim != 3:
            raise ValueError("distributed projection PC is 3D (slab axis = z)")
        Pn = dmesh.shape[axis]
        nb = fv_mesh.dim + 1
        if n_padded % (Pn * nb):
            raise ValueError(
                f"n_padded={n_padded} must be a multiple of P·b={Pn * nb} "
                "(build the sharded operator with row_multiple=dim+1)")
        n_xyz, spacing, bbox = _derive_slab_grid(fv_mesh, Pn)
        self.n_xyz = n_xyz
        self.nb = nb
        self.mesh = dmesh
        self.axis = axis
        self.halo = halo
        shape_zyx = tuple(reversed(n_xyz))
        offsets, blocks = wave_block_stencil(fv_mesh.dim, dt, c0, spacing)
        self.solver = SlabBlockCirculantSolver.from_stencil(
            shape_zyx, offsets, blocks, dmesh, axis, dtype, precision)
        Pm, Pb = build_projection_matrices(fv_mesh, n_xyz, bbox, samples_per_axis,
                                           device=torch.device("cpu"), dtype=dtype)
        ncart = int(np.prod(n_xyz))
        # P's rows are cartesian cells in x-fastest order: contiguous blocks
        # of ncart/P rows are exactly the z-slabs (nz % P == 0)
        pc_cols, pc_vals = _pad_ell(Pm, ncart)
        # P_back's rows are the mesh's cells, padded to the vector's block rows
        bk_cols, bk_vals = _pad_ell(Pb, n_padded // nb)
        shard = functools.partial(shard_on_axis, mesh=dmesh, axis_name=axis, array_axis=0)
        self._pc_vals = shard(pc_vals, dtype=dtype)
        self._bk_vals = shard(bk_vals, dtype=dtype)
        if halo:
            fwd_send, pc_cols, self.halo_fwd = _build_exchange(pc_cols, n_padded // nb, Pn)
            bak_send, bk_cols, self.halo_bak = _build_exchange(bk_cols, ncart, Pn)
            r = dmesh.coords[axis]
            self._fwd_send = replicated(fwd_send[r], dmesh)  # (Pn, H1): rows for each rank
            self._bak_send = replicated(bak_send[r], dmesh)
        self._pc_cols = shard(pc_cols)
        self._bk_cols = shard(bk_cols)

    def _gather_rows(self, rows: torch.Tensor, send: torch.Tensor | None) -> torch.Tensor:
        """The (n, nb) rows a rank's projection columns index: its
        personalised receive buffer (halo) or the whole vector."""
        if self.halo:
            buf = self.mesh.all_to_all(rows[send], self.axis, 0, 0)  # (Pn, H, nb)
            return buf.reshape(-1, self.nb)
        return self.mesh.all_gather(rows, self.axis)

    def apply(self, r_loc: torch.Tensor) -> torch.Tensor:
        """z = M⁻¹ r on this rank's block of a row-sharded padded vector."""
        nb = self.nb
        nz, ny, nx = self.solver.shape_zyx
        src = self._gather_rows(r_loc.reshape(-1, nb), self._fwd_send if self.halo else None)
        r_cart = torch.einsum("rk,rkm->rm", self._pc_vals, src[self._pc_cols])
        x_slab = self.solver._local_solve(
            r_cart.reshape(nz // self.mesh.shape[self.axis], ny, nx, nb))
        xc = self._gather_rows(x_slab.reshape(-1, nb), self._bak_send if self.halo else None)
        return torch.einsum("rk,rkm->rm", self._bk_vals, xc[self._bk_cols]).reshape(-1)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.apply(r)
