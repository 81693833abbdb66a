"""Structured-grid stencil operators: gather-free D·u (PyTorch counterparts
of circulantpreconditioner_tpu/ops/stencil.py).

- `TransportStencilOperator`: scalar upwind transport on cartesian grids.
- `WaveStencilOperator`: the wave system on uniform cartesian grids with
  homogeneous Wall or Periodic boundaries.
- `VaryingStencilOperator`: any 7-point (block) stencil on a topologically
  structured mesh (the warped Kershaw hexahedra; with `cells_per_site` > 1,
  the tet meshes' supercells of 6 cells), as per-offset coefficient fields
  applied with `torch.roll`.
- `SupercellStencilOperator`: the block-sparse form of a supercell varying
  stencil, only the non-zero (m×m) sub-blocks of each offset.
- `SupercellNormalOperator`: the wave system's normal form of a supercell
  stencil, each cell's diagonal block and (s, n̂) per face slot; its apply
  is kernel K7 on the card (ops/supercell_stencil.py,
  csrc/supercell_stencil.cu), `plain_fm` its plain version.
- `WaveNormalStencilOperator`: the wave system's normal form of the varying
  stencil, with (s, n̂) per neighbour instead of a dense block. Its flat
  field-major apply is the plain version of kernel K2
  (ops/plane_stencil.py, csrc/plane_stencil.cu).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops import supercell_stencil
from circulantpreconditioner_tpu_torch.ops.assembly import wave_jacobian_blocks
from circulantpreconditioner_tpu_torch.utils.device import check_real_dtype
from circulantpreconditioner_tpu_torch.utils.graphs import STATS
from circulantpreconditioner_tpu_torch.utils.profiling import device_span


def _to(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float64, order="C")).to(device=device,
                                                                          dtype=dtype)


def _neighbour(gt: torch.Tensor, off, layout: str) -> torch.Tensor:
    """The field-major gt read at cell + off: one flat roll of (m, N) for the
    "flat" layout (off an int), per-axis rolls of (m, nz, ny, nx) for
    "grid_last" (off a zyx tuple)."""
    if layout == "flat":
        return torch.roll(gt, -off, dims=1) if off else gt
    for ax, o in enumerate(off):
        if o:
            gt = torch.roll(gt, -o, dims=ax + 1)
    return gt


def _side_tables(dim: int, dt: float, c0: float, spacing):
    """Per-side upwind blocks Am and wall mirrors for the wave system.

    Sides are (axis_zyx, dir) with dir=+1 the face whose outward normal is
    +e_axis. Returns (Am (nsides,b,b), mirror (nsides,b,b))."""
    h = np.asarray(spacing, dtype=np.float64)[:dim]
    nb = dim + 1
    Ams, mirrors = [], []
    for ax_zyx in range(dim):
        d_xyz = dim - 1 - ax_zyx
        for sgn in (+1.0, -1.0):
            e = np.zeros((1, dim))
            e[0, d_xyz] = sgn
            A, absA = wave_jacobian_blocks(e, c0)
            Ams.append(0.5 * (A[0] - absA[0]) * (dt / h[d_xyz]))
            v = np.zeros(nb)
            v[1:] = e[0]
            mirrors.append(np.eye(nb) - 2.0 * np.outer(v, v))
    return np.stack(Ams), np.stack(mirrors)


def _site_couplings(rows, cols, shape_xyz, g: int):
    """The block COO (rows, cols) of a matrix on a grid of sites, g
    consecutive block rows a site, sites numbered x fastest: (shape_zyx, each
    entry's site row, sub-row and sub-column, and its offset key
    (dz+1)·9 + (dy+1)·3 + (dx+1)). Raises ValueError where the matrix is not
    a 7-point face-neighbour stencil of sites."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    dims_xyz = tuple(int(v) for v in shape_xyz)
    nx = dims_xyz[0]
    ny = dims_xyz[1] if len(dims_xyz) > 1 else 1
    nz = dims_xyz[2] if len(dims_xyz) > 2 else 1

    site_r, sub_r = rows // g, rows % g
    site_c, sub_c = cols // g, cols % g

    def split(idx):
        return idx % nx, (idx // nx) % ny, idx // (nx * ny)

    rx, ry, rz = split(site_r)
    cx, cy, cz = split(site_c)

    def delta(a, b, n):
        d = (b - a) % n
        return np.where(d == 0, 0, np.where(d == 1, 1, np.where(d == n - 1, -1, 99)))

    dx, dy, dz = delta(rx, cx, nx), delta(ry, cy, ny), delta(rz, cz, nz)
    if (np.abs(dx) > 1).any() or (np.abs(dy) > 1).any() or (np.abs(dz) > 1).any():
        raise ValueError("matrix is not a face-neighbour stencil on this grid")
    if ((dx != 0).astype(int) + (dy != 0).astype(int) + (dz != 0).astype(int) > 1).any():
        raise ValueError("matrix couples diagonal neighbours — not a 7-point stencil")
    return (nz, ny, nx), site_r, sub_r, sub_c, (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)


def _offset_zyx(key) -> tuple[int, int, int]:
    k = int(key)
    return (k // 9 - 1, (k // 3) % 3 - 1, k % 3 - 1)


def _flat_offset(off, shape_zyx) -> int:
    """A zyx offset as a shift of the flat (x fastest) site index."""
    _, ny, nx = shape_zyx
    return int(off[0] * ny * nx + off[1] * nx + off[2])


class WaveStencilOperator:
    """D of the wave system on a uniform cartesian grid, stencil-evaluated.

    bc: "wall" (reference default: mirror ghosts) or "periodic". State
    layout: flat cell-major (N·(dim+1),), zyx with x fastest, as the
    assembled BSRMatrix, so `matvec` is a drop-in replacement."""

    def __init__(self, shape_zyx, bc: str, Am: torch.Tensor, mirror: torch.Tensor):
        if bc not in ("wall", "periodic"):
            raise ValueError(f"bc must be 'wall' or 'periodic', got {bc!r}")
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.bc = bc
        self.Am = Am  # (2·dim, b, b)
        self.mirror = mirror  # (2·dim, b, b)

    @classmethod
    def create(cls, shape_xyz: Sequence[int], dt: float, c0: float, spacing_xyz,
               bc: str = "wall", *, device: torch.device, dtype: torch.dtype):
        check_real_dtype(dtype)
        Am, mirror = _side_tables(len(shape_xyz), dt, c0, spacing_xyz)
        return cls(tuple(reversed(tuple(int(v) for v in shape_xyz))), bc,
                   _to(Am, device, dtype), _to(mirror, device, dtype))

    @classmethod
    def from_model(cls, model, bc: str = "wall"):
        mesh = model.mesh
        return cls.create(mesh.structured_shape, model.dt, model.c0, mesh.spacing, bc=bc,
                          device=model.device, dtype=model.dtype)

    @property
    def nb(self) -> int:
        return len(self.shape_zyx) + 1

    def matvec(self, U: torch.Tensor) -> torch.Tensor:
        """y = D U (divergence only: apply I+D for the implicit system)."""
        nb = self.nb
        g = U.reshape(self.shape_zyx + (nb,))
        out = torch.zeros_like(g)
        s = 0
        for ax, n in enumerate(self.shape_zyx):
            for sgn in (+1, -1):
                nbr = torch.roll(g, -sgn, dims=ax)  # neighbour in the +sgn direction
                if self.bc != "periodic":
                    # the face at the domain edge has no neighbour: wall
                    # mirror ghost (I − 2vvᵀ)U
                    bshape = [1] * g.ndim
                    bshape[ax] = n
                    edge = torch.arange(n, device=g.device).reshape(bshape) == (
                        n - 1 if sgn > 0 else 0)
                    ghost = torch.einsum("...j,ij->...i", g, self.mirror[s])
                    nbr = torch.where(edge, ghost, nbr)
                out = out + torch.einsum("...j,ij->...i", nbr - g, self.Am[s])
                s += 1
        return out.reshape(-1)

    __call__ = matvec


class TransportStencilOperator:
    """Scalar upwind divergence D on a uniform cartesian grid.

    bc: "periodic" (circulant case) or "neumann" (reference transport
    drivers: boundary faces contribute nothing)."""

    def __init__(self, shape_zyx, bc: str, lam_plus, lam_minus):
        if bc not in ("periodic", "neumann"):
            raise ValueError(f"bc must be 'periodic' or 'neumann', got {bc!r}")
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.bc = bc
        self.lam_plus = tuple(float(v) for v in lam_plus)  # max(a_d,0)·dt/h_d per zyx axis
        self.lam_minus = tuple(float(v) for v in lam_minus)  # min(a_d,0)·dt/h_d

    @classmethod
    def create(cls, shape_xyz: Sequence[int], velocity_xyz, dt: float, spacing_xyz,
               bc: str = "periodic"):
        dim = len(shape_xyz)
        a = np.asarray(velocity_xyz, dtype=np.float64)[:dim]
        h = np.asarray(spacing_xyz, dtype=np.float64)[:dim]
        lam_zyx = (a * dt / h)[::-1]
        return cls(
            tuple(reversed(tuple(int(v) for v in shape_xyz))),
            bc,
            tuple(float(max(l, 0.0)) for l in lam_zyx),
            tuple(float(min(l, 0.0)) for l in lam_zyx),
        )

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """y = D u, matching ops/assembly.transport_divergence_csr exactly.

        Per axis with λ = a·dt/h. For λ>0 (flow in +direction): cell j's
        outflow (+) face gives +λ·u_j when interior (j<n−1), its inflow (−)
        face gives −λ·u_{j−1} when interior (j≥1); Neumann boundary faces
        contribute nothing. Periodic keeps both terms with wraparound.
        Mirrored for λ<0.
        """
        g = u.reshape(self.shape_zyx)
        out = torch.zeros_like(g)
        periodic = self.bc == "periodic"
        for ax, (lp, lm) in enumerate(zip(self.lam_plus, self.lam_minus)):
            n = self.shape_zyx[ax]
            if not periodic and (lp or lm):
                bshape = [1] * g.ndim
                bshape[ax] = n
                idx = torch.arange(n, device=g.device).reshape(bshape)
                first, last = idx >= 1, idx < n - 1  # has an interior − / + face
            if lp:
                up = torch.roll(g, 1, dims=ax)  # u_{j−1} (wraps)
                if periodic:
                    out = out + lp * (g - up)
                else:
                    out = out + lp * (torch.where(last, g, 0.0) - torch.where(first, up, 0.0))
            if lm:
                dn = torch.roll(g, -1, dims=ax)  # u_{j+1} (wraps)
                if periodic:
                    out = out - lm * (g - dn)
                else:
                    out = out - lm * (torch.where(first, g, 0.0) - torch.where(last, dn, 0.0))
        return out.reshape(-1)


class _GridStencil:
    """The applies shared by the grid stencils: `_apply_gt` (on the
    field-major (m, N) or (m, nz, ny, nx) view, returning the output in the
    same shape) is the subclass's; shape_zyx, m and layout are its fields."""

    def _fm_shape(self) -> tuple[int, ...]:
        return (self.m, -1) if self.layout == "flat" else (self.m,) + self.shape_zyx

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Cell-major apply: x flat (N·m,), cell j owning x[j·m:(j+1)·m]."""
        gt = x.reshape(-1, self.m).T.reshape(self._fm_shape())
        return self._apply_gt(gt).movedim(0, -1).reshape(-1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def matvec_fm(self, g: torch.Tensor) -> torch.Tensor:
        """Field-major apply: g (m, N) [flat] or (m, *grid) [grid_last] → the
        same shape. Same arithmetic as `matvec` without the (N,m)↔(m,N)
        relayouts."""
        return self._apply_gt(g)

    def matvec_fm_flat(self, x: torch.Tensor) -> torch.Tensor:
        """Field-major apply on a flat (m·N,) vector whose x.reshape(m, ...)
        is the field view, for Krylov solvers whose vectors are 1D."""
        return self.matvec_fm(x.reshape(self._fm_shape())).reshape(-1)


class VaryingStencilOperator(_GridStencil):
    """Gather-free SpMV for topologically structured meshes with varying
    coefficients (the warped Kershaw / hexa families): the assembled BSR
    operator re-expressed as per-offset dense coefficient fields

        y[c] = Σ_off  C_off[c] @ x[c + off],   off ∈ {0, ±ex, ±ey, ±ez}

    applied with `torch.roll` shifts and unrolled (m×m) multiply-adds, or,
    for blocks larger than `_UNROLL_MAX`, one contraction per offset. Wall/Neumann
    boundaries need no masks: the assembled matrix has zero blocks on the
    outward-facing boundary layers, so wrapped values are multiplied by
    zero; a periodic wrap is the roll itself.

    `cells_per_site` > 1 groups consecutive cells into one grid site (a
    supercell): the tet meshes number 6 tets per hex, hex-major, so each
    site block is (6m × 6m) and the coupling between sites stays a 7-point
    stencil.

    Layouts:
    - "flat": coefs (m, m, N) with the whole grid as the last axis and each
      neighbour a single flat roll. Valid when every wrap-crossing boundary
      layer has zero coefficients (wall/Neumann assemblies), detected at
      build time (`_flat_safe`).
    - "grid_last": coefs (m, m, nz, ny, nx) and per-axis rolls, for
      periodic wraps."""

    def __init__(self, shape_zyx, m: int, offsets, coefs, layout: str = "flat"):
        if layout not in ("flat", "grid_last"):
            raise ValueError(f"layout must be 'flat' or 'grid_last', got {layout!r}")
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.m = int(m)
        self.offsets = tuple(offsets)  # flat ints ("flat") or zyx tuples ("grid_last")
        self.coefs = tuple(coefs)  # per-offset (m, m, N) or (m, m, nz, ny, nx)
        self.layout = layout

    @classmethod
    def from_blocks(cls, rows, cols, blocks, shape_xyz, *, device: torch.device,
                    dtype: torch.dtype, cells_per_site: int = 1):
        """rows/cols: block indices (nnzb,), blocks: (nnzb, m, m), e.g. a
        BSR's block COO. shape_xyz: the site grid's shape, sites numbered x
        fastest; cells_per_site consecutive block rows form one site."""
        check_real_dtype(dtype)
        blocks = np.asarray(blocks, dtype=np.float64)
        m = blocks.shape[-1]
        g = int(cells_per_site)
        shape_zyx, site_r, sub_r, sub_c, key = _site_couplings(rows, cols, shape_xyz, g)
        nz, ny, nx = shape_zyx
        N = nz * ny * nx
        M = g * m
        # each block entry's place in the (M, M, nz, ny, nx) coefficients,
        # summed by one bincount in input order: the JAX package's np.add.at
        # over its (site grid, sub_r, sub_c, m, m) array, without the
        # transposes to (M, M, grid)
        e = np.arange(m)
        offsets, coefs_np = [], []
        for k in np.unique(key):
            sel = key == k
            ri = sub_r[sel, None] * m + e  # (n, m) row in the site block
            cj = sub_c[sel, None] * m + e
            place = (ri[:, :, None] * M + cj[:, None, :]) * N + site_r[sel, None, None]
            C = np.bincount(place.reshape(-1), weights=blocks[sel].reshape(-1),
                            minlength=M * M * N)
            offsets.append(_offset_zyx(k))
            coefs_np.append(C.reshape((M, M) + shape_zyx))

        if cls._flat_safe(offsets, coefs_np, shape_zyx):
            # wrap-crossing layers all zero: flat rolls are exact
            flat_offsets = tuple(_flat_offset(off, shape_zyx) for off in offsets)
            coefs = [C.reshape(M, M, N) for C in coefs_np]
            return cls.from_arrays(shape_zyx, M, flat_offsets, coefs, "flat",
                                   device=device, dtype=dtype)
        return cls.from_arrays(shape_zyx, M, tuple(offsets), coefs_np, "grid_last",
                               device=device, dtype=dtype)

    @classmethod
    def from_arrays(cls, shape_zyx, m: int, offsets, coefs, layout: str, *,
                    device: torch.device, dtype: torch.dtype):
        """From the JAX operator's `coefs` as NumPy (same layout)."""
        check_real_dtype(dtype)
        offsets = tuple(int(o) if layout == "flat" else tuple(int(v) for v in o)
                        for o in offsets)
        return cls(shape_zyx, m, offsets, [_to(C, device, dtype) for C in coefs], layout)

    @staticmethod
    def _flat_safe(offsets, coefs_np, shape_zyx) -> bool:
        """True when, for every offset, the cells whose neighbour would wrap
        around an axis carry an all-zero coefficient block (wall/Neumann
        assemblies): a flat roll then differs from the per-axis rolls only
        where it is multiplied by zero."""
        for off, C in zip(offsets, coefs_np):  # C: (M, M, nz, ny, nx)
            for ax, o in enumerate(off):
                if o == 0:
                    continue
                idx = [slice(None)] * 5
                idx[2 + ax] = shape_zyx[ax] - 1 if o > 0 else 0
                if np.any(C[tuple(idx)]):
                    return False
        return True

    @classmethod
    def from_csr(cls, A, shape_xyz, dtype: torch.dtype | None = None,
                 cells_per_site: int = 1):
        """Scalar (m = 1) variant from a CSRMatrix."""
        sp = A.to_scipy().tocoo()
        return cls.from_blocks(sp.row, sp.col, sp.data.reshape(-1, 1, 1), shape_xyz,
                               device=A.data.device, dtype=dtype or A.data.dtype,
                               cells_per_site=cells_per_site)

    @classmethod
    def from_bsr(cls, A, shape_xyz, dtype: torch.dtype | None = None,
                 cells_per_site: int = 1):
        """Block variant from a BSRMatrix (its block COO)."""
        rows, cols, blocks = A.coo_numpy()
        return cls.from_blocks(rows, cols, blocks, shape_xyz, device=A.blocks.device,
                               dtype=dtype or A.blocks.dtype, cells_per_site=cells_per_site)

    # the m² multiply-adds are unrolled for small blocks only; a supercell's
    # (M = 24 for the tet wave system: 576 terms, some 4,000 launches per
    # apply unrolled) is one contraction per offset, the JAX package's
    # einsum. It is a product and a sum over j here: torch.einsum would run
    # it as a bmm over N strided 24×24 blocks, copying each of them per call
    _UNROLL_MAX = 8

    def _apply_gt(self, gt: torch.Tensor) -> torch.Tensor:
        """Core apply on the field-major gt (m, N) [flat] or (m, *grid)
        [grid_last]; the output has its shape."""
        m = self.m
        if m > self._UNROLL_MAX:
            y = torch.zeros_like(gt)
            for off, C in zip(self.offsets, self.coefs):
                y = y + (C * _neighbour(gt, off, self.layout).unsqueeze(0)).sum(dim=1)
            return y
        ys = [torch.zeros(gt.shape[1:], dtype=gt.dtype, device=gt.device) for _ in range(m)]
        for off, C in zip(self.offsets, self.coefs):
            nbr = _neighbour(gt, off, self.layout)
            for i in range(m):
                acc = ys[i]
                for j in range(m):
                    acc = acc + C[i, j] * nbr[j]
                ys[i] = acc
        return torch.stack(ys)


class SupercellStencilOperator:
    """Block-sparse SpMV for supercell meshes (cells_per_site = g > 1; the
    tet meshes: 6 tets per hex, site blocks 24×24 for the wave system).

    Most of the dense supercell form's coefficients are structural zeros:
    inside a hex only the tets that share a face couple (18 of the 36
    sub-blocks of the diagonal offset), and a hex face split into two
    triangles couples two tet pairs with the neighbouring hex. This class
    keeps, per offset, the non-zero (sub_row, sub_col) m×m sub-blocks,
    detected from the assembled coefficients (`from_blocks` on the host from
    the block COO, `from_varying` from the dense form), so any supercell
    pattern works. Its coefficients are the dense form's own.

    The apply is batched per offset: for each sub-row that has sub-blocks,
    its K sub-columns (fewer padded with zero blocks) are gathered from the
    rolled state and contracted with their coefficients in one product and
    one sum over (k, j); the sums are added into their sub-rows. The JAX
    package's apply adds the m·K terms of a sub-row one by one, so the two
    round differently (summation order only)."""

    def __init__(self, shape_zyx, m: int, g: int, offsets, pair_idx, rows, cols, coefs):
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.m = int(m)  # per-cell block size (dim+1)
        self.g = int(g)  # cells per site
        self.offsets = tuple(int(o) for o in offsets)  # flat ints, the diagonal included
        self.pair_idx = tuple(pair_idx)  # per offset: the (sub_r, sub_c) with data
        self.rows = tuple(rows)  # per offset: (R,) int64, the sub-rows with data
        self.cols = tuple(cols)  # per offset: (R, K) int64, their sub-columns
        self.coefs = tuple(coefs)  # per offset: (R, K, m, m, N), zero where padded

    @property
    def M(self) -> int:
        return self.m * self.g

    @classmethod
    def _packed(cls, shape_zyx, m: int, g: int, device, terms, tol: float = 0.0):
        """The operator from `terms`: per offset (flat int, in order), the
        dict (sub_row, sub_col) → its m×m coefficients over the sites, a host
        tensor (m, m, N) in the working dtype. Sub-blocks whose coefficients
        are all within `tol` of zero are dropped, and so are offsets left
        with none."""
        offsets, pair_idx, rows, cols, coefs = [], [], [], [], []
        for off, blocks in terms:
            pairs = sorted(p for p, C in blocks.items() if C.abs().max() > tol)
            if not pairs:
                continue
            sub_rows = sorted({sr for sr, _ in pairs})
            K = max(sum(1 for sr, _ in pairs if sr == r) for r in sub_rows)
            col = np.zeros((len(sub_rows), K), dtype=np.int64)
            C = torch.zeros((len(sub_rows), K) + blocks[pairs[0]].shape,
                            dtype=blocks[pairs[0]].dtype)
            for a, r in enumerate(sub_rows):
                for k, sc in enumerate(sc for sr, sc in pairs if sr == r):
                    col[a, k] = sc
                    C[a, k] = blocks[(r, sc)]
            offsets.append(int(off))
            pair_idx.append(tuple(pairs))
            rows.append(torch.as_tensor(sub_rows, dtype=torch.int64, device=device))
            cols.append(torch.as_tensor(col, device=device))
            coefs.append(C.to(device=device))
        return cls(shape_zyx, m, g, offsets, pair_idx, rows, cols, coefs)

    @classmethod
    def from_varying(cls, V: VaryingStencilOperator, m: int, g: int, tol: float = 0.0):
        """Decompose a flat-layout supercell VaryingStencilOperator (V.m ==
        m·g) into its non-zero m×m sub-blocks; None if V is not in that form."""
        if V.layout != "flat" or V.m != m * g:
            return None
        terms = []
        for off, Ct in zip(V.offsets, V.coefs):
            Cn = Ct.cpu()  # (M, M, N)
            terms.append((off, {(sr, sc): Cn[sr * m:(sr + 1) * m, sc * m:(sc + 1) * m]
                                for sr in range(g) for sc in range(g)}))
        return cls._packed(V.shape_zyx, m, g, V.coefs[0].device, terms, tol)

    @classmethod
    def from_blocks(cls, rows, cols, blocks, shape_xyz, g: int, *, device: torch.device,
                    dtype: torch.dtype):
        """From a block COO (rows, cols (nnzb,), blocks (nnzb, m, m)), g
        consecutive block rows a site, on the host: only the sub-blocks that
        the COO touches are assembled, and only the non-zero ones go to the
        device, so the dense (g·m)² form is made nowhere. None where a
        wrap-crossing boundary layer is coupled (a periodic grid: no flat
        layout). The same sub-blocks, coefficients and order as
        `from_varying` on the dense VaryingStencilOperator.from_blocks."""
        check_real_dtype(dtype)
        blocks = np.asarray(blocks, dtype=np.float64)
        m = blocks.shape[-1]
        shape_zyx, site_r, sub_r, sub_c, key = _site_couplings(rows, cols, shape_xyz, g)
        N = int(np.prod(shape_zyx))
        e = np.arange(m * m)
        terms = []
        for k in np.unique(key):
            sel = key == k
            pair = sub_r[sel] * g + sub_c[sel]
            present = np.unique(pair)
            # each entry's place in the (pairs, m, m, N) coefficients, summed
            # in input order, as the dense form sums them
            place = (np.searchsorted(present, pair)[:, None] * (m * m) + e) * N + site_r[sel, None]
            C = np.bincount(place.reshape(-1), weights=blocks[sel].reshape(-1),
                            minlength=len(present) * m * m * N).reshape((-1, m, m) + shape_zyx)
            off = _offset_zyx(k)
            if not VaryingStencilOperator._flat_safe([off], [C.reshape((-1, m) + shape_zyx)],
                                                     shape_zyx):
                return None
            Ct = torch.from_numpy(C.reshape(-1, m, m, N)).to(dtype)
            terms.append((_flat_offset(off, shape_zyx),
                          {(int(p) // g, int(p) % g): Ct[i] for i, p in enumerate(present)}))
        return cls._packed(shape_zyx, m, g, device, terms)

    @classmethod
    def from_bsr(cls, A, shape_xyz, g: int, dtype: torch.dtype | None = None):
        """From a BSRMatrix's block COO (`from_blocks`), on its device."""
        rows, cols, blocks = A.coo_numpy()
        return cls.from_blocks(rows, cols, blocks, shape_xyz, g, device=A.blocks.device,
                               dtype=dtype or A.blocks.dtype)

    def _apply_gt(self, gt: torch.Tensor) -> torch.Tensor:
        """gt (M, N_sites) field-major → the same shape; the device span
        "port.supercell". Counts in `STATS.supercell_plain`."""
        g, m = self.g, self.m
        STATS.supercell_plain += 1
        with device_span("port.supercell", gt.device):
            y = torch.zeros((g, m) + gt.shape[1:], dtype=gt.dtype, device=gt.device)
            for off, rows, cols, C in zip(self.offsets, self.rows, self.cols, self.coefs):
                nbr = (torch.roll(gt, -off, dims=1) if off else gt).reshape((g, m) + gt.shape[1:])
                x = nbr[cols]  # (R, K, m, N): each sub-row's sub-columns
                y.index_add_(0, rows, (C * x.unsqueeze(2)).sum(dim=(1, 3)))
            return y.reshape(gt.shape)

    def matvec_fm(self, g: torch.Tensor) -> torch.Tensor:
        """Field-major apply: g (M, N_sites) → the same shape."""
        return self._apply_gt(g)

    def matvec_fm_flat(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_gt(x.reshape(self.M, -1)).reshape(-1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Cell-major flat apply (site-interleaved rows, as the BSR)."""
        return self._apply_gt(x.reshape(-1, self.M).T).T.reshape(-1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)


class WaveNormalStencilOperator(_GridStencil):
    """Physics-structured wave-system SpMV: the off-diagonal upwind blocks
    are rank-structured, Am = s·(A − |A|)(n̂)/2 with A = [[0, c0²n̂ᵀ], [n̂, 0]],
    |A| = [[c0, 0], [0, c0·n̂n̂ᵀ]] (reference jacobianMatrices,
    src/WaveSystem.cxx:92-107), so each neighbour block is 1+dim numbers
    (s, n̂) instead of (dim+1)², applied as

        t = n̂·v_nbr
        out_p   += s·c0·(c0·t − p_nbr)/2
        out_vec += s·(p_nbr − c0·t)/2 · n̂

    The diagonal block stays dense (it gathers wall-mirror terms and face
    sums). Built by exact decomposition of a VaryingStencilOperator's blocks
    (flat or grid_last): `from_varying` returns None if any block deviates
    from the wave form. The flat `matvec_fm` is kernel K2's plain version."""

    def __init__(self, shape_zyx, c0: float, offsets, layout: str, arrays):
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.c0 = float(c0)
        self.offsets = tuple(offsets)  # flat ints or zyx tuples; diagonal excluded
        self.layout = layout  # "flat" or "grid_last"
        self.arrays = tuple(arrays)  # (diag (m,m,…), s (K,…), nvec (K,dim,…)), grid trailing

    @property
    def m(self) -> int:
        return int(self.arrays[0].shape[0])

    @classmethod
    def from_varying(cls, V: VaryingStencilOperator, c0: float, rtol: float = 1e-5):
        """Exact decomposition in float64 on the host; None if V is not a
        wave-form stencil."""
        if V.layout not in ("flat", "grid_last"):
            return None
        m = V.m
        dim = m - 1
        if dim not in (1, 2, 3):
            return None
        diag = None
        offs, s_list, n_list = [], [], []
        diag_key = 0 if V.layout == "flat" else (0,) * len(V.shape_zyx)
        for off, Ct in zip(V.offsets, V.coefs):
            C = Ct.detach().cpu().numpy().astype(np.float64).reshape(m, m, -1)
            if off == diag_key:
                diag = C
                continue
            s = -2.0 * C[0, 0] / c0
            sn = 2.0 * C[1:, 0]
            safe = np.where(np.abs(s) > 0, s, 1.0)
            n = sn / safe
            scale = np.abs(C).max() + 1e-300
            err = np.abs(C[0, 1:] - 0.5 * c0 * c0 * sn).max()
            err = max(err, np.abs(
                C[1:, 1:] + 0.5 * c0 * s * n[:, None, :] * n[None, :, :]).max())
            if err > rtol * scale:
                return None
            offs.append(off)
            s_list.append(s)
            n_list.append(n)
        if diag is None:
            return None
        shp = V.shape_zyx if V.layout == "grid_last" else (int(np.prod(V.shape_zyx)),)
        return cls.from_arrays(
            V.shape_zyx, c0, offs, V.layout,
            diag.reshape((m, m) + shp), np.stack(s_list).reshape((len(offs),) + shp),
            np.stack(n_list).reshape((len(offs), dim) + shp),
            device=V.coefs[0].device, dtype=V.coefs[0].dtype)

    @classmethod
    def from_arrays(cls, shape_zyx, c0: float, offsets, layout: str, diag, s, nvec, *,
                    device: torch.device, dtype: torch.dtype):
        """From the JAX operator's `arrays` (diag, s, nvec) as NumPy."""
        check_real_dtype(dtype)
        offsets = tuple(int(o) if layout == "flat" else tuple(int(v) for v in o)
                        for o in offsets)
        return cls(shape_zyx, c0, offsets, layout,
                   tuple(_to(a, device, dtype) for a in (diag, s, nvec)))

    def _apply_gt(self, gt: torch.Tensor) -> torch.Tensor:
        """Core apply on the field-major representation (its shape out)."""
        diag, s, nvec = self.arrays
        m = self.m
        dim = m - 1
        ys = []
        for i in range(m):
            acc = diag[i, 0] * gt[0]
            for j in range(1, m):
                acc = acc + diag[i, j] * gt[j]
            ys.append(acc)
        half_c0 = 0.5 * self.c0
        for k, off in enumerate(self.offsets):
            nbr = _neighbour(gt, off, self.layout)
            p = nbr[0]
            t = nvec[k, 0] * nbr[1]
            for d in range(1, dim):
                t = t + nvec[k, d] * nbr[1 + d]
            u = s[k] * (0.5 * p - half_c0 * t)  # s·(p − c0·t)/2
            ys[0] = ys[0] + half_c0 * s[k] * (self.c0 * t - p)
            for d in range(dim):
                ys[1 + d] = ys[1 + d] + u * nvec[k, d]
        return torch.stack(ys)


def _wave_block(s: np.ndarray, n: np.ndarray, c0: float) -> np.ndarray:
    """s·(A − |A|)(n̂)/2 (WaveNormalStencilOperator's coupling) from s (...,)
    and n̂ (..., dim, ...) with the entries' axes in front: (m, m, ...)."""
    dim = n.shape[0]
    C = np.empty((dim + 1, dim + 1) + s.shape)
    C[0, 0] = -0.5 * c0 * s
    C[1:, 0] = 0.5 * s * n
    C[0, 1:] = 0.5 * c0 * c0 * s * n
    C[1:, 1:] = -0.5 * c0 * s * n[:, None] * n[None, :]
    return C


class SupercellNormalOperator:
    """The wave system's normal form of the supercell stencil (cells_per_site
    g > 1; the tet meshes: 6 tets a hex): each tet's dense m×m diagonal block
    (wall mirrors and face sums included) and, for each of its F face slots,
    the coupling s·(A − |A|)(n̂)/2 of WaveNormalStencilOperator as (s, n̂),
    read at the flat site offset and sub-column that a table gives per
    (sub-row, slot), the same for every site. Field-major, site index last:

        diag (g, m, m, N), s (g, F, N), nvec (g, F, m−1, N);
        slot_offset, slot_col: per (sub-row, slot), Python ints, and K7's
        copy of them on the device, `table` (2, g, F) int32.

    A slot that couples nothing at a site (a face on the lattice's boundary,
    or a sub-row with fewer couplings than F) has s = 0 there. The apply, per
    tet k and site n, with v = x_col(k,f) at n + offset(k,f) (zero outside
    [0, N)):

        y_k = diag_k · x_k;   for each slot f:  t = n̂·v_vec,
        y_p += s·c0·(c0·t − p)/2,   y_vec += s·(p − c0·t)/2 · n̂

    On a CUDA tensor it is kernel K7 (ops/supercell_stencil.py), which
    counts in `STATS.supercell_fused`; `plain_fm`, the plain version, runs
    CPU tensors (`STATS.supercell_plain`). Both inside the device span
    "port.supercell". The JAX package has no such form: its tet route is the
    block-sparse SupercellStencilOperator, which this one equals up to the
    order of the sums."""

    def __init__(self, shape_zyx, m: int, g: int, c0: float, slot_offset, slot_col, arrays):
        self.shape_zyx = tuple(int(v) for v in shape_zyx)
        self.m = int(m)  # per-cell block size (dim+1)
        self.g = int(g)  # cells per site
        self.c0 = float(c0)
        self.slot_offset = tuple(tuple(int(o) for o in r) for r in slot_offset)  # (g, F) flat
        self.slot_col = tuple(tuple(int(c) for c in r) for r in slot_col)  # (g, F) sub-columns
        self.arrays = tuple(arrays)  # (diag, s, nvec)
        # K7's copy of the slot table: (2, g, F) int32, offsets then sub-columns
        self.table = torch.tensor([self.slot_offset, self.slot_col], dtype=torch.int32,
                                  device=self.arrays[0].device)
        self._pad = max((abs(o) for r in self.slot_offset for o in r), default=0)

    @property
    def M(self) -> int:
        return self.m * self.g

    @property
    def F(self) -> int:
        return len(self.slot_offset[0]) if self.slot_offset else 0

    @property
    def N(self) -> int:
        return int(np.prod(self.shape_zyx))

    @classmethod
    def from_blocks(cls, rows, cols, blocks, shape_xyz, g: int, c0: float, *,
                    device: torch.device, dtype: torch.dtype, rtol: float = 1e-5):
        """From a block COO (rows, cols (nnzb,), blocks (nnzb, m, m)), g
        consecutive block rows a site, in float64 on the host: only the
        tables reach the device. F is the most couplings of any sub-row (the
        union over the sites). None where a wrap couples the grid (a periodic
        mesh) or where an off-diagonal sub-block deviates from
        s·(A − |A|)(n̂)/2 by more than rtol × the largest entry of its slot
        (the test of WaveNormalStencilOperator.from_varying, on the whole
        block). K7's own limits are the wrapper's to check, at the launch."""
        check_real_dtype(dtype)
        blocks = np.asarray(blocks, dtype=np.float64)
        m, g = blocks.shape[-1], int(g)
        dim = m - 1
        shape_zyx, site_r, sub_r, sub_c, key = _site_couplings(rows, cols, shape_xyz, g)
        N = int(np.prod(shape_zyx))
        nonzero = blocks.reshape(len(blocks), -1).any(axis=1)
        _, ny, nx = shape_zyx
        flat = (key // 9 - 1) * ny * nx + ((key // 3) % 3 - 1) * nx + key % 3 - 1
        if np.any(nonzero & (site_r + flat != np.asarray(cols, dtype=np.int64) // g)):
            return None  # a coupling across a wrap: no flat layout
        on_diag = (key == 13) & (sub_r == sub_c)
        coupled = nonzero & ~on_diag
        code = key * g + sub_c  # (offset, sub-column) of a coupling
        codes = [np.unique(code[coupled & (sub_r == r)]) for r in range(g)]
        F = max(len(c) for c in codes)
        slot_offset, slot_col = np.zeros((g, F), np.int64), np.tile(np.arange(g)[:, None], F)
        for r, cr in enumerate(codes):
            slot_col[r, :len(cr)] = cr % g
            slot_offset[r, :len(cr)] = [_flat_offset(_offset_zyx(k), shape_zyx) for k in cr // g]

        e = np.arange(m * m)
        place = ((sub_r[on_diag] * (m * m))[:, None] + e) * N + site_r[on_diag, None]
        diag = np.bincount(place.reshape(-1), weights=blocks[on_diag].reshape(-1),
                           minlength=g * m * m * N).reshape(g, m, m, N)
        s = np.zeros((g, F, N))
        nvec = np.zeros((g, F, dim, N))
        for r, cr in enumerate(codes):
            sel = coupled & (sub_r == r)
            slot = np.searchsorted(cr, code[sel])
            place = ((slot * (m * m))[:, None] + e) * N + site_r[sel, None]
            C = np.bincount(place.reshape(-1), weights=blocks[sel].reshape(-1),
                            minlength=len(cr) * m * m * N).reshape(len(cr), m, m, N)
            C = np.moveaxis(C, 0, 2)  # (m, m, slots, N)
            sr = -2.0 * C[0, 0] / c0
            n = 2.0 * C[1:, 0] / np.where(sr != 0, sr, 1.0)
            err = np.abs(C - _wave_block(sr, n, c0)).max(axis=(0, 1, 3))
            if np.any(err > rtol * (np.abs(C).max(axis=(0, 1, 3)) + 1e-300)):
                return None
            s[r, :len(cr)] = sr
            nvec[r, :len(cr)] = np.moveaxis(n, 0, 1)
        return cls(shape_zyx, m, g, c0, slot_offset, slot_col,
                   tuple(_to(a, device, dtype) for a in (diag, s, nvec)))

    def plain_fm(self, gt: torch.Tensor) -> torch.Tensor:
        """K7's plain version: gt (M, N) field-major → (M, N), in PyTorch."""
        diag, s, nvec = self.arrays
        g, m, N, P = self.g, self.m, gt.shape[-1], self._pad
        x = gt.reshape(g, m, N)
        xp = torch.nn.functional.pad(x, (P, P)) if P else x  # zero outside [0, N)
        v = torch.stack([torch.stack([xp[c, :, P + o:P + o + N]
                                      for o, c in zip(offs, cols)])
                         for offs, cols in zip(self.slot_offset, self.slot_col)])  # (g, F, m, N)
        p, t = v[:, :, 0], (nvec * v[:, :, 1:]).sum(dim=2)
        half_c0 = 0.5 * self.c0
        y = (diag * x.unsqueeze(1)).sum(dim=2)  # (g, m, N)
        y_p = y[:, 0] + (half_c0 * s * (self.c0 * t - p)).sum(dim=1)
        y_v = y[:, 1:] + ((s * (0.5 * p - half_c0 * t)).unsqueeze(2) * nvec).sum(dim=1)
        return torch.cat([y_p.unsqueeze(1), y_v], dim=1).reshape(gt.shape)

    def _apply_gt(self, gt: torch.Tensor) -> torch.Tensor:
        """gt (M, N_sites) field-major → the same shape: K7 on the card, the
        plain version on the CPU; the device span "port.supercell"."""
        with device_span("port.supercell", gt.device):
            return supercell_stencil.apply(self, gt)

    def matvec_fm(self, g: torch.Tensor) -> torch.Tensor:
        """Field-major apply: g (M, N_sites) → the same shape."""
        return self._apply_gt(g)

    def matvec_fm_flat(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_gt(x.reshape(self.M, -1)).reshape(-1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Cell-major flat apply (site-interleaved rows, as the BSR): one
        relayout pair around the field-major apply."""
        return self._apply_gt(x.reshape(-1, self.M).T.contiguous()).T.reshape(-1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)
