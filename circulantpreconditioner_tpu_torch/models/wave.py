"""Linear wave system ∂t(p, q) + div F = 0: problem class and steppers
(PyTorch counterpart of circulantpreconditioner_tpu/models/wave.py).

- constants p0 = 155e5, c0 = 700 (reference src/WaveSystem.hxx:16-19);
- spherical-explosion initial condition: p = 155e5 inside r < 0.3 of the
  domain centre, else 70e5, velocity 0 (WaveSystem.cxx:25-76);
- dt = cfl · minRatioVolSurf / c0;
- the block upwind divergence D (ops/assembly.py) with Wall, Periodic and
  Neumann boundaries, in six forms: the assembled BSR, the cartesian
  stencil, the varying stencil, its wave normal form (one cell per grid
  site) and, on the tet meshes (6 cells per site), the supercell normal
  form (kernel K7 on the card) or, where D does not decompose, the
  block-sparse supercell stencil;
- explicit stepping Uⁿ⁺¹ = Uⁿ − D Uⁿ and implicit GMRES on (I + D), cell-major
  or field-major. Field-major keeps the state as (fm_block, nSites)
  (flattened for GMRES) so no matvec pays an (N, m) ↔ (m, N) relayout; on a
  CUDA device the field-major D is kernel K2 (ops/plane_stencil.py) whenever
  the operator fits its contract. On the tet meshes D is the supercell
  normal form in both layouts, decomposed on the host from D's blocks
  (the dense M = 24 one stays as operator 'varying'), and GMRES runs
  field-major on the (24, nSites) view; the JAX package runs it cell-major
  over the dense stencil there;
- direct steppers on cartesian grids: the block-circulant solve on periodic
  grids (`block_fft_stepper`) and the DCT/DST solve on wall grids
  (`dct_fft_stepper`, `dct_fft_stepper_fm`).

The explicit and direct steppers are captured steps (utils/graphs.
CapturedStep), the counterparts of the JAX package's jitted
`_explicit_step_impl`, `_blockfft_step_impl` and `_dctfft_step_fm_impl`.
"""

from __future__ import annotations

import functools
from functools import cached_property

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.mesh.core import Mesh
from circulantpreconditioner_tpu_torch.models.transport import _explicit_step, _identity_plus
from circulantpreconditioner_tpu_torch.ops.assembly import wave_block_stencil, wave_divergence_bsr
from circulantpreconditioner_tpu_torch.ops.circulant import BlockCirculantOperator
from circulantpreconditioner_tpu_torch.ops.csr import BSRMatrix
from circulantpreconditioner_tpu_torch.solvers.gmres import make_gmres
from circulantpreconditioner_tpu_torch.utils.device import check_real_dtype
from circulantpreconditioner_tpu_torch.utils.graphs import CapturedStep
from circulantpreconditioner_tpu_torch.utils.profiling import host_spanned

P0 = 155e5  # reference pressure (pressurised vessel), WaveSystem.hxx:16
C0 = 700.0  # sound speed, WaveSystem.hxx:17


def spherical_explosion_wave(mesh: Mesh, p_in: float = P0, p_out: float = 70e5,
                             rmax: float = 0.3) -> np.ndarray:
    """(nC, dim+1) state: pressure and zero velocity (WaveSystem.cxx:25-76)."""
    center = mesh.bbox().mean(axis=1)
    r = np.linalg.norm(mesh.cell_center - center[None, :], axis=1)
    U = np.zeros((mesh.n_cells, mesh.dim + 1))
    U[:, 0] = np.where(r < rmax, p_in, p_out)
    return U


def _direct_step(op, U):
    U1 = op.solve(U)
    return U1, torch.linalg.norm(U1 - U)


def _direct_step_fm(op, G):
    """Field-major direct step: G (nb, nC) or flat."""
    G1 = op.solve_fm(G.reshape((op.nb,) + op.shape_zyx)).reshape(G.shape)
    return G1, torch.linalg.norm(G1 - G)


class WaveSystem:
    def __init__(self, mesh: Mesh, c0: float = C0, cfl: float | None = None,
                 dt: float | None = None, *, device: torch.device, dtype: torch.dtype):
        self.mesh = mesh
        self.dim = mesh.dim
        self.c0 = float(c0)
        self.nb = mesh.dim + 1
        self.device = torch.device(device)
        self.dtype = check_real_dtype(dtype)
        if dt is not None:
            self.dt = float(dt)
        else:
            if cfl is None:
                cfl = 1.0 / mesh.dim  # explicit-driver default (..._expl_seq.cxx:177)
            self.dt = float(cfl * mesh.min_ratio_vol_surf() / self.c0)

    def initial_state(self) -> torch.Tensor:
        """Flat cell-major state (nC·(dim+1),), the reference's interleaved
        j·nbComp + comp layout."""
        return torch.as_tensor(spherical_explosion_wave(self.mesh).reshape(-1)).to(
            device=self.device, dtype=self.dtype)

    @cached_property
    @host_spanned("port.setup.operator")
    def divergence(self) -> BSRMatrix:
        return wave_divergence_bsr(self.mesh, self.dt, self.c0, device=self.device,
                                   dtype=self.dtype)

    def _homogeneous_bc(self) -> str | None:
        """'wall' / 'periodic' when the structured mesh has uniform boundary
        groups (the cartesian stencil's requirement), else None."""
        if not self.mesh.is_structured:
            return None
        codes = set(np.unique(self.mesh.face_group)) - {0}
        names = {n for n, c in self.mesh.groups.items() if c in codes}
        if names <= {"Wall"}:
            return "wall"
        if names <= {"Periodic"}:
            return "periodic"
        return None

    @cached_property
    def stencil_operator(self):
        """Gather-free stencil form of D on cartesian grids (ops/stencil.py)."""
        from circulantpreconditioner_tpu_torch.ops.stencil import WaveStencilOperator

        bc = self._homogeneous_bc()
        if bc is None:
            raise ValueError("stencil operator needs a structured mesh with "
                             "homogeneous Wall or Periodic boundaries")
        return WaveStencilOperator.from_model(self, bc=bc)

    @property
    def cells_per_site(self) -> int:
        return int(getattr(self.mesh, "cells_per_site", 1))

    @cached_property
    @host_spanned("port.setup.operator")
    def varying_operator(self):
        """D as a VaryingStencilOperator on the mesh's topology grid (of
        sites: M = (dim+1)·cells_per_site). Built once: at 64³ the host build
        takes seconds, and the cell-major, field-major and preconditioner
        paths all share it. On a supercell mesh it is the dense form, which
        only the operator 'varying' asks for."""
        from circulantpreconditioner_tpu_torch.ops.stencil import VaryingStencilOperator

        return VaryingStencilOperator.from_bsr(
            self.divergence, self.mesh.topology_shape,  # type: ignore[attr-defined]
            cells_per_site=self.cells_per_site)

    @cached_property
    @host_spanned("port.setup.operator")
    def normal_operator(self):
        """The wave normal form of `varying_operator`, or None where the
        decomposition fails or a site holds several cells."""
        from circulantpreconditioner_tpu_torch.ops.stencil import WaveNormalStencilOperator

        if self.cells_per_site != 1:
            return None
        return WaveNormalStencilOperator.from_varying(self.varying_operator, self.c0)

    @cached_property
    @host_spanned("port.setup.operator")
    def supercell_operator(self):
        """D on a supercell mesh: its wave normal form
        (SupercellNormalOperator, kernel K7 on the card) where every
        off-diagonal sub-block decomposes, else the block-sparse
        SupercellStencilOperator; None where a periodic wrap couples the grid
        (no flat layout). Decomposed on the host from D's block COO, so
        neither the dense form (2.0 GB in float32 at Kershaw-tet 50³) nor,
        when the normal form is taken, the block-sparse one (240 MB against
        its 96 MB) is made on the device."""
        from circulantpreconditioner_tpu_torch.ops.stencil import (
            SupercellNormalOperator,
            SupercellStencilOperator,
        )

        rows, cols, blocks = self.divergence.coo_numpy()
        shape, g = self.mesh.topology_shape, self.cells_per_site  # type: ignore[attr-defined]
        where = dict(device=self.divergence.blocks.device, dtype=self.divergence.blocks.dtype)
        S = SupercellNormalOperator.from_blocks(rows, cols, blocks, shape, g, self.c0, **where)
        if S is not None:
            return S
        return SupercellStencilOperator.from_blocks(rows, cols, blocks, shape, g, **where)

    def divergence_op(self, operator: str = "auto"):
        """D as a callable on flat cell-major vectors: 'stencil' (cartesian),
        'varying' (gather-free stencil on topologically structured meshes,
        in its wave normal form where it decomposes; the dense form on a
        supercell mesh), 'normal' (that normal form or raise), 'matrix'
        (assembled BSR), or 'auto', which on a supercell mesh is
        `supercell_operator` where the stencil is flat."""
        if operator == "auto":
            if self._homogeneous_bc():
                operator = "stencil"
            elif getattr(self.mesh, "topology_shape", None) is not None:
                S = self.supercell_operator if self.cells_per_site != 1 else None
                if S is not None:
                    return S.matvec
                operator = "varying"
            elif getattr(self.mesh, "bandwidth_ordered", False):
                operator = "window"
            else:
                operator = "matrix"
        if operator == "stencil":
            return self.stencil_operator.matvec
        if operator == "window":
            from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator

            return WindowedBlockOperator.from_bsr(self.divergence, dtype=self.dtype).matvec
        if operator in ("varying", "normal"):
            Wn = self.normal_operator
            if Wn is not None:
                return Wn.matvec
            if operator == "normal":
                raise ValueError("wave normal-form decomposition failed for this mesh")
            return self.varying_operator.matvec
        if operator == "matrix":
            return self.divergence.matvec
        raise ValueError(f"unknown operator {operator!r}")

    def divergence_op_fm(self, operator: str = "auto", flat: bool = False):
        """Field-major D: input and output (fm_block, nSites), or flat vectors
        with flat=True (for Krylov solvers). None when the mesh has no
        gather-free stencil form. On a CUDA device the normal form runs in
        kernel K2 when the operator fits its contract (the JAX package takes
        its Pallas kernel on the TPU at the same point); K2's matvec takes
        either shape. On a supercell mesh D is `supercell_operator` (K7 on
        the card where it is the normal form) where the stencil is flat,
        else the dense varying one."""
        if operator == "auto":
            operator = ("varying" if getattr(self.mesh, "topology_shape", None) is not None
                        else "matrix")
        if operator not in ("varying", "normal"):
            return None
        if self.cells_per_site != 1:
            if operator == "normal":
                raise ValueError("wave normal-form decomposition failed for this mesh")
            try:
                S = self.supercell_operator
            except ValueError:  # not a 7-point stencil of sites
                return None
            op = S if S is not None else self.varying_operator
            return op.matvec_fm_flat if flat else op.matvec_fm
        try:
            V = self.varying_operator
        except ValueError:
            # topology_shape is set but the operator is not a 7-point
            # face-neighbour stencil: None for probing callers, raise for an
            # explicit 'normal' request
            if operator == "normal":
                raise
            return None
        Wn = self.normal_operator
        if Wn is not None:
            if self.device.type == "cuda":
                from circulantpreconditioner_tpu_torch.ops.plane_stencil import (
                    make_plane_stencil_matvec,
                )

                mv = make_plane_stencil_matvec(Wn)
                if mv is not None:
                    return mv
            return Wn.matvec_fm_flat if flat else Wn.matvec_fm
        if operator == "normal":
            raise ValueError("wave normal-form decomposition failed for this mesh")
        return V.matvec_fm_flat if flat else V.matvec_fm

    @property
    def fm_block(self) -> int:
        """Field-major granularity: dim+1 components per cell, times the
        cells of a site on supercell meshes (tet meshes: 6 cells per site,
        a 24-row field view)."""
        return self.nb * self.cells_per_site

    def pack_fm(self, U) -> torch.Tensor:
        """Flat cell-major state → field-major (fm_block, nSites), on the
        model's device."""
        U = torch.as_tensor(U).to(device=self.device, dtype=self.dtype)
        return U.reshape(-1, self.fm_block).T.contiguous()

    def unpack_fm(self, G):
        """Field-major (fm_block, nSites) or flat → flat cell-major, on the
        same device (a NumPy input gives a NumPy output)."""
        out = G.reshape(self.fm_block, -1).T.reshape(-1)
        return out.contiguous() if isinstance(out, torch.Tensor) else out

    @cached_property
    def block_circulant_operator(self) -> BlockCirculantOperator:
        """Direct block-circulant solver of I + D on a periodic structured grid."""
        if not self.mesh.is_structured:
            raise ValueError("block_circulant_operator requires a structured mesh")
        offsets, blocks = wave_block_stencil(self.dim, self.dt, self.c0,
                                             np.asarray(self.mesh.spacing))  # type: ignore[attr-defined]
        return BlockCirculantOperator.from_stencil(
            tuple(reversed(self.mesh.structured_shape)), offsets, blocks, device=self.device,
            dtype=self.dtype)

    def block_fft_stepper(self, method: str = "auto") -> CapturedStep:
        """Block-circulant direct solve per step (periodic structured grids).
        method: "fft" (torch.fft, cuFFT on the GPU), "matmul" (staged DFT by
        matmul), or "auto" — the JAX rule, which takes "matmul" only on a
        TPU, so "fft" here."""
        if method == "auto":
            method = "fft"
        if method == "matmul":
            from circulantpreconditioner_tpu_torch.ops.dft_matmul import (
                MatmulBlockCirculantSolver,
            )

            offsets, blocks = wave_block_stencil(self.dim, self.dt, self.c0,
                                                 np.asarray(self.mesh.spacing))  # type: ignore[attr-defined]
            op = MatmulBlockCirculantSolver.from_stencil(
                tuple(reversed(self.mesh.structured_shape)), offsets, blocks,
                device=self.device, dtype=self.dtype)
        elif method == "fft":
            op = self.block_circulant_operator
        else:
            raise ValueError(f"method must be auto/fft/matmul, got {method!r}")
        return CapturedStep(functools.partial(_direct_step, op))

    def _dct_solver(self):
        from circulantpreconditioner_tpu_torch.ops.dct_wave import DCTBlockWaveSolver

        if self._homogeneous_bc() != "wall":
            raise ValueError("dct_fft_stepper needs a structured mesh with uniform Wall "
                             "boundaries")
        return DCTBlockWaveSolver.create(
            tuple(reversed(self.mesh.structured_shape)), self.dim, self.dt, self.c0,  # type: ignore[arg-type]
            self.mesh.spacing, device=self.device, dtype=self.dtype)  # type: ignore[attr-defined]

    def dct_fft_stepper(self) -> CapturedStep:
        """Direct wall-boundary solve of (I + D)Uⁿ⁺¹ = Uⁿ by the exact DCT/DST
        block diagonalisation (ops/dct_wave.py), on the flat cell-major state."""
        return CapturedStep(functools.partial(_direct_step, self._dct_solver()))

    def dct_fft_stepper_fm(self) -> CapturedStep:
        """The same on the field-major state (nb, nC) or its flat view: no
        (…, nb) ↔ (nb, …) relayout per step."""
        return CapturedStep(functools.partial(_direct_step_fm, self._dct_solver()))

    # --- steppers -----------------------------------------------------------
    def explicit_stepper(self, operator: str = "auto") -> CapturedStep:
        return CapturedStep(functools.partial(_explicit_step, self.divergence_op(operator)))

    def explicit_stepper_fm(self, operator: str = "auto") -> CapturedStep | None:
        """Field-major explicit stepper, or None when the mesh has no
        gather-free stencil form. The state is (dim+1, nC): pack_fm /
        unpack_fm at the I/O boundaries."""
        D = self.divergence_op_fm(operator)
        if D is None:
            return None
        return CapturedStep(functools.partial(_explicit_step, D))

    def implicit_matvec(self, operator: str = "auto"):
        """A = I + D on flat cell-major vectors."""
        return functools.partial(_identity_plus, self.divergence_op(operator))

    def implicit_stepper(self, M=None, rtol: float = 1e-5, atol: float = 1e-5,
                         maxiter: int = 1000, restart: int = 30, side: str = "left",
                         operator: str = "auto"):
        """GMRES per step (the reference: + ILU seq / BJACOBI mpi; any M here)."""
        solver = make_gmres(self.implicit_matvec(operator), M, restart=restart, rtol=rtol,
                            atol=atol, maxiter=maxiter, side=side)

        def step(U):
            res = solver(U, U)
            return res.x, torch.linalg.norm(res.x - U), res.iters, res.resnorm, res.converged

        return step

    def implicit_matvec_fm(self, operator: str = "auto"):
        """I + D on field-major flat vectors, or None when the mesh has no
        gather-free stencil form. On a supercell mesh the field view is
        (fm_block, nSites), fm_block = cells_per_site·(dim+1): the per-cell
        preconditioners take it by `cells_per_site` (pbjacobi_fm) and
        `fm_block` (cell_major_adapter)."""
        D = self.divergence_op_fm(operator, flat=True)
        if D is None:
            return None
        return functools.partial(_identity_plus, D)

    def implicit_stepper_fm(self, M_cm=None, M_fm=None, rtol: float = 1e-5,
                            atol: float = 1e-5, maxiter: int = 1000, restart: int = 30,
                            side: str = "left", operator: str = "auto"):
        """Field-major GMRES implicit stepper (flat field-major state), or
        None when no gather-free stencil form exists. M_cm: a cell-major
        preconditioner, wrapped with one relayout pair per apply; M_fm: a
        field-major one on the (fm_block, nSites) view (e.g. pbjacobi_fm with
        the mesh's cells_per_site); both given: their sum."""
        from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs

        A = self.implicit_matvec_fm(operator)
        if A is None:
            return None
        terms = []
        if M_cm is not None:
            terms.append(pcs.cell_major_adapter(M_cm, self.fm_block))
        if M_fm is not None:
            terms.append(M_fm)
        M = pcs.additive(*terms) if len(terms) > 1 else (terms[0] if terms else None)
        solver = make_gmres(A, M, restart=restart, rtol=rtol, atol=atol, maxiter=maxiter,
                            side=side)

        def step(G):
            res = solver(G, G)
            return res.x, torch.linalg.norm(res.x - G), res.iters, res.resnorm, res.converged

        return step

    def split_fields(self, U) -> tuple[np.ndarray, np.ndarray]:
        """Flat cell-major state → (pressure (nC,), velocity (nC, dim)) host arrays."""
        Un = (U.detach().cpu().numpy() if isinstance(U, torch.Tensor)
              else np.asarray(U)).reshape(-1, self.nb)
        return Un[:, 0], Un[:, 1:]
