"""Linear transport equation ∂t u + a·∇u = 0 — problem class and steppers
(PyTorch counterpart of circulantpreconditioner_tpu/models/transport.py).

- spherical-explosion initial condition (650 inside r < 0.3 of the domain
  centre, else 600);
- dt = cfl · minRatioVolSurf / ‖a‖;
- three solve paths: explicit SpMV stepping, implicit GMRES, and the direct
  circulant FFT solve with the spectrum cached on the device.

Steppers are callables U → (U_new, dnorm[, iters, resnorm, converged]). The
explicit and direct ones are captured steps (utils/graphs.CapturedStep), the
counterparts of the JAX package's jitted `_explicit_step_impl` and
`_direct_step_impl`: CUDA graphs on the card, eager on the CPU.
"""

from __future__ import annotations

import functools
from functools import cached_property

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.mesh.core import Mesh
from circulantpreconditioner_tpu_torch.ops.assembly import transport_divergence_csr
from circulantpreconditioner_tpu_torch.ops.circulant import CirculantTransportOperator
from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix
from circulantpreconditioner_tpu_torch.solvers.gmres import make_gmres
from circulantpreconditioner_tpu_torch.utils.device import check_real_dtype
from circulantpreconditioner_tpu_torch.utils.graphs import CapturedStep
from circulantpreconditioner_tpu_torch.utils.profiling import device_span, host_spanned


def spherical_explosion_scalar(mesh: Mesh, inside: float = 650.0, outside: float = 600.0,
                               rmax: float = 0.3) -> np.ndarray:
    """`inside` within radius rmax of the domain centre, else `outside`."""
    bbox = mesh.bbox()
    center = bbox.mean(axis=1)
    r = np.linalg.norm(mesh.cell_center - center[None, :], axis=1)
    return np.where(r < rmax, inside, outside)


def _explicit_step(D, u):
    du = D(u)
    return u - du, torch.linalg.norm(du)


def _direct_step(solver, u):
    u1 = solver.solve(u.reshape(solver.shape_zyx)).reshape(-1)
    return u1, torch.linalg.norm(u1 - u)


def _identity_plus(D, u):
    """The implicit operator I + D: the device span "port.op"."""
    with device_span("port.op", u.device):
        return u + D(u)


class TransportEquation:
    def __init__(self, mesh: Mesh, velocity, cfl: float | None = None, dt: float | None = None,
                 *, device: torch.device, dtype: torch.dtype, boundary: str = "auto"):
        self.mesh = mesh
        self.dim = mesh.dim
        self.velocity = np.asarray(velocity, dtype=np.float64)[: mesh.dim]
        self.device = torch.device(device)
        self.dtype = check_real_dtype(dtype)
        self.boundary = boundary
        if dt is not None:
            self.dt = float(dt)
        else:
            if cfl is None:
                cfl = 1e3 / mesh.dim  # reference default
            self.dt = float(cfl * mesh.min_ratio_vol_surf() / np.linalg.norm(self.velocity))

    def initial_state(self) -> torch.Tensor:
        return torch.as_tensor(spherical_explosion_scalar(self.mesh)).to(
            device=self.device, dtype=self.dtype)

    @cached_property
    @host_spanned("port.setup.operator")
    def divergence(self) -> CSRMatrix:
        """D such that (I + D)uⁿ⁺¹ = uⁿ (implicit) / uⁿ⁺¹ = uⁿ − D uⁿ (explicit)."""
        return transport_divergence_csr(self.mesh, self.dt, self.velocity, device=self.device,
                                        dtype=self.dtype, boundary=self.boundary)

    @cached_property
    @host_spanned("port.setup.operator")
    def fft_operator(self) -> CirculantTransportOperator:
        """The circulant direct solver for I + D on a structured grid, taken
        as periodic whatever its boundary groups (as the reference FFT driver)."""
        if not self.mesh.is_structured:
            raise ValueError("fft_operator requires a structured mesh")
        return CirculantTransportOperator.from_transport(
            self.mesh.structured_shape, self.velocity, self.dt,
            np.asarray(self.mesh.spacing), device=self.device, dtype=self.dtype)  # type: ignore[attr-defined]

    def _stencil_bc(self) -> str | None:
        """'periodic' / 'neumann' when the structured mesh supports the
        stencil fast path (non-Periodic boundary groups are all no-ops in the
        transport assembly, i.e. Neumann-equivalent)."""
        if not self.mesh.is_structured:
            return None
        codes = set(np.unique(self.mesh.face_group)) - {0}
        names = {n for n, c in self.mesh.groups.items() if c in codes}
        if names <= {"Periodic"}:
            return "periodic"
        if "Periodic" not in names:
            return "neumann"
        return None  # mixed periodic/non-periodic axes: use the matrix

    @cached_property
    def stencil_operator(self):
        from circulantpreconditioner_tpu_torch.ops.stencil import TransportStencilOperator

        bc = self._stencil_bc()
        if bc is None:
            raise ValueError("stencil operator needs a structured mesh with "
                             "homogeneous (all-periodic or no-periodic) boundaries")
        return TransportStencilOperator.create(
            self.mesh.structured_shape, self.velocity, self.dt,
            self.mesh.spacing, bc=bc)  # type: ignore[attr-defined]

    def divergence_op(self, operator: str = "auto"):
        """D as a callable: 'stencil' (structured fast path), 'varying'
        (gather-free stencil on topologically structured meshes such as
        Kershaw; on the tet meshes the dense supercell form), 'window' (clustered dense windows), 'matrix' (assembled
        CSR), or 'auto' (same choice as the JAX model)."""
        if operator == "auto":
            if self._stencil_bc():
                operator = "stencil"
            elif getattr(self.mesh, "topology_shape", None) is not None:
                operator = "varying"
            elif getattr(self.mesh, "bandwidth_ordered", False):
                operator = "window"
            else:
                operator = "matrix"
        if operator == "varying":
            from circulantpreconditioner_tpu_torch.ops.stencil import VaryingStencilOperator

            return VaryingStencilOperator.from_csr(
                self.divergence, self.mesh.topology_shape,  # type: ignore[attr-defined]
                cells_per_site=getattr(self.mesh, "cells_per_site", 1)).matvec
        if operator == "window":
            from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator

            return WindowedBlockOperator.from_csr(self.divergence, dtype=self.dtype).matvec
        if operator == "stencil":
            return self.stencil_operator.matvec
        if operator == "matrix":
            return self.divergence.matvec
        raise ValueError(f"unknown operator {operator!r}")

    # --- steppers -----------------------------------------------------------
    def explicit_stepper(self, operator: str = "auto") -> CapturedStep:
        return CapturedStep(functools.partial(_explicit_step, self.divergence_op(operator)))

    def implicit_matvec(self, operator: str = "auto"):
        """A = I + D as a callable."""
        return functools.partial(_identity_plus, self.divergence_op(operator))

    def implicit_stepper(self, M=None, rtol: float = 1e-5, atol: float = 1e-5,
                         maxiter: int = 1000, restart: int = 30, side: str = "left",
                         operator: str = "auto"):
        """GMRES per step (reference: GMRES + PCNONE); pass M for a
        preconditioner. side="right" stops only where ‖b − A x‖ meets the
        tolerance (GMRES's true_residual): with the circulant PC of the wall
        cube in float32 the estimate meets rtol where ‖b − A x‖ lies 30 times
        (fp32) to 3,000 times (K4's bf16×3) above it."""
        solver = make_gmres(self.implicit_matvec(operator), M, restart=restart, rtol=rtol,
                            atol=atol, maxiter=maxiter, side=side,
                            true_residual=side == "right")

        def step(u):
            res = solver(u, u)
            return res.x, torch.linalg.norm(res.x - u), res.iters, res.resnorm, res.converged

        return step

    def fft_stepper(self, method: str = "auto") -> CapturedStep:
        """Direct circulant solve per step, spectrum cached on the device.

        method: "fft" (torch.fft, cuFFT on the GPU), "matmul" (staged
        DFT-by-matmul), or "auto" — the JAX rule, which takes "matmul" only on
        a TPU, so "fft" here."""
        op = self.fft_operator
        if method == "auto":
            method = "fft"
        if method == "matmul":
            from circulantpreconditioner_tpu_torch.ops.dft_matmul import MatmulCirculantSolver

            solver = MatmulCirculantSolver.from_operator(op)
        elif method == "fft":
            solver = op
        else:
            raise ValueError(f"method must be auto/fft/matmul, got {method!r}")
        return CapturedStep(functools.partial(_direct_step, solver))
