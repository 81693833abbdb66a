"""Diffusion (heat) equation ∂t u = ν ∇²u: problem class and steppers
(PyTorch counterpart of circulantpreconditioner_tpu/models/diffusion.py).

- the TPFA finite-volume operator D = dt·ν·L (ops/assembly.py::diffusion_csr),
  applied as a gather-free varying stencil on meshes whose topology is a
  grid, else as the CSR matvec;
- implicit Euler by CG (I + D is SPD) or GMRES, and explicit Euler;
- the FFT direct solve on a periodic uniform grid: the diffusive symbol
  1 + Σ_d 2λ_d(1 − cos θ_d), λ_d = ν·dt/h_d², by the m = 1 staged DFT
  (ops/dft_matmul.py::MatmulBlockCirculantSolver), as in the JAX package;
- exact solutions: a periodic Fourier mode decays by 1/(1 + dt·λ_h(k)) per
  implicit step, λ_h the symbol of the discrete operator.

Steppers are callables u → (u_new, dnorm[, iters, resnorm, converged]); the
explicit and FFT ones are captured steps (utils/graphs.CapturedStep): CUDA
graphs on the card, as the JAX package's steps are jitted.
"""

from __future__ import annotations

import functools
from functools import cached_property

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.mesh.core import Mesh
from circulantpreconditioner_tpu_torch.models.transport import (
    _direct_step,
    _explicit_step,
    _identity_plus,
    spherical_explosion_scalar,
)
from circulantpreconditioner_tpu_torch.ops.assembly import diffusion_csr, diffusion_stencil
from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix
from circulantpreconditioner_tpu_torch.solvers import make_cg, make_gmres
from circulantpreconditioner_tpu_torch.utils.device import check_real_dtype
from circulantpreconditioner_tpu_torch.utils.graphs import CapturedStep


class DiffusionEquation:
    """∂t u = ν ∇²u, first-order FV in space. `cfl` scales the explicit
    stability limit dt ≤ r²/(2·dim·ν), r = min |V|/|∂V| (cfl = 1 is the
    stable explicit step; implicit runs take cfl ≫ 1)."""

    def __init__(self, mesh: Mesh, nu: float = 1.0, cfl: float | None = None,
                 dt: float | None = None, *, device: torch.device, dtype: torch.dtype,
                 boundary: str = "auto"):
        self.mesh = mesh
        self.dim = mesh.dim
        self.nu = float(nu)
        self.device = torch.device(device)
        self.dtype = check_real_dtype(dtype)
        self.boundary = boundary
        if dt is not None:
            self.dt = float(dt)
        else:
            if cfl is None:
                cfl = 1e3 / mesh.dim
            r = mesh.min_ratio_vol_surf()
            self.dt = float(cfl * r * r / (2.0 * mesh.dim * self.nu))

    def initial_state(self) -> torch.Tensor:
        return torch.as_tensor(spherical_explosion_scalar(self.mesh)).to(
            device=self.device, dtype=self.dtype)

    @cached_property
    def divergence(self) -> CSRMatrix:
        """D = dt·ν·L such that (I + D)uⁿ⁺¹ = uⁿ."""
        return diffusion_csr(self.mesh, self.dt, self.nu, device=self.device, dtype=self.dtype,
                             boundary=self.boundary)

    def divergence_op(self, operator: str = "auto"):
        """D as a callable: 'varying' (gather-free stencil, meshes whose
        topology is a grid, the tet meshes' supercells too), 'matrix' (the CSR matvec), or 'auto'."""
        if operator == "auto":
            operator = ("varying" if getattr(self.mesh, "topology_shape", None) is not None
                        else "matrix")
        if operator == "varying":
            from circulantpreconditioner_tpu_torch.ops.stencil import VaryingStencilOperator

            return VaryingStencilOperator.from_csr(
                self.divergence, self.mesh.topology_shape,  # type: ignore[attr-defined]
                cells_per_site=getattr(self.mesh, "cells_per_site", 1)).matvec
        if operator == "matrix":
            return self.divergence.matvec
        raise ValueError(f"unknown operator {operator!r}")

    def implicit_matvec(self, operator: str = "auto"):
        """A = I + D as a callable."""
        return functools.partial(_identity_plus, self.divergence_op(operator))

    # --- steppers -----------------------------------------------------------
    def explicit_stepper(self, operator: str = "auto") -> CapturedStep:
        return CapturedStep(functools.partial(_explicit_step, self.divergence_op(operator)))

    def implicit_stepper(self, M=None, rtol: float = 1e-5, atol: float = 1e-5,
                         maxiter: int = 1000, method: str = "cg", operator: str = "auto"):
        """CG (default: I + D is SPD on insulated and periodic meshes) or
        GMRES per step; pass M for a preconditioner."""
        A = self.implicit_matvec(operator)
        if method == "cg":
            solver = make_cg(A, M, rtol=rtol, atol=atol, maxiter=maxiter)
        else:
            solver = make_gmres(A, M, rtol=rtol, atol=atol, maxiter=maxiter)

        def step(u):
            res = solver(u, u)
            return res.x, torch.linalg.norm(res.x - u), res.iters, res.resnorm, res.converged

        return step

    @cached_property
    def fft_solver(self):
        """Direct solve of I + D on a periodic uniform grid by the staged DFT."""
        from circulantpreconditioner_tpu_torch.ops.dft_matmul import MatmulBlockCirculantSolver

        if not self.mesh.is_structured:
            raise ValueError("fft stepper needs a cartesian mesh")
        offsets, blocks = diffusion_stencil(self.dim, self.dt, self.nu,
                                            self.mesh.spacing)  # type: ignore[attr-defined]
        blocks = blocks.copy()
        blocks[0] += 1.0  # identity shift: the symbol of I + D
        return MatmulBlockCirculantSolver.from_stencil(
            tuple(reversed(self.mesh.structured_shape)), offsets, blocks, device=self.device,
            dtype=self.dtype)

    def fft_stepper(self) -> CapturedStep:
        return CapturedStep(functools.partial(_direct_step, self.fft_solver))

    # --- exact solutions ----------------------------------------------------
    def discrete_symbol(self, k_xyz) -> float:
        """λ_h(k) = Σ_d 2ν(1 − cos(2π k_d / n_d))/h_d², the eigenvalue of the
        discrete operator L at integer mode k on the periodic grid."""
        if not self.mesh.is_structured:
            raise ValueError("discrete_symbol needs a cartesian mesh")
        h = np.asarray(self.mesh.spacing, dtype=np.float64)  # type: ignore[attr-defined]
        n = np.asarray(self.mesh.structured_shape, dtype=np.float64)
        k = np.asarray(k_xyz, dtype=np.float64)[: self.dim]
        theta = 2.0 * np.pi * k / n
        return float((2.0 * self.nu * (1.0 - np.cos(theta)) / (h * h)).sum())

    def exact_mode_decay(self, k_xyz, n_steps: int) -> float:
        """Amplitude factor of mode k after n implicit-Euler steps,
        (1 + dt·λ_h(k))^-n: exact for the discrete system."""
        return float((1.0 + self.dt * self.discrete_symbol(k_xyz)) ** (-n_steps))
