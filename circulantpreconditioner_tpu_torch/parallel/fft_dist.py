"""Slab- and pencil-decomposed distributed 3D circulant solves (PyTorch
counterpart of circulantpreconditioner_tpu/parallel/fft_dist.py): the
reference's FFTW-MPI slab FFT (MatCreateFFT on PETSC_COMM_WORLD,
TransportEquationFFT_...cxx:100) and its packed-real-format machinery
(VecPointwiseDivideForRealFFT, FftLinearSolver_3D.c:27-77), which here
collapse to two all-to-all transposes around local torch.fft calls:

    b (nz/P, ny, nx) slab per rank               (split on z)
      └ rfft2 over (y, x)                         local
      └ all-to-all: split y, gather z → (nz, ny/P, nxr)
      └ fft over z, ÷ this rank's Λ[:, y-slab, :], ifft over z
      └ all-to-all back: split z, gather y → (nz/P, ny, nxr)
      └ irfft2
    x slab per rank

Λ is built once on the host, and each rank keeps its slice on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.ops.circulant import (
    CirculantTransportOperator,
    np_eigenvalue_diagonal,
)
from circulantpreconditioner_tpu_torch.parallel.mesh_utils import RankMesh, shard_on_axis
from circulantpreconditioner_tpu_torch.utils.device import check_real_dtype, complex_dtype


class SlabCirculantSolver:
    """Distributed CirculantTransportOperator.solve for 3D grids, split into
    z-slabs over one mesh axis. Needs nz % P == 0 and ny % P == 0 (the
    slab ↔ pencil transpose, FFTW-MPI's default slab constraint)."""

    def __init__(self, shape_zyx, lambdas_zyx, mesh: RankMesh, axis: str = "shard",
                 dtype: torch.dtype = torch.float32):
        nz, ny, nx = (int(v) for v in shape_zyx)
        self.P = mesh.shape[axis]
        if nz % self.P or ny % self.P:
            raise ValueError(f"nz={nz} and ny={ny} must be divisible by P={self.P}")
        self.shape_zyx = (nz, ny, nx)
        self.mesh = mesh
        self.axis = axis
        self.dtype = check_real_dtype(dtype)
        lam = np_eigenvalue_diagonal(self.shape_zyx, lambdas_zyx, rfft=True)  # (nz, ny, nxr)
        # Λ split on y: the layout after the forward transpose
        self.lam = shard_on_axis(lam, mesh, axis, 1, complex_dtype(dtype))

    @classmethod
    def from_operator(cls, op: CirculantTransportOperator, mesh: RankMesh,
                      axis: str = "shard"):
        if len(op.shape_zyx) != 3:
            raise ValueError("slab solver is 3D")
        return cls(op.shape_zyx, op.lambdas_zyx, mesh, axis, dtype=op.dtype)

    def shard(self, b) -> torch.Tensor:
        """This rank's z-slab of a global (nz, ny, nx) array."""
        b = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
        return shard_on_axis(b.reshape(self.shape_zyx), self.mesh, self.axis, 0, self.dtype)

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        """The global (nz, ny, nx) array, on every rank."""
        return self.mesh.all_gather(x, self.axis)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = C⁻¹ b on this rank's slab (nz/P, ny, nx)."""
        mesh, axis = self.mesh, self.axis
        bh = torch.fft.rfft2(b, dim=(1, 2))  # (nz/P, ny, nxr)
        bh = mesh.all_to_all(bh, axis, split_axis=1, concat_axis=0)  # (nz, ny/P, nxr)
        bh = torch.fft.fft(bh, dim=0)
        xh = torch.fft.ifft(bh / self.lam, dim=0)
        xh = mesh.all_to_all(xh, axis, split_axis=0, concat_axis=1)  # (nz/P, ny, nxr)
        x = torch.fft.irfft2(xh, s=(b.shape[1], b.shape[2]), dim=(1, 2))
        return x.to(b.dtype)


class PencilCirculantSolver:
    """Pencil-decomposed (2D rank mesh) distributed circulant solve: scales
    past the slab limit P ≤ nz to p·q ranks. The field (nz, ny, nx) is split
    z over mesh axis axes[0] and y over axes[1]; the pipeline is
    rfft(x) → all-to-all in the y group → fft(y) → all-to-all in the z
    group → fft(z) → ÷Λ → the inverse chain. The x half-spectrum is
    zero-padded to a multiple of q so that its transpose tiles evenly (the
    padded bins carry Λ = 1 and are cut before the inverse rfft).

    Needs nz % p == 0, ny % q == 0 and ny % p == 0 (`check_shape`)."""

    def __init__(self, shape_zyx, lambdas_zyx, mesh: RankMesh,
                 axes: tuple[str, str] = ("z", "y"), dtype: torch.dtype = torch.float32):
        nz, ny, nx = (int(v) for v in shape_zyx)
        az, ay = axes
        p, q = mesh.shape[az], mesh.shape[ay]
        self.check_shape((nz, ny, nx), p, q)
        self.shape_zyx = (nz, ny, nx)
        self.mesh = mesh
        self.axes = axes
        self.dtype = check_real_dtype(dtype)
        self.nxr = nx // 2 + 1
        self.nxr_pad = ((self.nxr + q - 1) // q) * q
        lam = np_eigenvalue_diagonal(self.shape_zyx, lambdas_zyx, rfft=True)  # (nz, ny, nxr)
        lam_pad = np.ones((nz, ny, self.nxr_pad), dtype=lam.dtype)  # padded bins: Λ = 1
        lam_pad[:, :, :self.nxr] = lam
        # Λ split y over axes[0] and x over axes[1]: the layout after both transposes
        lam_pad = shard_on_axis(lam_pad, mesh, az, 1)
        self.lam = shard_on_axis(lam_pad, mesh, ay, 2, complex_dtype(dtype))

    @staticmethod
    def check_shape(shape_zyx, p: int, q: int) -> None:
        """Raises ValueError unless a (p, q) pencil mesh tiles the grid."""
        nz, ny, _ = shape_zyx
        if nz % p or ny % q or ny % p:
            raise ValueError(
                f"need nz%p==0, ny%q==0, ny%p==0 (nz={nz}, ny={ny}, p={p}, q={q})")

    @classmethod
    def from_operator(cls, op: CirculantTransportOperator, mesh: RankMesh,
                      axes: tuple[str, str] = ("z", "y")):
        if len(op.shape_zyx) != 3:
            raise ValueError("pencil solver is 3D")
        return cls(op.shape_zyx, op.lambdas_zyx, mesh, axes, dtype=op.dtype)

    def shard(self, b) -> torch.Tensor:
        """This rank's (nz/p, ny/q, nx) pencil of a global (nz, ny, nx) array."""
        b = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
        b = shard_on_axis(b.reshape(self.shape_zyx), self.mesh, self.axes[0], 0)
        return shard_on_axis(b, self.mesh, self.axes[1], 1, self.dtype)

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        """The global (nz, ny, nx) array, on every rank."""
        az, ay = self.axes
        x = self.mesh.all_gather(x.transpose(0, 1), ay).transpose(0, 1)  # whole y
        return self.mesh.all_gather(x, az)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = C⁻¹ b on this rank's pencil (nz/p, ny/q, nx)."""
        mesh = self.mesh
        az, ay = self.axes
        bh = torch.fft.rfft(b, dim=2)  # (nz/p, ny/q, nxr)
        bh = torch.nn.functional.pad(bh, (0, self.nxr_pad - self.nxr))
        bh = mesh.all_to_all(bh, ay, split_axis=2, concat_axis=1)
        bh = torch.fft.fft(bh, dim=1)  # (nz/p, ny, nxr_pad/q)
        bh = mesh.all_to_all(bh, az, split_axis=1, concat_axis=0)
        bh = torch.fft.fft(bh, dim=0)  # (nz, ny/p, nxr_pad/q)
        xh = torch.fft.ifft(bh / self.lam, dim=0)
        xh = mesh.all_to_all(xh, az, split_axis=0, concat_axis=1)
        xh = torch.fft.ifft(xh, dim=1)  # (nz/p, ny, nxr_pad/q)
        xh = mesh.all_to_all(xh, ay, split_axis=1, concat_axis=2)
        x = torch.fft.irfft(xh[:, :, :self.nxr], n=b.shape[2], dim=2)
        return x.to(b.dtype)


def make_distributed_fft3(mesh: RankMesh, axis: str = "shard", inverse: bool = False):
    """Slab-decomposed complex 3D FFT (or inverse) over a mesh axis: returns
    a function of this rank's z-slab (nz/P, ny, nx) → its z-slab of the
    transform."""

    def fft3(v: torch.Tensor) -> torch.Tensor:
        vh = torch.fft.ifft2(v, dim=(1, 2)) if inverse else torch.fft.fft2(v, dim=(1, 2))
        vh = mesh.all_to_all(vh, axis, split_axis=1, concat_axis=0)
        vh = torch.fft.ifft(vh, dim=0) if inverse else torch.fft.fft(vh, dim=0)
        return mesh.all_to_all(vh, axis, split_axis=0, concat_axis=1)

    return fft3
