"""The comparisons that decide `correct`, in float64 against the reference's
own operator A = I + D (reference/operators.py), which reads the program's
answers only to judge them.

- "error": an implicit step solves A u1 = u0. The reference solves it again
  from u0 by plain GMRES in float64 on the device, to a relative residual of
  REF_RTOL, and the answer is judged by ‖u1 − u_ref‖₂ / ‖u_ref‖₂.
- "direct_error": a chain of direct steps u_{k+1} = A⁻¹ u_k on a periodic
  uniform grid, where A is circulant: the reference takes A's symbol from A
  applied to a unit vector, runs the chain by float64 FFTs (NumPy), checks
  its own first step's residual, and judges the chain's last state by the
  same relative error.

Any other kind `<kind>` is a module of its own, reference/kinds/<kind>.py
(its interface in reference/kinds/__init__.py), which builds its own
operator from the configuration and the traffic mix. `kind` resolves a
cell's check to a `Kind`, the one place that tells the two apart.
"""

from __future__ import annotations

import functools
import importlib
from types import ModuleType

import numpy as np
import torch

from portbench.reference.control import implicit_tf32, np_tf32
from portbench.reference.krylov import gmres, torch_csr
from portbench.reference.operators import implicit_operator

REF_RTOL = 1e-11
REF_RESTART = 100
REF_MAXITER = 20000


def errors(u: np.ndarray, ref: np.ndarray) -> list[float]:
    """Relative 2-norm error of each column of u (n, k) against ref."""
    u = np.asarray(u, dtype=np.float64).reshape(ref.shape)
    return list(np.linalg.norm(u - ref, axis=0) / np.linalg.norm(ref, axis=0))


def implicit_solutions(A, u0: np.ndarray, device: torch.device) -> np.ndarray:
    """A⁻¹ u0 for every column of u0 (n, k), by float64 GMRES."""
    At = torch_csr(A, torch.float64, device)
    out = []
    for col in np.asarray(u0, dtype=np.float64).reshape(A.shape[0], -1).T:
        b = torch.as_tensor(np.ascontiguousarray(col), device=device)
        x, its, ok = gmres(At, b, rtol=REF_RTOL, restart=REF_RESTART, maxiter=REF_MAXITER)
        if not ok:
            raise RuntimeError(f"the reference's GMRES did not converge in {its} iterations")
        out.append(x.cpu().numpy())
    return np.stack(out, axis=1)


def symbol(A, shape_xyz) -> np.ndarray:
    """The eigenvalues of a circulant A on the (nz, ny, nx) grid, on the real
    transform's half spectrum: the transform of A's first column."""
    nx, ny, nz = (int(v) for v in shape_xyz)
    e0 = np.zeros(A.shape[0])
    e0[0] = 1.0
    return np.fft.rfftn((A @ e0).reshape(nz, ny, nx))


def direct_chain(A, shape_xyz, u0: np.ndarray, steps: int, rnd=None) -> np.ndarray:
    """A⁻ˢ u0 for every column of u0 (n, k) by FFTs; `rnd` (an array →
    array rounding) is applied to the state and the symbol before each
    product (the TF32 control)."""
    nx, ny, nz = (int(v) for v in shape_xyz)
    lam = symbol(A, shape_xyz)
    u0 = np.asarray(u0, dtype=np.float64).reshape(A.shape[0], -1)
    out = []
    for col in u0.T:
        x = col.reshape(nz, ny, nx)
        for _ in range(steps):
            if rnd is None:
                x = np.fft.irfftn(np.fft.rfftn(x) / lam, s=(nz, ny, nx), axes=(0, 1, 2))
            else:
                xh = np.fft.rfftn(rnd(x))
                x = rnd(np.fft.irfftn(_crnd(xh, rnd) / _crnd(lam, rnd), s=(nz, ny, nx),
                                      axes=(0, 1, 2)))
        out.append(x.reshape(-1))
    x = np.stack(out, axis=1)
    if rnd is None:
        first = np.fft.irfftn(np.fft.rfftn(u0[:, 0].reshape(nz, ny, nx)) / lam,
                              s=(nz, ny, nx), axes=(0, 1, 2)).reshape(-1)
        res = np.linalg.norm(A @ first - u0[:, 0]) / np.linalg.norm(u0[:, 0])
        if res > 1e-10:
            raise RuntimeError(f"A is not circulant on this grid: residual {res:.3e}")
    return x


def _crnd(z: np.ndarray, rnd) -> np.ndarray:
    return rnd(z.real) + 1j * rnd(z.imag)


class Kind:
    """A check bound to the configuration and traffic mix of one cell."""

    def __init__(self, config: dict, mix: dict):
        self.config, self.mix = config, mix

    def answers(self, u0: np.ndarray, device: torch.device) -> np.ndarray:
        """The reference's answers (n, k) to the requests whose inputs are
        the columns of u0 (n, k), float64."""
        raise NotImplementedError

    def readings(self, u1: np.ndarray, ref: np.ndarray) -> list[float]:
        """One reading per column of the program's answers u1 against `ref`."""
        raise NotImplementedError

    def control(self, u0: np.ndarray, device: torch.device) -> np.ndarray:
        """The control's answers to the same requests (reference/control.py)."""
        raise NotImplementedError

    def compare(self, u0: np.ndarray, u1: np.ndarray, device: torch.device) -> list[float]:
        """The readings for the requests whose inputs and outputs are the
        columns of u0 and u1."""
        return self.readings(u1, self.answers(u0, device))


class BuiltIn(Kind):
    """`error` or `direct_error` (see the module docstring), on the reference
    operator of the configuration, assembled once, at its first use."""

    def __init__(self, name: str, config: dict, mix: dict):
        super().__init__(config, mix)
        self.name, self.steps = name, int(mix["steps_per_request"])
        if name == "error" and self.steps != 1:
            raise ValueError("the implicit check judges requests of one step")

    @functools.cached_property
    def A(self):
        return implicit_operator(self.config, self.mix["boundary"])[0]

    def answers(self, u0, device):
        if self.name == "error":
            return implicit_solutions(self.A, u0, device)
        return direct_chain(self.A, self.config["mesh"]["n"], u0, self.steps)

    def readings(self, u1, ref):
        return errors(u1, ref)

    def control(self, u0, device):
        if self.name == "error":
            return implicit_tf32(self.A, self.config["gmres"], u0, device)
        return direct_chain(self.A, self.config["mesh"]["n"], u0, self.steps,
                            rnd=np_tf32)


class ModuleKind(Kind):
    """A check kind of its own, the module reference/kinds/<kind>.py (its
    interface in reference/kinds/__init__.py)."""

    def __init__(self, module: ModuleType, config: dict, mix: dict):
        super().__init__(config, mix)
        self.module = module

    def answers(self, u0, device):
        return self.module.answers(self.config, self.mix, u0, device)

    def readings(self, u1, ref):
        return self.module.readings(u1, ref)

    def control(self, u0, device):
        return self.module.control(self.config, self.mix, u0, device)


def kind(name: str, config: dict, mix: dict) -> Kind:
    """The check `name` of a cell of this configuration and traffic mix: a
    built-in kind, or the module portbench.reference.kinds.<name>, imported
    here."""
    if name in ("error", "direct_error"):
        return BuiltIn(name, config, mix)
    return ModuleKind(importlib.import_module(f"portbench.reference.kinds.{name}"), config, mix)
