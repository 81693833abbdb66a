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
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.krylov import gmres, torch_csr

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


def compare(kind: str, A, u0: np.ndarray, u1: np.ndarray, steps: int, *, shape_xyz,
            device: torch.device) -> list[float]:
    """The readings of the check `kind` for the requests whose inputs and
    outputs are the columns of u0 and u1."""
    if kind == "error":
        if steps != 1:
            raise ValueError("the implicit check judges requests of one step")
        return errors(u1, implicit_solutions(A, u0, device))
    if kind == "direct_error":
        return errors(u1, direct_chain(A, shape_xyz, u0, steps))
    raise ValueError(f"unknown check {kind!r}")
