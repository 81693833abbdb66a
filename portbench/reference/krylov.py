"""Plain restarted GMRES (no preconditioner; classical Gram-Schmidt twice;
Givens rotations on the host) on a torch sparse matrix, for the reference's
own solves and the TF32 control. `rnd` rounds every operand of a product:
the identity for the reference, TF32 rounding for the control."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def torch_csr(A: sp.spmatrix, dtype: torch.dtype, device: torch.device,
              rnd=lambda t: t) -> torch.Tensor:
    A = A.tocsr()
    vals = rnd(torch.as_tensor(A.data).to(dtype))
    return torch.sparse_csr_tensor(torch.as_tensor(A.indptr, dtype=torch.int64),
                                   torch.as_tensor(A.indices, dtype=torch.int64), vals,
                                   size=A.shape).to(device)


def gmres(At: torch.Tensor, b: torch.Tensor, *, rtol: float, atol: float = 0.0,
          restart: int = 30, maxiter: int = 1000, rnd=lambda t: t):
    """(x, iterations, converged) of At x = b from x = b, stopping where the
    residual estimate meets max(rtol·‖b‖, atol)."""

    def matvec(v):
        return (At @ rnd(v).unsqueeze(1)).squeeze(1)

    def project(V, w):
        return rnd(V) @ rnd(w)

    def combine(V, c):
        return rnd(V).T @ rnd(c)

    x = b.clone()
    tol = max(rtol * float(torch.linalg.norm(b)), atol)
    m, it = restart, 0
    V = torch.zeros((m + 1, b.shape[0]), dtype=b.dtype, device=b.device)
    while it < maxiter:
        r = b - matvec(x)
        beta = float(torch.linalg.norm(r))
        if beta < tol:
            return x, it, True
        V[0] = r / beta
        H = np.zeros((m + 1, m))
        cs, sn, g = np.zeros(m), np.zeros(m), np.zeros(m + 1)
        g[0] = beta
        j = 0
        while j < m and it < maxiter:
            w = matvec(V[j])
            h = project(V[: j + 1], w)
            w = w - combine(V[: j + 1], h)
            h2 = project(V[: j + 1], w)
            w = w - combine(V[: j + 1], h2)
            wn = float(torch.linalg.norm(w))
            H[: j + 1, j] = (h + h2).double().cpu().numpy()
            H[j + 1, j] = wn
            V[j + 1] = w / max(wn, 1e-300)
            for i in range(j):
                H[i, j], H[i + 1, j] = (cs[i] * H[i, j] + sn[i] * H[i + 1, j],
                                        -sn[i] * H[i, j] + cs[i] * H[i + 1, j])
            d = np.hypot(H[j, j], H[j + 1, j])
            cs[j], sn[j] = (H[j, j] / d, H[j + 1, j] / d) if d > 0 else (1.0, 0.0)
            H[j, j], H[j + 1, j] = d, 0.0
            g[j], g[j + 1] = cs[j] * g[j], -sn[j] * g[j]
            j += 1
            it += 1
            if abs(g[j]) < tol:
                break
        R = np.triu(H[:j, :j])
        R[np.diag_indices(j)] = np.where(np.abs(np.diag(R)) < 1e-300, 1e-300, np.diag(R))
        y = np.linalg.solve(R, g[:j])
        x = x + combine(V[:j], torch.as_tensor(y, dtype=b.dtype, device=b.device))
    r = b - matvec(x)
    return x, it, float(torch.linalg.norm(r)) < tol
