"""The TF32 arithmetic of the controls: the reference put in the program's
place and computed in TF32, the precision next below the float32 that the
configurations state (the port runs float32 with TF32 off). TF32 is
emulated: every operand of a product is rounded to TF32's 10 stored mantissa
bits (round to nearest, ties to even), the products summed in float32.

- implicit cells: GMRES on the reference operator (reference/krylov.py,
  restart and tolerances of the configuration, no preconditioner) with every
  product in TF32, from the request's state (`implicit_tf32`);
- the direct cell: the reference's FFT chain with the state and the symbol
  rounded to TF32 before each product (`np_tf32` as its rounding);
- a check kind of its own (reference/kinds/): the kind module's `control`.

Which control a check uses is its kind's (reference/checks.py).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.krylov import gmres, torch_csr


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 → float32 holding the nearest TF32 value (ties to even)."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    rounded = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def np_tf32(a: np.ndarray) -> np.ndarray:
    """float64 array → float64 array holding the nearest TF32 values."""
    return tf32_round(torch.as_tensor(np.ascontiguousarray(a))).double().numpy()


def implicit_tf32(A, gmres_cfg: dict, u0: np.ndarray, device: torch.device) -> np.ndarray:
    """A⁻¹ u0 for every column of u0 (n, k) by GMRES with every product in
    TF32, at the configuration's restart and tolerances."""
    u0 = np.asarray(u0, dtype=np.float64).reshape(A.shape[0], -1)
    At = torch_csr(A, torch.float32, device, rnd=tf32_round)
    out = []
    for col in u0.T:
        b = torch.as_tensor(col.astype(np.float32), device=device)
        x, _, _ = gmres(At, b, rtol=gmres_cfg["rtol"], atol=gmres_cfg["atol"],
                        restart=gmres_cfg["restart"], maxiter=gmres_cfg["maxits"],
                        rnd=tf32_round)
        out.append(x.double().cpu().numpy())
    return np.stack(out, axis=1)
