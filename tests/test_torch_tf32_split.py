"""K3's float32 arithmetic, 3×TF32, emulated on the CPU
(ops/complex_matmul.py::complex_matmul_tf32x3_emulation): TF32 rounding by
bit arithmetic, the hi/lo split, and the error of the 3-term product against
float64 at the staged DFT solver's shapes, with B a DFT matrix.

Tolerances:
- 3×TF32 against the float64 product: 2e-6 · max|o|. A float32 product errs
  by about 4e-7 here; 3×TF32 drops only the lo·lo term (2⁻²² relative).
- one TF32 pass must exceed 1e-5 · max|o| (it errs by about 2.5e-4): the
  kernel's gates are 1e-5, so it takes three passes;
- against the JAX Pallas kernel in interpret mode (float32 accumulators):
  1e-5 · max|o|, the gate of K3 against its plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circulantpreconditioner_tpu.ops.pallas_kernels import complex_matmul as j_cmm
from circulantpreconditioner_tpu_torch.ops.complex_matmul import (
    ComplexMatmulKernel,
    complex_matmul_tf32x3_emulation,
    tf32_round,
    tf32_split,
)
from circulantpreconditioner_tpu_torch.ops.dft_matmul import _np_dft_mats

STAGE_SHAPES = [(8320, 128), (5100, 100)]  # (rows, n) at 128³ and 100³


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


def test_tf32_round_ties_away_and_clears_13_bits():
    one = 1.0
    ulp = 2.0**-10  # a TF32 ulp at 1
    x = torch.tensor([one, one + ulp / 2, one + ulp + ulp / 2, -(one + ulp / 2),
                      one + ulp / 2 - 2.0**-20, 0.0, -0.0, float("inf")], dtype=torch.float32)
    want = [one, one + ulp, one + 2 * ulp, -(one + ulp), one, 0.0, -0.0, float("inf")]
    r = tf32_round(x)
    assert r.tolist() == want
    assert np.all(_bits(r) & 0x1FFF == 0)
    assert _bits(r)[6] == 0x80000000  # the sign of −0 is kept


def test_tf32_round_is_nearest_on_random_values():
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(10000) * 1e3,
                        dtype=torch.float32)
    r = tf32_round(x)
    assert np.all(_bits(r) & 0x1FFF == 0)
    # |x − tf32(x)| ≤ half a TF32 ulp, 2⁻¹¹ relative
    err = (r.double() - x.double()).abs() / x.double().abs()
    assert err.max().item() <= 2.0**-11


def test_split_recovers_the_float32_value():
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(10000), dtype=torch.float32)
    hi, lo = tf32_split(x)
    assert np.all(_bits(hi) & 0x1FFF == 0) and np.all(_bits(lo) & 0x1FFF == 0)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0**-21


def _stage(M, n, seed=0):
    """A random spectrum (M, n) and the forward DFT matrix of length n, in
    float64, and their product."""
    rng = np.random.default_rng(seed)
    a = [rng.standard_normal((M, n)) for _ in range(2)]
    C, S, _, _ = _np_dft_mats(n)
    want = (a[0] + 1j * a[1]) @ (C + 1j * S)
    return a + [C, S], want


def _rel_err(o, want) -> float:
    scale = max(np.abs(want.real).max(), np.abs(want.imag).max())
    return max(np.abs(o[0].double().numpy() - want.real).max(),
               np.abs(o[1].double().numpy() - want.imag).max()) / scale


@pytest.mark.parametrize("M,n", STAGE_SHAPES)
def test_three_tf32_passes_match_float64(M, n):
    planes, want = _stage(M, n)
    before = ComplexMatmulKernel.launches
    o = complex_matmul_tf32x3_emulation(*(torch.as_tensor(p, dtype=torch.float32)
                                          for p in planes))
    assert ComplexMatmulKernel.launches == before  # the emulation launches nothing
    assert _rel_err(o, want) <= 2e-6


@pytest.mark.parametrize("M,n", STAGE_SHAPES)
def test_one_tf32_pass_misses_the_kernel_gate(M, n):
    planes, want = _stage(M, n)
    o = complex_matmul_tf32x3_emulation(*(torch.as_tensor(p, dtype=torch.float32)
                                          for p in planes), terms=1)
    assert _rel_err(o, want) > 1e-5


def test_emulation_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    a = [rng.standard_normal((256, 128)).astype(np.float32) for _ in range(2)]
    b = [rng.standard_normal((128, 128)).astype(np.float32) for _ in range(2)]
    o_j = j_cmm(*(jnp.asarray(x) for x in a + b), interpret=True)
    o_t = complex_matmul_tf32x3_emulation(*(torch.as_tensor(x) for x in a + b))
    for t, j in zip(o_t, o_j):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5 * np.abs(j).max())


def test_emulation_takes_only_one_or_three_terms():
    x = torch.ones(2, 2)
    with pytest.raises(ValueError, match="terms"):
        complex_matmul_tf32x3_emulation(x, x, x, x, terms=2)
    with pytest.raises(ValueError, match="float32"):
        tf32_round(x.double())
