"""K1's FFT plan (ops/fused_circulant.py): the plan's stages run by the plain
executor `fft_plan_reference`, and K1's five passes built from them
(`k1_passes_reference`), against NumPy's FFT and the JAX package's solvers.
The CUDA kernel itself is checked on the card (tests/test_torch_gpu.py).

Tolerances:
- the plan against numpy.fft in float64: 1e-12 relative (the twiddles are
  float64; a length-n FFT rounds at about log2(n) · 1e-16);
- the whole solve in float64 against the JAX staged DFT (precision
  "highest") and the dense plain version: 1e-10 relative (dense sums of up to
  n terms against FFT stages, both in float64);
- in float32 against the JAX Pallas kernel in interpret mode (float32 dense
  contractions): 1e-5 · max|x|, K1's bar on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circulantpreconditioner_tpu.ops import dft_matmul as jdm
from circulantpreconditioner_tpu.ops import fused_circulant as jfc
from circulantpreconditioner_tpu_torch.ops import fused_circulant as tfc

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)
LENGTHS = [1, 2, 3, 4, 5, 7, 8, 11, 13, 16, 25, 49, 64, 100, 101, 128, 400]
SHAPES = [(6, 5, 8), (7, 11, 13), (1, 5, 8), (16, 12, 10)]
LAMS = (0.3, 0.2, 0.9)


def _lines(n, count=3, seed=0):
    rng = np.random.default_rng(seed + n)
    return rng.standard_normal((count, n)) + 1j * rng.standard_normal((count, n))


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return np.abs(x - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("n", LENGTHS)
def test_plan_matches_numpy_fft(n):
    plan = tfc._np_fft_plan(n)
    v = _lines(n)
    fwd = tfc.fft_plan_reference(torch.as_tensor(v), plan).numpy()
    inv = tfc.fft_plan_reference(torch.as_tensor(v), plan, inverse=True).numpy()
    assert _rel(fwd, np.fft.fft(v)) <= 1e-12
    assert _rel(inv, n * np.fft.ifft(v)) <= 1e-12


@pytest.mark.parametrize("n", LENGTHS + [14, 77, 9000])
def test_plan_factors_into_small_radices_and_one_leftover(n):
    plan = tfc._np_fft_plan(n)
    assert int(np.prod(plan.radices, dtype=np.int64)) == n
    small = [r for r in plan.radices if r in tfc.SMALL_RADICES]
    assert plan.radices[len(plan.radices) - len(small):] == tuple(small)  # leftover first
    assert len(plan.radices) - len(small) <= 1
    assert len(plan.table) == sum(ns * r for r, ns, _ in plan.stages())


def test_kernel_plan_layout():
    s = tfc.FusedCirculantSolver.create((7, 11, 100), LAMS, **F64)
    ints = list(s.plan.ints)
    assert len(ints) == 3 * (2 + tfc.MAX_STAGES)
    for a, n in enumerate((100, 11, 7)):  # x, y, z
        row = ints[a * (2 + tfc.MAX_STAGES):(a + 1) * (2 + tfc.MAX_STAGES)]
        radices = tfc._np_fft_plan(n).radices
        assert row[:2 + len(radices)] == [n, len(radices), *radices]
        assert not any(row[2 + len(radices):])
    tw_x, tw_y, tw_z, lam = s.plan.tables
    assert tw_x.shape == (len(tfc._np_fft_plan(100).table), 2)
    assert tuple(lam.shape) == (7, 11, 51, 2)


def test_passes_are_the_axis_ffts():
    """Pass 1 is rfft along x, pass 2 fft along y, in float64."""
    shape = (6, 5, 8)
    s = tfc.FusedCirculantSolver.create(shape, LAMS, **F64)
    b = np.random.default_rng(3).standard_normal(shape)
    s1, s2 = tfc.k1_passes_reference(torch.as_tensor(b), s.plan)[:2]
    assert _rel(s1.numpy(), np.fft.rfft(b, axis=-1)) <= 1e-12
    assert _rel(s2.numpy(), np.fft.fft(np.fft.rfft(b, axis=-1), axis=1)) <= 1e-12


def test_kernel_inv_lambda_comes_from_the_jax_arrays():
    shape = (6, 5, 8)
    js = jfc.FusedCirculantSolver.create(shape, LAMS, jnp.float64, interpret=True)
    ts = tfc.FusedCirculantSolver.from_numpy_arrays(shape, [np.asarray(a) for a in js.arrays],
                                                    **F64)
    lam = torch.view_as_complex(ts.plan.tables[3]).numpy()
    ire, iim = ts.arrays[6].numpy(), ts.arrays[7].numpy()
    np.testing.assert_array_equal(lam, (ire + 1j * iim) / np.prod(shape))


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_solve_matches_jax_f64(shape):
    js = jfc.FusedCirculantSolver.create(shape, LAMS, jnp.float64, interpret=True)
    ts = tfc.FusedCirculantSolver.from_numpy_arrays(shape, [np.asarray(a) for a in js.arrays],
                                                    **F64)
    b = np.random.default_rng(sum(shape)).standard_normal(shape)
    x = tfc.k1_passes_reference(torch.as_tensor(b), ts.plan)[-1].numpy()
    x_staged = jdm.MatmulCirculantSolver.create(shape, LAMS, jnp.float64,
                                                precision="highest").solve(jnp.asarray(b))
    assert _rel(x, x_staged) <= 1e-10
    assert _rel(x, tfc.fused_circulant_reference(torch.as_tensor(b), ts.arrays)) <= 1e-10


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_solve_matches_jax_pallas_f32(shape):
    js = jfc.FusedCirculantSolver.create(shape, LAMS, jnp.float32, precision="highest",
                                         interpret=True)
    assert isinstance(js, jfc.FusedCirculantSolver)
    ts = tfc.FusedCirculantSolver.from_numpy_arrays(shape, [np.asarray(a) for a in js.arrays],
                                                    device=CPU, dtype=torch.float32)
    b = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    x = tfc.k1_passes_reference(torch.as_tensor(b), ts.plan)[-1].numpy()
    xj = np.asarray(js.solve(jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-5 * np.abs(xj).max())
