"""The precision tiers of the port (utils/device.py `TIER_FORMS`,
ops/tier_matmul.py) against the JAX package on the CPU.

- K4's plain version, `tier_matmul_reference`, against the split product of
  the JAX package's Pallas kernel K1 (`_mk_ops`, run on the CPU) on the same
  NumPy inputs: within 1e-6 · max|o| (the same bf16 splits, exact products,
  fp32 sums in another order); and against float64: under 2e-5 · max|o| at
  "high" (the JAX package's note: ~4e-5 for a solve), between 1e-4 and 1e-2
  at "default" (~5e-3).
- On the CPU, XLA ignores `precision=`: the JAX solvers' "high" equals their
  "highest" bit for bit, and so do the port's, whose CPU tier is full
  precision.
- The tier table, the CPU wrapper of K4, the strided views K4 reads, and no
  JAX in the port's modules.
The CUDA kernel itself is held to its plain version in tests/test_torch_gpu.py.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circulantpreconditioner_tpu.ops import dct_wave as jdct
from circulantpreconditioner_tpu.ops import dft_matmul as jdm
from circulantpreconditioner_tpu.ops import spectral_collapse as jsc
from circulantpreconditioner_tpu.ops.fused_circulant import _mk_ops
from circulantpreconditioner_tpu_torch.ops import dct_wave as tdct
from circulantpreconditioner_tpu_torch.ops import dft_matmul as tdm
from circulantpreconditioner_tpu_torch.ops import spectral_collapse as tsc
from circulantpreconditioner_tpu_torch.ops import tier_matmul as ttm
from circulantpreconditioner_tpu_torch.utils.device import TIER_FORMS, tier_form

CPU = torch.device("cpu")
F32 = dict(device=CPU, dtype=torch.float32)
# (A rows, K, N): the flagship collapse (10⁴, 100)·(100, 100), an rDFT inverse
# (51, 100), a DCT-sized square (101, 101) and a ragged product
SHAPES = [(10000, 100, 100), (400, 51, 100), (300, 101, 101), (37, 19, 45)]


def _ab(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _jax_split_product(a, b, precision):
    split, mm = _mk_ops(precision)
    return np.asarray(mm(split(jnp.asarray(a)), split(jnp.asarray(b))))


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_matches_jax_split_product(shape, precision):
    a, b = _ab(*shape)
    o_jax = _jax_split_product(a, b, precision)
    o = ttm.tier_matmul_reference(torch.from_numpy(a), torch.from_numpy(b), precision).numpy()
    scale = np.abs(o_jax).max()
    assert np.abs(o - o_jax).max() <= 1e-6 * scale
    err64 = np.abs(o.astype(np.float64) - a.astype(np.float64) @ b.astype(np.float64)).max()
    if precision == "high":
        assert err64 < 2e-5 * scale
    else:
        assert 1e-4 * scale < err64 < 1e-2 * scale


def test_reference_splits_as_jax():
    x = np.random.default_rng(3).normal(size=(64, 33)).astype(np.float32) * 1e3
    hi_j = jnp.asarray(x).astype(jnp.bfloat16)
    lo_j = (jnp.asarray(x) - hi_j.astype(jnp.float32)).astype(jnp.bfloat16)
    hi, lo = ttm.bf16_split(torch.from_numpy(x))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j.astype(jnp.float32)))
    assert hi.dtype == lo.dtype == torch.float32


def test_tier_table():
    cuda = torch.device("cuda")
    assert TIER_FORMS[("cuda", torch.float32)] == {"highest": "fp32", "high": "bf16x3",
                                                   "default": "bf16"}
    assert [tier_form(cuda, torch.float32, p) for p in ("highest", "high", "default")] == [
        "fp32", "bf16x3", "bf16"]
    for dev, dtype in ((CPU, torch.float32), (CPU, torch.float64), (cuda, torch.float64)):
        assert {tier_form(dev, dtype, p) for p in ("highest", "high", "default")} == {"full"}
    with pytest.raises(ValueError, match="precision must be one of"):
        tier_form(CPU, torch.float32, "bf16")
    assert ttm.PASSES == {"high": 3, "default": 1}


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_cpu_tier_is_full_precision(precision):
    """On a CPU tensor every tier is the one full-precision product; K4's CPU
    wrapper runs the plain version and counts no launch."""
    a, b = (torch.from_numpy(x) for x in _ab(50, 20, 30, seed=1))
    full = ttm.contract(a, b)
    assert torch.equal(ttm.tier_matmul(a, b, precision), full)
    torch.testing.assert_close(full, a @ b, rtol=0, atol=1e-5)
    before = ttm.TierMatmulKernel.launches
    if precision == "highest":
        with pytest.raises(ValueError, match="K4 runs the tiers"):
            ttm.tier_matmul_kernel(a, b, precision)
    else:
        assert torch.equal(ttm.tier_matmul_kernel(a, b, precision),
                           ttm.tier_matmul_reference(a, b, precision))
    assert ttm.TierMatmulKernel.launches == before


@pytest.mark.parametrize("precision", ["high", "default"])
def test_reference_contracts_any_axis_and_batch(precision):
    """The axis form (y and z sweeps, and the DCT sweeps' per-component
    matrices) equals the 2D product of the same splits after moving the axis
    last."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(3, 5, 6, 7)).astype(np.float32))
    m = torch.as_tensor(rng.normal(size=(5, 4)).astype(np.float32))
    out = ttm.tier_matmul_reference(x, m, precision, axis=1)
    flat = ttm.tier_matmul_reference(torch.movedim(x, 1, -1).reshape(-1, 5), m, precision)
    torch.testing.assert_close(out, torch.movedim(flat.reshape(3, 6, 7, 4), -1, 1),
                               rtol=0, atol=1e-5)
    mb = torch.as_tensor(rng.normal(size=(3, 7, 2)).astype(np.float32))
    out = ttm.tier_matmul_reference(x, mb, precision, axis=3)
    for c in range(3):
        torch.testing.assert_close(out[c], ttm.tier_matmul_reference(x[c], mb[c], precision),
                                   rtol=0, atol=1e-5)


def test_kernel_views_need_no_copy():
    """The (batch, P, K, Q) sizes and strides K4 reads, for the solvers' calls:
    a contiguous grid along each axis, and the DCT solve's field-major view
    of a cell-major state (moved axis, not contiguous)."""
    g = torch.zeros(4, 5, 6)
    assert ttm._views(g, 2, False) == ((1, 20, 6, 1), (0, 6, 1, 0))
    assert ttm._views(g, 1, False) == ((1, 4, 5, 6), (0, 30, 6, 1))
    assert ttm._views(g, 0, False) == ((1, 1, 4, 30), (0, 0, 30, 1))
    fm = torch.movedim(torch.zeros(4, 5, 6, 3), -1, 0)  # (3, 4, 5, 6), strides (1, 90, 18, 3)
    assert ttm._views(fm, 3, True) == ((3, 20, 6, 1), (1, 18, 3, 0))
    assert ttm._views(fm, 2, True) == ((3, 4, 5, 6), (1, 90, 18, 3))
    assert ttm._views(fm, 1, True) == ((3, 1, 4, 30), (1, 0, 90, 3))
    assert ttm._views(torch.zeros(4, 6)[:, ::2].t(), 1, False) is not None
    assert ttm._views(torch.zeros(4, 5, 6).transpose(1, 2), 0, False) is None  # copied first


def test_kernel_wrapper_rejects_cpu_launch():
    a, b = (torch.from_numpy(x) for x in _ab(8, 4, 3))
    with pytest.raises(ValueError, match="K4 needs CUDA tensors"):
        ttm.tier_matmul_cuda(a, b, "high")
    with pytest.raises(ValueError, match="K4 computes in float32"):
        ttm._check_kernel_inputs(a.double(), b.double(), "high")
    with pytest.raises(ValueError, match="b's rows"):
        ttm.tier_matmul(a, b.t(), "high")


# --- "high" equals "highest" bit for bit on the CPU, in both packages ------

N3 = (6, 5, 8)
LAMS = (0.0, 0.0, 9.0)


def _b(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 50 + 600).astype(np.float32)


def _jax_and_port(precision):
    """(JAX solver, port solver, input) pairs for each solver taking a tier."""
    b = _b(N3)
    lams3 = (0.5, 0.7, 9.0)
    offsets = [(0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (1, 0, 0)]
    rng = np.random.default_rng(2)
    blocks = rng.normal(size=(5, 2, 2)) * 0.1
    blocks[0] += 3 * np.eye(2)
    bb = _b(N3 + (2,), seed=1)
    dct_args = (N3, 3, 0.001, 700.0, (0.2, 0.25, 0.3))
    bd = _b(N3 + (4,), seed=2)
    return {
        "dense": (jsc.DenseCirculantSolver.create(N3, LAMS, jnp.float32, precision),
                  tsc.DenseCirculantSolver.create(N3, LAMS, precision=precision, **F32), b),
        "staged": (jdm.MatmulCirculantSolver.create(N3, lams3, jnp.float32, precision),
                   tdm.MatmulCirculantSolver.create(N3, lams3, precision=precision, **F32), b),
        "block": (jdm.MatmulBlockCirculantSolver.from_stencil(N3, offsets, blocks, jnp.float32,
                                                              precision),
                  tdm.MatmulBlockCirculantSolver.from_stencil(N3, offsets, blocks,
                                                              precision=precision, **F32), bb),
        "dct": (jdct.DCTBlockWaveSolver.create(*dct_args, jnp.float32, precision=precision),
                tdct.DCTBlockWaveSolver.create(*dct_args, precision=precision, **F32), bd),
    }


@pytest.mark.parametrize("name", ["dense", "staged", "block", "dct"])
def test_high_equals_highest_on_cpu_in_both_packages(name):
    (j_hi, t_hi, b), (j_top, t_top, _) = (_jax_and_port(p)[name] for p in ("high", "highest"))
    x_j_hi, x_j_top = (np.asarray(s.solve(jnp.asarray(b))) for s in (j_hi, j_top))
    np.testing.assert_array_equal(x_j_hi, x_j_top)
    x_t_hi, x_t_top = (s.solve(torch.from_numpy(b)).numpy() for s in (t_hi, t_top))
    np.testing.assert_array_equal(x_t_hi, x_t_top)
    # and the two packages agree in float32 (full precision on both sides)
    np.testing.assert_allclose(x_t_hi, x_j_hi, rtol=0, atol=1e-5 * np.abs(x_j_hi).max())


def test_port_modules_import_no_jax():
    code = ("import sys\n"
            "import circulantpreconditioner_tpu_torch.ops.tier_matmul\n"
            "import circulantpreconditioner_tpu_torch.ops.spectral_collapse\n"
            "import circulantpreconditioner_tpu_torch.ops.dct_wave\n"
            "import circulantpreconditioner_tpu_torch.parallel.pc_dist\n"
            "import circulantpreconditioner_tpu_torch.bench_suite\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m.startswith('circulantpreconditioner_tpu.')\n"
            "       or m == 'circulantpreconditioner_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
