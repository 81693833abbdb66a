"""Parity of the port's dense, staged and fused circulant solvers
(ops/spectral_collapse.py, ops/dft_matmul.py, ops/fused_circulant.py) with
the JAX package (the CUDA check of kernel K1 is in tests/test_torch_gpu.py).

Tolerances: float64 comparisons at 1e-12 × max|reference| (both sides run
the same float64 tables through dense contractions; roundoff ~1e-15). The
fused-kernel tiers keep the JAX package's own tolerances for the same shape
(tests/test_spectral_collapse.py::test_fused_kernel_matches_staged): the
JAX side runs its TPU tier (bf16, bf16x3 or f32 passes), the port float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.ops import dft_matmul as jdm
from circulantpreconditioner_tpu.ops import fused_circulant as jfc
from circulantpreconditioner_tpu.ops import spectral_collapse as jsc
from circulantpreconditioner_tpu_torch.ops import dft_matmul as tdm
from circulantpreconditioner_tpu_torch.ops import fused_circulant as tfc
from circulantpreconditioner_tpu_torch.ops import spectral_collapse as tsc
from circulantpreconditioner_tpu_torch.ops.circulant import CirculantTransportOperator

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)


def _b(shape, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _close(x_torch, x_ref, tol=1e-12):
    x_ref = np.asarray(x_ref)
    np.testing.assert_allclose(x_torch.numpy(), x_ref, rtol=0,
                               atol=tol * max(np.abs(x_ref).max(), 1.0))


def test_factory_dispatch_mirrors_jax():
    kw = dict(device=CPU, dtype=torch.float32)
    assert isinstance(tsc.make_circulant_solver((4, 4, 4), (0, 0, 0), **kw), tsc.IdentitySolver)
    assert isinstance(tsc.make_circulant_solver((4, 4, 4), (0, 0, 2.0), **kw),
                      tsc.DenseCirculantSolver)
    s = tsc.make_circulant_solver((4, 4, 4), (0, 1.0, 2.0), **kw)
    assert isinstance(s, tdm.MatmulCirculantSolver) and s.axes == (1,)
    s = tsc.make_circulant_solver((4, 4, 4), (1.0, 1.0, 2.0), **kw)
    assert isinstance(s, tdm.MatmulCirculantSolver) and s.axes == (0, 1)
    full = tsc.make_circulant_solver((4, 4, 4), (0, 0, 2.0), elide_zero_axes=False, **kw)
    assert isinstance(full, tdm.MatmulCirculantSolver)
    fused = tsc.make_circulant_solver((4, 4, 4), (0, 0, 2.0), elide_zero_axes=False,
                                      fused=True, **kw)
    assert isinstance(fused, tfc.FusedCirculantSolver)
    # non-3D shapes go to the staged solver, as in the JAX package
    assert isinstance(tfc.FusedCirculantSolver.create((16,), (2.0,), **kw),
                      tdm.MatmulCirculantSolver)
    assert isinstance(jfc.FusedCirculantSolver.create((16,), (2.0,), jnp.float32,
                                                      interpret=True), jdm.MatmulCirculantSolver)


def test_identity_solver():
    s = tsc.make_circulant_solver((4, 4), (0.0, 0.0), device=CPU, dtype=torch.float32)
    b = torch.as_tensor(_b((4, 4), dtype=np.float32))
    assert torch.equal(s.solve(b), b)


@pytest.mark.parametrize("shape,lams", [((6, 5, 8), (0.0, 0.0, 3.7)),
                                        ((6, 5, 8), (0.0, 3.7, 0.0)),
                                        ((6, 5, 8), (3.7, 0.0, 0.0)),
                                        ((16,), (2.0,)), ((8, 12), (0.0, 1.5))])
def test_dense_matches_jax_f64(shape, lams):
    js = jsc.DenseCirculantSolver.create(shape, lams, jnp.float64)
    ts = tsc.DenseCirculantSolver.from_numpy_arrays(
        shape, js.axis, [np.asarray(a) for a in js.arrays], **F64)
    own = tsc.DenseCirculantSolver.create(shape, lams, **F64)
    np.testing.assert_array_equal(own.arrays[0].numpy(), ts.arrays[0].numpy())
    b = _b(shape, 1)
    _close(ts.solve(torch.as_tensor(b)), js.solve(jnp.asarray(b)))
    _close(ts.solve(torch.as_tensor(b.reshape(-1))), js.solve(jnp.asarray(b.reshape(-1))))


@pytest.mark.parametrize("elide", [False, True])
@pytest.mark.parametrize("shape,lams", [((6, 5, 8), (0.3, 0.2, 0.9)),
                                        ((6, 5, 8), (0.0, 2.0, 1.0)),
                                        ((12, 9, 10), (1.5, 0.0, 4.0)),
                                        ((8, 12), (0.0, 1.5)), ((16,), (2.0,))])
def test_matmul_solver_matches_jax_f64(shape, lams, elide):
    js = jdm.MatmulCirculantSolver.create(shape, lams, jnp.float64, precision="highest",
                                          elide_zero_axes=elide)
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(js.arrays)]
    ts = tdm.MatmulCirculantSolver.from_numpy_arrays(shape, leaves, axes=js.axes, **F64)
    own = tdm.MatmulCirculantSolver.create(shape, lams, elide_zero_axes=elide, **F64)
    assert own.axes == js.axes
    b = _b(shape, 2)
    x_ref = js.solve(jnp.asarray(b))
    _close(ts.solve(torch.as_tensor(b)), x_ref)
    _close(own.solve(torch.as_tensor(b)), x_ref)


def test_matmul_kernel_route_not_ported():
    """The kernel route is ported (kernel K3, tests/test_torch_complex_matmul.py):
    on a CPU tensor it runs K3's plain version and equals the JAX kernel route."""
    shape, lams = (8, 8, 8), (1.0, 1.0, 1.0)
    ts = tdm.MatmulCirculantSolver.create(shape, lams, use_kernel=True, **F64)
    js = jdm.MatmulCirculantSolver.create(shape, lams, jnp.float64, use_kernel=True)
    b = _b(shape, 3)
    _close(ts.solve(torch.as_tensor(b)), js.solve(jnp.asarray(b)))


@pytest.mark.parametrize("precision,atol", [("highest", 1e-5), ("high", 2e-4),
                                            ("default", 5e-2)])
def test_fused_plain_matches_jax_interpret(precision, atol):
    """K1's plain version against the JAX Pallas kernel in interpret mode,
    fed the JAX kernel's own (padded) tables."""
    shape, lams = (6, 5, 8), (0.3, 0.2, 0.9)
    js = jfc.FusedCirculantSolver.create(shape, lams, jnp.float32, precision=precision,
                                         interpret=True)
    assert isinstance(js, jfc.FusedCirculantSolver)
    ts = tfc.FusedCirculantSolver.from_numpy_arrays(
        shape, [np.asarray(a) for a in js.arrays], device=CPU, dtype=torch.float32,
        precision=precision)
    b = _b(shape, 6, np.float32)
    xj = np.asarray(js.solve(jnp.asarray(b)))
    xt = ts.solve(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=atol * np.abs(xj).max())
    np.testing.assert_allclose(ts.solve(torch.as_tensor(b.reshape(-1))).numpy(),
                               xt.reshape(-1), rtol=0, atol=1e-7 * np.abs(xt).max())


@pytest.mark.parametrize("shape,lams", [((6, 5, 8), (0.3, 0.2, 0.9)),
                                        ((7, 9, 11), (2.0, 0.0, 55.5))])
def test_fused_plain_matches_jax_matmul_f64(shape, lams):
    js = jdm.MatmulCirculantSolver.create(shape, lams, jnp.float64, precision="highest")
    ts = tfc.FusedCirculantSolver.create(shape, lams, **F64)
    b = _b(shape, 7)
    _close(ts.solve(torch.as_tensor(b)), js.solve(jnp.asarray(b)))
    # and it inverts the operator
    op = CirculantTransportOperator.create(shape, lams, **F64)
    _close(op.matvec(ts.solve(torch.as_tensor(b))), b)


def test_fused_tables_match_jax_cropped():
    """The port's own tables equal the JAX tables with the padding cropped."""
    shape, lams = (6, 5, 8), (0.3, 0.2, 0.9)
    js = jfc.FusedCirculantSolver.create(shape, lams, jnp.float64, interpret=True)
    from_jax = tfc.FusedCirculantSolver.from_numpy_arrays(
        shape, [np.asarray(a) for a in js.arrays], **F64)
    own = tfc.FusedCirculantSolver.create(shape, lams, **F64)
    for name, a, b in zip(tfc.TABLE_NAMES, own.arrays, from_jax.arrays):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def test_fused_cpu_never_counts_kernel_launches():
    before = tfc.FusedCirculantSolver.launches
    s = tfc.FusedCirculantSolver.create((4, 4, 4), (1.0, 0.5, 0.25), device=CPU,
                                        dtype=torch.float32)
    s.solve(torch.ones(64))
    assert tfc.FusedCirculantSolver.launches == before


def test_fused_cuda_wrapper_rejects_cpu_tensors():
    s = tfc.FusedCirculantSolver.create((4, 4, 4), (1.0, 0.5, 0.25), device=CPU,
                                        dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.fused_circulant_solve_cuda(torch.ones(4, 4, 4), s.arrays)
