"""Kernel K3's plain version (ops/complex_matmul.py) and the staged DFT solver's
kernel route (MatmulCirculantSolver(use_kernel=True)) against the JAX
package. The CUDA kernel itself is checked against this plain version in
tests/test_torch_gpu.py and chip_smoke.py.

Tolerances:
- against the Pallas kernel in interpret mode (float32 accumulators):
  1e-5 × max|o|, float32 sums of up to 256 terms in another order;
- against the JAX fallback dots and the einsum solver in float64: 1e-12 ×
  max|reference| (the same float64 products, summed in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circulantpreconditioner_tpu.ops import dft_matmul as jdm
from circulantpreconditioner_tpu.ops.pallas_kernels import complex_matmul as j_cmm
from circulantpreconditioner_tpu_torch.ops import dft_matmul as tdm
from circulantpreconditioner_tpu_torch.ops.complex_matmul import (
    ComplexMatmulKernel,
    complex_matmul,
    complex_matmul_cuda,
    complex_matmul_reference,
)

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)


def _planes(shape, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(2)]


def _close(x_torch, x_ref, tol):
    x_ref = np.asarray(x_ref)
    np.testing.assert_allclose(x_torch.numpy(), x_ref, rtol=0, atol=tol * np.abs(x_ref).max())


@pytest.mark.parametrize("M,K,N", [(256, 128, 128), (128, 256, 384)])
def test_plain_matches_pallas_interpret(M, K, N):
    a, b = _planes((M, K), 0, np.float32), _planes((K, N), 1, np.float32)
    o_j = j_cmm(*(jnp.asarray(x) for x in a + b), interpret=True)
    o_t = complex_matmul_reference(*(torch.as_tensor(x) for x in a + b))
    for t, j in zip(o_t, o_j):
        _close(t, j, 1e-5)


@pytest.mark.parametrize("M,K,N", [(100, 100, 50), (37, 45, 29), (1, 7, 3)])
def test_plain_matches_jax_fallback_dots(M, K, N):
    a, b = _planes((M, K), 2), _planes((K, N), 3)
    o_j = j_cmm(*(jnp.asarray(x) for x in a + b))  # shapes that do not tile by 128
    o_t = complex_matmul(*(torch.as_tensor(x) for x in a + b))
    for t, j in zip(o_t, o_j):
        _close(t, j, 1e-12)
    want = (a[0] + 1j * a[1]) @ (b[0] + 1j * b[1])
    _close(o_t[0], want.real, 1e-12)
    _close(o_t[1], want.imag, 1e-12)


def test_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    a, b = _planes((5, 4), 4), _planes((4, 3), 5)
    before = ComplexMatmulKernel.launches
    complex_matmul(*(torch.as_tensor(x) for x in a + b))
    assert ComplexMatmulKernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    a, b = _planes((5, 4), 4), _planes((4, 3), 5)
    with pytest.raises(ValueError, match="CUDA"):
        complex_matmul_cuda(*(torch.as_tensor(x) for x in a + b))


@pytest.mark.parametrize("shape,lams", [((4, 8, 6), (0.3, -0.2, 1.1)),
                                        ((6, 5, 7), (0.0, 0.4, 2.0)),
                                        ((9, 6), (1.5, 0.7))])
def test_solver_kernel_route_matches_jax_kernel_route(shape, lams):
    """Shapes that do not tile by 128: the JAX kernel route runs its plain
    dots through the same 2D collapse."""
    js = jdm.MatmulCirculantSolver.create(shape, lams, jnp.float64, use_kernel=True)
    ts = tdm.MatmulCirculantSolver.create(shape, lams, use_kernel=True, **F64)
    assert ts.use_kernel and ts.axes == js.axes
    b = np.random.default_rng(6).normal(size=shape)
    _close(ts.solve(torch.as_tensor(b)), js.solve(jnp.asarray(b)), 1e-12)
    _close(ts.solve(torch.as_tensor(b.reshape(-1))), js.solve(jnp.asarray(b)).reshape(-1),
           1e-12)


@pytest.mark.parametrize("elide", [False, True])
def test_solver_kernel_route_matches_jax_einsum_at_tiled_shape(elide):
    """At 128-multiples the JAX kernel route needs the TPU; its einsum form
    computes the same function."""
    shape, lams = (128, 8, 6), (0.0, 0.3, 1.2)
    js = jdm.MatmulCirculantSolver.create(shape, lams, jnp.float64, elide_zero_axes=elide)
    ts = tdm.MatmulCirculantSolver.create(shape, lams, use_kernel=True, elide_zero_axes=elide,
                                          **F64)
    assert ts.axes == js.axes
    b = np.random.default_rng(7).normal(size=shape)
    _close(ts.solve(torch.as_tensor(b)), js.solve(jnp.asarray(b)), 1e-12)
