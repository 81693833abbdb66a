"""The port's block-circulant pieces against the JAX package in float64 on
the CPU: stencil_symbol, BlockCirculantOperator, MatmulBlockCirculantSolver,
and WaveSystem's block_circulant_operator and block_fft_stepper (both
methods).

Tolerances: 1e-12 × max|reference|. Both sides build the same complex128
symbol on the host and run the same float64 transforms (FFT or dense DFT
matrices), summing in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cart
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.ops import circulant as jc
from circulantpreconditioner_tpu.ops import dft_matmul as jdm
from circulantpreconditioner_tpu.ops.assembly import wave_block_stencil as j_stencil
from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh as t_cart
from circulantpreconditioner_tpu_torch.models import WaveSystem as TWave
from circulantpreconditioner_tpu_torch.ops import circulant as tc
from circulantpreconditioner_tpu_torch.ops import dft_matmul as tdm
from circulantpreconditioner_tpu_torch.ops.assembly import wave_block_stencil as t_stencil

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)


def _close(x_torch, x_ref, tol=1e-12):
    x_ref = np.asarray(x_ref)
    x = x_torch.numpy()
    assert x.shape == x_ref.shape
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=tol * np.abs(x_ref).max())


def _wave_stencil(dim, dt=0.003, c0=700.0):
    h = [0.1, 0.125, 0.2][:dim]
    offs, blocks = j_stencil(dim, dt, c0, h)
    offs_t, blocks_t = t_stencil(dim, dt, c0, h)
    assert [tuple(o) for o in offs] == [tuple(o) for o in offs_t]
    np.testing.assert_array_equal(np.asarray(blocks), blocks_t)
    return offs, np.asarray(blocks)


def test_stencil_symbol_matches_jax():
    shape = (5, 4, 6)
    offs = [(0, 0, 0), (0, 0, -1), (0, 1, 0), (-1, 0, 2)]
    coeffs = [1.3, -0.4, 0.25, 0.7]
    s_j = jc.stencil_symbol(shape, offs, coeffs, dtype=jnp.float64)
    s_t = tc.stencil_symbol(shape, offs, coeffs, **F64)
    assert s_t.dtype == torch.complex128
    _close(s_t, s_j)
    # the transport spectrum is the symbol of the upwind stencil
    lam = tc.np_eigenvalue_diagonal(shape, (0.3, 0.2, 0.9))
    s = tc.stencil_symbol(shape, [(0, 0, 0), (-1, 0, 0), (0, -1, 0), (0, 0, -1)],
                          [1 + 0.3 + 0.2 + 0.9, -0.3, -0.2, -0.9], **F64)
    np.testing.assert_allclose(s.numpy(), lam, atol=1e-13)


@pytest.mark.parametrize("shape", [(4, 5, 6), (6, 8), (7,)])
def test_block_circulant_operator_matches_jax(shape):
    dim = len(shape)
    offs, blocks = _wave_stencil(dim)
    j_op = jc.BlockCirculantOperator.from_stencil(shape, offs, blocks, dtype=jnp.float64)
    t_op = tc.BlockCirculantOperator.from_stencil(shape, offs, blocks, **F64)
    np.testing.assert_array_equal(tc.BlockCirculantOperator.np_symbol(shape, offs, blocks),
                                  jc.BlockCirculantOperator.np_symbol(shape, offs, blocks))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(j_op)]
    t_arr = tc.BlockCirculantOperator.from_numpy_arrays(shape, leaves, **F64)
    b = np.random.default_rng(1).normal(size=int(np.prod(shape)) * (dim + 1))
    x_j = j_op.solve(jnp.asarray(b))
    for op in (t_op, t_arr):
        _close(op.solve(torch.as_tensor(b)), x_j)
        _close(op.as_preconditioner()(torch.as_tensor(b.reshape(shape + (dim + 1,)))),
               x_j.reshape(shape + (dim + 1,)))
    # complex input stays complex
    bc = b + 1j * np.random.default_rng(2).normal(size=b.shape)
    _close(t_op.solve(torch.as_tensor(bc)), j_op.solve(jnp.asarray(bc)))


@pytest.mark.parametrize("shape", [(4, 5, 6), (6, 8), (9,)])
def test_matmul_block_solver_matches_jax(shape):
    dim = len(shape)
    offs, blocks = _wave_stencil(dim)
    j_s = jdm.MatmulBlockCirculantSolver.from_stencil(shape, offs, blocks, jnp.float64)
    t_s = tdm.MatmulBlockCirculantSolver.from_stencil(shape, offs, blocks, **F64)
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(j_s.arrays)]
    t_arr = tdm.MatmulBlockCirculantSolver.from_numpy_arrays(shape, dim + 1, leaves, **F64)
    assert t_s.m == j_s.m == dim + 1
    b = np.random.default_rng(3).normal(size=int(np.prod(shape)) * (dim + 1))
    x_j = j_s.solve(jnp.asarray(b))
    for s in (t_s, t_arr):
        _close(s.solve(torch.as_tensor(b)), x_j)
    # the staged DFT form and the FFT form are the same operator inverse
    t_fft = tc.BlockCirculantOperator.from_stencil(shape, offs, blocks, **F64)
    _close(t_s.solve(torch.as_tensor(b)), t_fft.solve(torch.as_tensor(b)).numpy())


@pytest.mark.parametrize("method", ["fft", "matmul", "auto"])
def test_block_fft_stepper_matches_jax(method):
    n = (6, 5, 4)
    bounds = ((-0.5, 0.5),) * 3
    mj = JWave(j_cart(bounds, n, periodic=True), cfl=300.0, dtype=jnp.float64)
    mt = TWave(t_cart(bounds, n, periodic=True), cfl=300.0, **F64)
    U_j, U_t = mj.initial_state(), mt.initial_state()
    step_j = mj.block_fft_stepper(method if method != "auto" else "fft")
    step_t = mt.block_fft_stepper(method)
    for _ in range(3):
        U_j, d_j = step_j(U_j)
        U_t, d_t = step_t(U_t)
        np.testing.assert_allclose(float(d_t), float(d_j), rtol=1e-12)
    _close(U_t, U_j)
    # each step solves (I + D) U1 = U0 exactly on the periodic grid
    U1, _ = step_t(mt.initial_state())
    r = mt.implicit_matvec()(U1) - mt.initial_state()
    assert (torch.linalg.norm(r) / torch.linalg.norm(mt.initial_state())).item() < 1e-12


def test_block_circulant_operator_needs_a_structured_mesh():
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh

    mt = TWave(kershaw_mesh(((-0.5, 0.5),) * 3, (4, 4, 4)), cfl=1.0, **F64)
    with pytest.raises(ValueError, match="structured"):
        mt.block_circulant_operator
    with pytest.raises(ValueError, match="method"):
        TWave(t_cart(((0, 1),) * 2, (4, 4), periodic=True), cfl=1.0,
              **F64).block_fft_stepper("bogus")
