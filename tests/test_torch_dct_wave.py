"""The port's wall-boundary DCT/DST block solver (ops/dct_wave.py) and the
DCT direct steppers against the JAX package in float64 on the CPU.

Tolerances: tables equal entry for entry (the same host NumPy code), the
JAX tables cropped to n + 1 frequency slots per axis (the port drops the
TPU's 8-alignment);
solves and steps 1e-12 × max|reference| (the same float64 contractions,
summed in another order); the solve inverts the assembled wall operator to
1e-11 relative residual, the JAX package's own bar
(tests/test_dct_wave.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cart
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.ops.dct_wave import DCTBlockWaveSolver as JDCT
from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh as t_cart
from circulantpreconditioner_tpu_torch.models import WaveSystem as TWave
from circulantpreconditioner_tpu_torch.ops.assembly import wave_divergence_bsr
from circulantpreconditioner_tpu_torch.ops.dct_wave import DCTBlockWaveSolver as TDCT

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)
CASES = [((4, 3, 5), ((0, 1), (0, 0.8), (0, 1.2))), ((6, 4), ((0, 1), (0, 1))),
         ((7,), ((0, 1),))]


def _close(x_torch, x_ref, tol=1e-12):
    x_ref = np.asarray(x_ref)
    x = x_torch.numpy() if isinstance(x_torch, torch.Tensor) else np.asarray(x_torch)
    assert x.shape == x_ref.shape
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=tol * np.abs(x_ref).max())


def _solvers(n_xyz, bounds, dt=0.001, c0=700.0):
    dim = len(n_xyz)
    spacing = [(bounds[d][1] - bounds[d][0]) / n_xyz[d] for d in range(dim)]
    shape = tuple(reversed(n_xyz))
    return (JDCT.create(shape, dim, dt, c0, spacing, jnp.float64, precision="highest"),
            TDCT.create(shape, dim, dt, c0, spacing, precision="highest", **F64))


@pytest.mark.parametrize("n_xyz,bounds", CASES)
def test_tables_and_solves_match_jax(n_xyz, bounds):
    js, ts = _solvers(n_xyz, bounds)
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(js.arrays)]
    t_leaves = [ts.arrays[0]] + [t for pair in ts.arrays[1] for t in pair]
    assert len(leaves) == len(t_leaves)
    F = tuple(n + 1 for n in ts.shape_zyx)
    cropped = [leaves[0][(slice(None),) * 2 + tuple(slice(f) for f in F)]]
    for a, f in enumerate(F):
        assert leaves[1 + 2 * a].shape[1] >= f  # the JAX package pads, never crops
        cropped += [leaves[1 + 2 * a][:, :f, :], leaves[2 + 2 * a][:, :, :f]]
    for a, b in zip(cropped, t_leaves):
        np.testing.assert_array_equal(b.numpy(), a)
    ta = TDCT.from_numpy_arrays(ts.shape_zyx, ts.nb, leaves, **F64)
    assert ts.m == ts.nb == len(n_xyz) + 1
    N = int(np.prod(n_xyz))
    rng = np.random.default_rng(0)
    b = rng.normal(size=N * ts.nb)
    x_j = js.solve(jnp.asarray(b))
    gb = rng.normal(size=(ts.nb,) + ts.shape_zyx)
    y_j = js.solve_fm(jnp.asarray(gb))
    for s in (ts, ta):
        _close(s.solve(torch.as_tensor(b)), x_j)
        _close(s.solve(torch.as_tensor(b.reshape(ts.shape_zyx + (ts.nb,)))),
               x_j.reshape(ts.shape_zyx + (ts.nb,)))
        _close(s.solve_fm(torch.as_tensor(gb)), y_j)


@pytest.mark.parametrize("n_xyz,bounds", CASES)
def test_exact_inverse_of_assembled_wall_operator(n_xyz, bounds):
    mesh = t_cart(bounds, n_xyz)
    _, ts = _solvers(n_xyz, bounds)
    D = wave_divergence_bsr(mesh, 0.001, 700.0, **F64)
    b = torch.as_tensor(np.random.default_rng(1).normal(size=mesh.n_cells * ts.nb))
    x = ts.solve(b)
    assert (torch.linalg.norm(x + D.matvec(x) - b) / torch.linalg.norm(b)).item() < 1e-11


def test_dct_steppers_match_jax():
    n, bounds = (5, 4, 3), ((0, 1), (0, 0.8), (0, 1.2))
    mj = JWave(j_cart(bounds, n), cfl=300.0, dtype=jnp.float64)
    mt = TWave(t_cart(bounds, n), cfl=300.0, **F64)
    sj, st, st_fm = mj.dct_fft_stepper(), mt.dct_fft_stepper(), mt.dct_fft_stepper_fm()
    sj_fm = mj.dct_fft_stepper_fm()
    U_j, U_t = mj.initial_state(), mt.initial_state()
    G_j, G_t = mj.pack_fm(U_j), mt.pack_fm(U_t)
    G_flat = mt.pack_fm(U_t).reshape(-1)
    for _ in range(4):
        U_j, d_j = sj(U_j)
        U_t, d_t = st(U_t)
        G_j, dg_j = sj_fm(G_j)
        G_t, dg_t = st_fm(G_t)
        G_flat, dgf = st_fm(G_flat)
        for d in (d_t, dg_t, dgf):
            np.testing.assert_allclose(float(d), float(d_j), rtol=1e-12)
        np.testing.assert_allclose(float(dg_t), float(dg_j), rtol=1e-12)
    _close(U_t, U_j)
    _close(mt.unpack_fm(G_t), mj.unpack_fm(G_j))
    _close(G_flat, np.asarray(G_j).reshape(-1))


def test_dct_stepper_needs_a_wall_mesh():
    mt = TWave(t_cart(((0, 1),) * 2, (4, 4), periodic=True), cfl=1.0, **F64)
    for make in (mt.dct_fft_stepper, mt.dct_fft_stepper_fm):
        with pytest.raises(ValueError, match="Wall"):
            make()
