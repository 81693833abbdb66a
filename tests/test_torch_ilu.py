"""The port's ILU(0) and block-Jacobi ILU(0) against the JAX package (float64
on the CPU, the same NumPy inputs).

Tolerances:
- the host factor and the level schedules: equal bit for bit (the same
  float64 operations on each entry, in the same order);
- one apply: 1e-12 × max|x_JAX|, against both JAX schedules ("unrolled" and
  "scan": the same per-level updates, sums in another order);
- GMRES + ILU(0): the same iteration count, x within 1e-10 × max|x|; on
  the 50×50 wave system at cfl 50, 1e-8 × max|x| (the left-preconditioned
  system carries the applies' 1e-16 differences into x at about 1e-9).

The JAX applies are jitted: eager, the "unrolled" schedule compiles each
level's updates on their own (a minute at Kershaw 6³).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cartesian
from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.ops.csr import CSRMatrix as JCSR
from circulantpreconditioner_tpu.solvers import gmres as j_gmres
from circulantpreconditioner_tpu.solvers import preconditioners as jpcs
from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh as t_cartesian
from circulantpreconditioner_tpu_torch.models import WaveSystem as TWave
from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix as TCSR
from circulantpreconditioner_tpu_torch.solvers import gmres as t_gmres
from circulantpreconditioner_tpu_torch.solvers import preconditioners as tpcs

CPU = torch.device("cpu")


def laplace_2d(nx, ny):
    ex, ey = np.ones(nx), np.ones(ny)
    Tx = sp.diags([2 * ex, -ex[:-1], -ex[:-1]], [0, -1, 1])
    Ty = sp.diags([2 * ey, -ey[:-1], -ey[:-1]], [0, -1, 1])
    return (sp.kronsum(Tx, Ty) + 0.05 * sp.eye(nx * ny)).tocsr()


def kershaw_wave_A(n=6):
    """I + D of the wave system on a Kershaw n³ mesh (as the drivers assemble it)."""
    m = JWave(j_kershaw(((-0.5, 0.5),) * 3, (n,) * 3), cfl=1e3 / 3, dtype=jnp.float64)
    return (sp.eye(m.divergence.shape[0]) + m.divergence.to_csr(jnp.float64).to_scipy()).tocsr()


def random_pattern(n=60, seed=0):
    """A nonsymmetric pattern with every diagonal entry stored; row 0 holds
    only its diagonal, an explicit zero: a zero pivot for the rows below."""
    rng = np.random.default_rng(seed)
    A = (sp.random(n, n, density=0.08, random_state=rng, format="csr") + sp.eye(n)).tolil()
    A[0, 1:] = 0.0
    A = A.tocsr()
    A.eliminate_zeros()
    A.sort_indices()
    assert A.indptr[1] == 1 and A.indices[0] == 0
    A.data[0] = 0.0
    return A


def _pair(A):
    return (JCSR.from_scipy(A, dtype=jnp.float64),
            TCSR.from_scipy(A, device=CPU, dtype=torch.float64))


def _arrays(A):
    A = A.tocsr()
    A.sort_indices()
    return (A.indptr.astype(np.int64), A.indices.astype(np.int64),
            A.data.astype(np.float64))


MATRICES = {"laplace 8x8": lambda: laplace_2d(8, 8), "kershaw 6^3 wave": kershaw_wave_A,
            "random with a zero pivot": random_pattern}


@pytest.mark.parametrize("name", list(MATRICES))
def test_factor_and_schedule_equal_jax_bit_for_bit(name):
    A = MATRICES[name]()
    indptr, indices, data = _arrays(A)
    n = A.shape[0]
    fj, dj = jpcs._ilu0_factor_host(indptr, indices, data)
    ft, dt = tpcs._ilu0_factor_host(indptr, indices, data)
    assert np.array_equal(dj, dt)
    assert np.array_equal(fj, ft)  # bit for bit
    for lower in (True, False):
        lj = jpcs._level_schedule(indptr, indices, lower, n)
        lt = tpcs._level_schedule(indptr, indices, lower, n)
        assert len(lj) == len(lt)
        assert all(np.array_equal(a, b) for a, b in zip(lj, lt))


def test_factor_zero_pivot_and_missing_diagonal():
    A = random_pattern()
    indptr, indices, data = _arrays(A)
    f, diag_pos = tpcs._ilu0_factor_host(indptr, indices, data)
    assert data[diag_pos[0]] == 0.0 and np.isfinite(f).all()
    below = A.tocsc()[:, 0].nonzero()[0][1:]  # rows whose first pivot is the zero
    assert len(below)
    for i in below:
        np.testing.assert_equal(f[indptr[i]], data[indptr[i]] / np.finfo(np.float64).tiny)
    B = sp.csr_matrix(np.array([[1.0, 2.0, 0.0], [3.0, 0.0, 1.0], [0.0, 1.0, 4.0]]))
    with pytest.raises(ValueError, match="missing diagonal in row 1"):
        tpcs._ilu0_factor_host(*_arrays(B))
    with pytest.raises(ValueError, match="missing diagonal in row 1"):
        jpcs._ilu0_factor_host(*_arrays(B))


@pytest.mark.parametrize("name", ["laplace 8x8", "kershaw 6^3 wave"])
def test_apply_matches_jax_both_schedules(name):
    A = MATRICES[name]()
    Aj, At = _pair(A)
    r = np.random.default_rng(1).normal(size=A.shape[0])
    pt = tpcs.ilu0(At)
    x = pt.apply(torch.as_tensor(r)).numpy()
    for schedule in ("unrolled", "scan"):
        pj = jpcs.ilu0(Aj, schedule=schedule)
        assert pj.n_levels == pt.n_levels
        xj = np.asarray(jax.jit(pj.apply)(jnp.asarray(r)))
        np.testing.assert_allclose(x, xj, rtol=0, atol=1e-12 * np.abs(xj).max())
    for schedule in ("auto", "unrolled", "scan"):  # one apply for every schedule name
        assert np.array_equal(tpcs.ilu0(At, schedule=schedule).apply(torch.as_tensor(r)).numpy(),
                              x)
    with pytest.raises(ValueError, match="schedule"):
        tpcs.ilu0(At, schedule="chunked")


def test_ilu0_exact_for_triangular_pattern():
    """Lower bidiagonal + diagonal: the LU factors fit the pattern, so
    ILU(0) is exact."""
    n = 50
    A = sp.diags([2 * np.ones(n), -np.ones(n - 1)], [0, -1]).tocsr()
    r = np.random.default_rng(7).normal(size=n)
    x = tpcs.ilu0(_pair(A)[1]).apply(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(x, spla.spsolve(A, r), atol=1e-12)


def test_ilu0_apply_matches_dense_triangular_solves():
    A = laplace_2d(8, 8)
    indptr, indices, data = _arrays(A)
    f, _ = tpcs._ilu0_factor_host(indptr, indices, data)
    n = A.shape[0]
    F = sp.csr_matrix((f, indices, indptr), shape=A.shape).toarray()
    L = np.tril(F, -1) + np.eye(n)
    U = np.triu(F)
    r = np.random.default_rng(8).normal(size=n)
    x = tpcs.ilu0(_pair(A)[1]).apply(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(U, np.linalg.solve(L, r)), atol=1e-10)


def test_gmres_ilu0_accelerates_and_matches_jax():
    A = laplace_2d(20, 20)
    b = np.random.default_rng(9).normal(size=A.shape[0])
    Aj, At = _pair(A)
    kw = dict(rtol=1e-8, atol=1e-10, maxiter=2000)
    plain = t_gmres(At.matvec, torch.as_tensor(b), **kw)
    rt = t_gmres(At.matvec, torch.as_tensor(b), M=tpcs.ilu0(At).apply, **kw)
    rj = j_gmres(Aj.matvec, jnp.asarray(b), M=jpcs.ilu0(Aj).apply, **kw)
    assert rt.converged and rt.iters < plain.iters
    assert rt.iters == int(rj.iters)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0, atol=1e-10 * np.abs(xj).max())
    np.testing.assert_allclose(rt.x.numpy(), spla.spsolve(A, b), rtol=1e-5, atol=1e-6)


def test_block_jacobi_ilu0_matches_jax():
    """The apply against the JAX package's, and GMRES with it against the
    direct solve (the drivers' tests hold the iterations to JAX's)."""
    A = laplace_2d(12, 12)
    b = np.random.default_rng(10).normal(size=A.shape[0])
    Aj, At = _pair(A)
    Mt = tpcs.block_jacobi_ilu0(At, 4)
    r = np.random.default_rng(11).normal(size=A.shape[0])
    zj = np.asarray(jax.jit(jpcs.block_jacobi_ilu0(Aj, 4))(jnp.asarray(r)))
    np.testing.assert_allclose(Mt(torch.as_tensor(r)).numpy(), zj, rtol=0,
                               atol=1e-12 * np.abs(zj).max())
    rt = t_gmres(At.matvec, torch.as_tensor(b), M=Mt, rtol=1e-8, atol=1e-10, maxiter=2000)
    assert rt.converged
    np.testing.assert_allclose(rt.x.numpy(), spla.spsolve(A, b), rtol=1e-5, atol=1e-6)


def _wave_system_50x50(cfl):
    """The reference's implicit-wave configuration: the 50×50 square,
    A = I + D, from each package's own model."""
    bounds = ((0.0, 1.0),) * 2
    mj = JWave(j_cartesian(bounds, (50, 50)), cfl=cfl, dtype=jnp.float64)
    mt = TWave(t_cartesian(bounds, (50, 50)), cfl=cfl, device=CPU, dtype=torch.float64)
    Aj = (sp.eye(mj.divergence.shape[0]) + mj.divergence.to_csr(jnp.float64).to_scipy()).tocsr()
    At = (sp.eye(mt.divergence.shape[0]) + mt.divergence.to_csr().to_scipy()).tocsr()
    return (JCSR.from_scipy(Aj, dtype=jnp.float64), np.asarray(mj.initial_state()),
            TCSR.from_scipy(At, device=CPU, dtype=torch.float64), mt.initial_state())


def test_gmres_ilu0_reference_config_iterations_equal_jax():
    """The 50×50 wave system at cfl 50, GMRES(30) + ILU(0), rtol = atol =
    1e-5: the port converges in the JAX package's iteration count."""
    Aj, bj, At, bt = _wave_system_50x50(50.0)
    kw = dict(restart=30, rtol=1e-5, atol=1e-5, maxiter=1000)
    rj = j_gmres(Aj.matvec, jnp.asarray(bj), M=jpcs.ilu0(Aj).apply, **kw)
    rt = t_gmres(At.matvec, bt, M=tpcs.ilu0(At).apply, **kw)
    assert bool(rj.converged) and rt.converged
    assert rt.iters == int(rj.iters)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0, atol=1e-8 * np.abs(xj).max())


def test_gmres_ilu0_nonconvergence_at_reference_cfl():
    """At the reference's own cfl 1e3/2 GMRES + ILU(0) stalls in both
    packages (the reference drivers log it and go on)."""
    Aj, bj, At, bt = _wave_system_50x50(1e3 / 2)
    kw = dict(restart=30, rtol=1e-5, atol=1e-5, maxiter=90)
    rj = j_gmres(Aj.matvec, jnp.asarray(bj), M=jpcs.ilu0(Aj).apply, **kw)
    rt = t_gmres(At.matvec, bt, M=tpcs.ilu0(At).apply, **kw)
    assert not bool(rj.converged) and not rt.converged
    assert rt.iters == int(rj.iters) == 90
    np.testing.assert_allclose(rt.resnorm, float(rj.resnorm), rtol=1e-6)
