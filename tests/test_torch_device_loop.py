"""The device-resident Krylov loops (solvers/gmres.py, cg.py, bicgstab.py,
utils/graphs.py) on the CPU, float64: the same code the card captures runs
eagerly here, with the flags read lookahead L iterations behind (a solver's
`_lookahead`; LOOKAHEAD = 1 is the default).

For each case the port runs at L = 0, 1 and 3. The results must be
bit-identical across L: the up to L iterations queued past the stop run
masked and change nothing the result reads. The iteration counts and the
convergence flags must equal the JAX solver's on the same NumPy inputs, and
x must agree with it to 1e-10 × max|x| (the projections sum in another
order). The kernel launch counters must hold every launch: those of the
iterations the solve kept, whatever L, and those of the masked ones, which
STATS.masked_launches holds apart.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_mesh
from circulantpreconditioner_tpu.models import TransportEquation as JTransport
from circulantpreconditioner_tpu.ops.csr import CSRMatrix as JCSR
from circulantpreconditioner_tpu.solvers import make_bicgstab as j_make_bicgstab
from circulantpreconditioner_tpu.solvers import make_cg as j_make_cg
from circulantpreconditioner_tpu.solvers import make_gmres as j_make_gmres
from circulantpreconditioner_tpu.solvers import preconditioners as jpcs
from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh as t_mesh
from circulantpreconditioner_tpu_torch.models import TransportEquation as TTransport
from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix as TCSR
from circulantpreconditioner_tpu_torch.ops.plane_stencil import PlaneStencilMatvec
from circulantpreconditioner_tpu_torch.solvers import make_bicgstab, make_cg, make_gmres
from circulantpreconditioner_tpu_torch.solvers import preconditioners as tpcs
from circulantpreconditioner_tpu_torch.utils.graphs import STATS

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)
LOOKAHEADS = (0, 1, 3)


def _transport(periodic=False, shape=(8, 6, 5), cfl=20.0, pc="none"):
    bounds = ((-0.5, 0.5),) * 3
    vel = (1.0, 0.5, 0.25)
    jm = JTransport(j_mesh(bounds, shape, periodic=periodic), vel, cfl=cfl, dtype=jnp.float64)
    tm = TTransport(t_mesh(bounds, shape, periodic=periodic), vel, cfl=cfl, **F64)
    Mj = Mt = None
    if pc == "jacobi":
        Mj, Mt = jpcs.jacobi(jm.divergence), tpcs.jacobi(tm.divergence)
    b = np.random.default_rng(0).normal(size=jm.mesh.n_cells) + 600.0
    return jm.implicit_matvec(), tm.implicit_matvec(), Mj, Mt, b


def _laplace_1d(n: int, shift: float, skew: float):
    """Tridiagonal (−1 − skew, 2 + shift, −1 + skew): SPD for skew = 0."""
    import scipy.sparse as sp

    return sp.diags([-1.0 - skew, 2.0 + shift, -1.0 + skew], [-1, 0, 1], shape=(n, n),
                    format="csr")


def _sparse(n=60, shift=0.05, skew=0.0, pc=False):
    A = _laplace_1d(n, shift, skew)
    Aj, At = JCSR.from_scipy(A, dtype=jnp.float64), TCSR.from_scipy(A, **F64)
    Mj, Mt = (jpcs.jacobi(Aj), tpcs.jacobi(At)) if pc else (None, None)
    b = np.random.default_rng(3).normal(size=n)
    return Aj.matvec, At.matvec, Mj, Mt, b


# name: (JAX factory, port factory, problem, solver keywords, x0 scale)
CASES = {
    "gmres_left": (j_make_gmres, make_gmres, functools.partial(_transport, pc="jacobi"),
                   dict(rtol=1e-9, atol=1e-12), None),
    "gmres_right": (j_make_gmres, make_gmres, functools.partial(_transport, pc="jacobi"),
                    dict(restart=7, rtol=1e-9, atol=1e-12, side="right"), None),
    "gmres_restarts_left": (j_make_gmres, make_gmres, functools.partial(_transport, pc="jacobi"),
                            dict(restart=5, rtol=1e-9, atol=1e-12), None),
    "gmres_restarts_right": (j_make_gmres, make_gmres,
                             functools.partial(_transport, shape=(10, 8, 6), cfl=60.0,
                                               pc="jacobi"),
                             dict(restart=5, rtol=1e-9, atol=1e-12, side="right"), None),
    "gmres_maxiter_left": (j_make_gmres, make_gmres,
                           functools.partial(_transport, cfl=60.0, pc="jacobi"),
                           dict(restart=5, rtol=1e-14, atol=1e-14, maxiter=7), None),
    "gmres_maxiter_right": (j_make_gmres, make_gmres,
                            functools.partial(_transport, cfl=60.0, pc="jacobi"),
                            dict(restart=5, rtol=1e-14, atol=1e-14, maxiter=7,
                                 side="right"), None),
    "gmres_diverging": (j_make_gmres, make_gmres, functools.partial(_transport, periodic=True),
                        dict(rtol=1e-8), 1e6),
    "gmres_initial_guess": (j_make_gmres, make_gmres, functools.partial(_transport, pc="jacobi"),
                            dict(rtol=1e-9, atol=1e-12, side="right"), 1e-2),
    "cg": (j_make_cg, make_cg, functools.partial(_sparse, pc=True),
           dict(rtol=1e-10, atol=1e-12), None),
    "cg_maxiter": (j_make_cg, make_cg, _sparse, dict(rtol=1e-12, atol=1e-14, maxiter=9), None),
    "bicgstab": (j_make_bicgstab, make_bicgstab, functools.partial(_sparse, skew=0.4),
                 dict(rtol=1e-10, atol=1e-12), None),
    "bicgstab_pc": (j_make_bicgstab, make_bicgstab,
                    functools.partial(_sparse, skew=0.4, pc=True),
                    dict(rtol=1e-10, atol=1e-12, maxiter=500), 1.0),
}


def _x0(b, scale):
    if scale is None:
        return None
    return scale * np.random.default_rng(1).normal(size=b.shape) * np.abs(b).max()


def _solver(factory, At, Mt, kw, lookahead):
    solver = factory(At, Mt, **kw)
    solver._lookahead = lookahead
    return solver


def _run_port(factory, At, Mt, b, x0, kw, lookahead):
    STATS.reset()
    res = _solver(factory, At, Mt, kw, lookahead)(
        torch.as_tensor(b), None if x0 is None else torch.as_tensor(x0))
    return res, STATS.snapshot()


def _assert_identical(results):
    (r0, _), *rest = results
    for r, _ in rest:
        assert r.iters == r0.iters and r.converged == r0.converged
        assert r.resnorm == r0.resnorm  # bit for bit
        assert torch.equal(r.x, r0.x)


def _compare_jax(rj, rt, b):
    assert rt.iters == int(rj.iters)
    assert rt.converged == bool(rj.converged)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0, atol=1e-10 * np.abs(xj).max())
    np.testing.assert_allclose(rt.resnorm, float(rj.resnorm), rtol=1e-6,
                               atol=1e-12 * np.linalg.norm(b))


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_loop_matches_jax_at_every_lookahead(case):
    j_factory, t_factory, problem, kw, x0_scale = CASES[case]
    Aj, At, Mj, Mt, b = problem()
    x0 = _x0(b, x0_scale)
    rj = j_factory(Aj, Mj, **kw)(jnp.asarray(b), None if x0 is None else jnp.asarray(x0))
    results = [_run_port(t_factory, At, Mt, b, x0, kw, L) for L in LOOKAHEADS]
    _assert_identical(results)
    _compare_jax(rj, results[0][0], b)
    for L, (r, stats) in zip(LOOKAHEADS, results):
        assert stats["iterations"] == r.iters  # every kept iteration read once
        assert stats["solves"] == 1
        if L == 0 and r.iters:  # only a cycle that stops at its start runs one masked
            assert stats["masked"] == 0
    if "maxiter" in case:
        assert not results[0][0].converged and results[0][0].iters == kw["maxiter"]
    elif "diverging" in case:
        assert results[0][0].iters == 0 and not results[0][0].converged
    else:
        r = results[0][0]
        assert r.converged
        if r.iters % kw.get("restart", 30) or not case.startswith("gmres"):
            # a stop inside a cycle: the lookahead queued iterations past it, masked
            assert all(s["masked"] >= min(L, 1) for L, (_, s) in zip(LOOKAHEADS, results))


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_gmres_convergence_at_the_last_inner_index(offset):
    """restart m = N + offset, N the iterations of one long cycle: at offset 0
    the stopping test trips at inner index j = m − 1, the cycle's last, where
    the restart test trips too; at −1 a restart comes one iteration early."""
    Aj, At, Mj, Mt, b = _transport(pc="jacobi")
    kw = dict(rtol=1e-8, atol=1e-12, side="right")
    N = int(j_make_gmres(Aj, Mj, restart=200, **kw)(jnp.asarray(b)).iters)
    kw["restart"] = N + offset
    rj = j_make_gmres(Aj, Mj, **kw)(jnp.asarray(b))
    results = [_run_port(make_gmres, At, Mt, b, None, kw, L) for L in LOOKAHEADS]
    _assert_identical(results)
    _compare_jax(rj, results[0][0], b)
    assert results[0][0].converged
    if offset >= 0:
        assert results[0][0].iters == N


def _counting(fn):
    """fn, counting one K2 launch per call (the CPU runs no kernel: this stands
    in for an operator whose apply launches K2 once)."""
    def apply(v):
        PlaneStencilMatvec.launches += 1
        return fn(v)
    return apply


@pytest.mark.parametrize("side", ["left", "right"])
def test_launch_counters_hold_the_kept_iterations(side):
    """K2 launches of a right-preconditioned GMRES whose A and M each launch
    K2 once: per solve one initial residual, one residual per restart cycle,
    one A per iteration, and one M per iteration and per cycle (the
    correction); left: the same A, and M on b, on each residual and per
    iteration. An iteration queued past the stop runs masked and launches A
    and M all the same: those 2 per masked iteration are counted too, and
    STATS.masked_launches holds them apart."""
    Aj, At, Mj, Mt, b = _transport(shape=(10, 8, 6), cfl=60.0, pc="jacobi")
    kept = set()
    for L in LOOKAHEADS:
        PlaneStencilMatvec.launches = 0
        STATS.reset()
        res = _solver(make_gmres, _counting(At), _counting(Mt),
                      dict(restart=5, rtol=1e-9, atol=1e-12, side=side), L)(torch.as_tensor(b))
        cycles = -(-res.iters // 5)
        if side == "right":
            expected = (1 + cycles + res.iters) + (res.iters + cycles)
        else:
            expected = (1 + cycles + res.iters) + (2 + cycles + res.iters)
        assert STATS.masked_launches == (0, 2 * STATS.masked, 0, 0, 0, 0, 0)
        if res.converged:  # a stop inside a cycle (maxiter ends one without masked iterations)
            assert STATS.masked >= min(L, 1)
        assert PlaneStencilMatvec.launches == expected + 2 * STATS.masked
        kept.add(PlaneStencilMatvec.launches - STATS.masked_launches[1])
    assert len(kept) == 1 and res.iters > 5


def test_cg_launch_counters_hold_the_kept_iterations():
    Aj, At, Mj, Mt, b = _sparse(pc=True)
    for L in LOOKAHEADS:
        PlaneStencilMatvec.launches = 0
        STATS.reset()
        res = _solver(make_cg, _counting(At), None, dict(rtol=1e-10, atol=1e-12), L)(
            torch.as_tensor(b))
        assert STATS.masked == L and STATS.masked_launches == (0, L, 0, 0, 0, 0, 0)
        # the initial residual, one A per iteration, masked ones included
        assert PlaneStencilMatvec.launches == 1 + res.iters + STATS.masked


def test_returned_x_is_a_copy():
    """models/*.py call solver(U, U) once per step with the same solver: the
    result must not be a view of the solver's state, which the next solve
    overwrites."""
    _, At, _, Mt, b = _transport(pc="jacobi")
    solver = make_gmres(At, Mt, rtol=1e-10, atol=1e-12)
    bt = torch.as_tensor(b)
    first = solver(bt, bt)
    x1 = first.x.clone()
    second = solver(first.x, first.x)
    assert torch.equal(first.x, x1) and not torch.equal(second.x, first.x)
    assert first.x.data_ptr() != solver.x.data_ptr()


def test_rejects_bad_arguments():
    with pytest.raises(ValueError):
        make_gmres(lambda v: v, restart=0)
    with pytest.raises(ValueError):
        make_gmres(lambda v: v, side="top")
