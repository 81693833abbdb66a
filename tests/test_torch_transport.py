"""Parity of the port's transport operators, model steppers and time loop
with the JAX package (float64 on the CPU, same NumPy inputs).

Tolerances: operators at 1e-12 × max|reference| (same float64 arithmetic,
sums in another order); 5-step stepper trajectories at 1e-10 relative (the
implicit steps add GMRES at rtol 1e-12, whose iterates agree to roundoff)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_mesh
from circulantpreconditioner_tpu.models import TransportEquation as JTransport
from circulantpreconditioner_tpu.models import run_time_loop as j_run
from circulantpreconditioner_tpu.ops.assembly import transport_divergence_csr as j_csr
from circulantpreconditioner_tpu.ops.stencil import TransportStencilOperator as JStencil
from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh as t_mesh
from circulantpreconditioner_tpu_torch.models import TransportEquation as TTransport
from circulantpreconditioner_tpu_torch.models import run_time_loop as t_run
from circulantpreconditioner_tpu_torch.models import scan_steps
from circulantpreconditioner_tpu_torch.ops.assembly import transport_divergence_csr as t_csr
from circulantpreconditioner_tpu_torch.ops.stencil import TransportStencilOperator as TStencil

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)
GRIDS = [((10,), (-1.5,)), ((8, 6), (1.0, -0.5)), ((5, 6, 7), (-1.0, 0.5, 0.25))]


def _close(x_torch, x_ref, tol=1e-12):
    x_ref = np.asarray(x_ref)
    np.testing.assert_allclose(np.asarray(x_torch), x_ref, rtol=0,
                               atol=tol * max(np.abs(x_ref).max(), 1.0))


def _meshes(n, periodic):
    bounds = ((-0.5, 0.5),) * len(n)
    return j_mesh(bounds, n, periodic=periodic), t_mesh(bounds, n, periodic=periodic)


@pytest.mark.parametrize("periodic", [True, False])
def test_mesh_copy_matches(periodic):
    jm, tm = _meshes((5, 4, 3), periodic)
    for f in ("cell_center", "cell_volume", "face_cells", "face_normal", "face_area",
              "face_center", "face_group", "periodic_twin"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)
    assert tm.groups == jm.groups and tm.min_ratio_vol_surf() == jm.min_ratio_vol_surf()


def test_set_group_at_plane_matches():
    from circulantpreconditioner_tpu.mesh.structured import set_group_at_plane as j_tag
    from circulantpreconditioner_tpu_torch.mesh import set_group_at_plane as t_tag

    jm, tm = _meshes((6, 4), False)
    j_tag(jm, 0, -0.5, "Inlet")
    t_tag(tm, 0, -0.5, "Inlet")
    np.testing.assert_array_equal(tm.face_group, jm.face_group)
    assert tm.groups == jm.groups and (tm.face_group == tm.groups["Inlet"]).sum() == 4


@pytest.mark.parametrize("bc", ["periodic", "neumann"])
@pytest.mark.parametrize("n,vel", GRIDS)
def test_stencil_matches_jax(n, vel, bc):
    dt, h = 0.37, [1.0 / v for v in n]
    js = JStencil.create(n, vel, dt, h, bc=bc)
    ts = TStencil.create(n, vel, dt, h, bc=bc)
    u = np.random.default_rng(0).normal(size=int(np.prod(n)))
    _close(ts.matvec(torch.as_tensor(u)), js.matvec(jnp.asarray(u)))


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("n,vel", GRIDS)
def test_divergence_csr_matches_jax(n, vel, periodic):
    jm, tm = _meshes(n, periodic)
    jA = j_csr(jm, 0.37, vel, dtype=jnp.float64)
    tA = t_csr(tm, 0.37, vel, **F64)
    u = np.random.default_rng(1).normal(size=jm.n_cells)
    _close(tA.matvec(torch.as_tensor(u)), jA.matvec(jnp.asarray(u)))
    _close(tA.diagonal(), jA.diagonal())
    # the stencil and the matrix are the same operator
    bc = "periodic" if periodic else "neumann"
    _close(TStencil.create(n, vel, 0.37, tm.spacing, bc=bc).matvec(torch.as_tensor(u)),
           tA.matvec(torch.as_tensor(u)).numpy())


def _models(n, vel, periodic, cfl):
    jm, tm = _meshes(n, periodic)
    return (JTransport(jm, vel, cfl=cfl, dtype=jnp.float64),
            TTransport(tm, vel, cfl=cfl, **F64))


def _trajectory(step, u0, n=5):
    u, out = u0, []
    for _ in range(n):
        u, _, *extras = step(u)
        out.append((np.asarray(u), [int(extras[0])] if extras else []))
    return out


def _same_trajectory(tr_t, tr_j, tol):
    for (ut, it_t), (uj, it_j) in zip(tr_t, tr_j):
        assert it_t == it_j
        _close(ut, uj, tol)


@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("n,vel", [((12, 10), (1.0, 0.5)), ((6, 5, 8), (1.0, 0.0, 0.0))])
def test_fft_stepper_matches_jax(n, vel, method):
    jmod, tmod = _models(n, vel, True, 1e3 / len(n))
    _same_trajectory(_trajectory(tmod.fft_stepper(method), tmod.initial_state()),
                     _trajectory(jmod.fft_stepper(method), jmod.initial_state()), 1e-10)


@pytest.mark.parametrize("operator", ["auto", "matrix"])
@pytest.mark.parametrize("periodic", [True, False])
def test_implicit_stepper_matches_jax(periodic, operator):
    jmod, tmod = _models((8, 6, 5), (1.0, 0.0, 0.0), periodic, 50.0)
    kw = dict(rtol=1e-12, atol=1e-12, operator=operator)
    _same_trajectory(_trajectory(tmod.implicit_stepper(**kw), tmod.initial_state()),
                     _trajectory(jmod.implicit_stepper(**kw), jmod.initial_state()), 1e-10)


def test_explicit_stepper_matches_jax():
    jmod, tmod = _models((16, 12), (1.0, -0.5), True, 0.5)
    _same_trajectory(_trajectory(tmod.explicit_stepper(), tmod.initial_state()),
                     _trajectory(jmod.explicit_stepper(), jmod.initial_state()), 1e-12)


def test_unported_operators_raise():
    """'window' and 'varying' are ported: on a cartesian grid both equal the
    assembled matrix's apply; an unknown operator name raises."""
    _, tmod = _models((4, 4), (1.0, 0.0), False, 1.0)
    tmod.mesh.topology_shape = tmod.mesh.structured_shape
    u = torch.as_tensor(np.random.default_rng(4).normal(size=16))
    ref = tmod.divergence_op("matrix")(u)
    for op in ("window", "varying"):
        torch.testing.assert_close(tmod.divergence_op(op)(u), ref, rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match="unknown"):
        tmod.divergence_op("ell")


def test_run_time_loop_matches_jax_and_stops_when_stationary():
    """Explicit upwind on a periodic grid smooths to the mean: the loop must
    stop at the same step on both sides with the same state."""
    jmod, tmod = _models((8,), (1.0,), True, 0.9)
    kw = dict(tmax=1e9, ntmax=5000, precision=1e-3, log=None)
    rj = j_run(jmod.explicit_stepper(), jmod.initial_state(), jmod.dt, **kw)
    rt = t_run(tmod.explicit_stepper(), tmod.initial_state(), tmod.dt, **kw)
    assert rt.stationary and rj.stationary
    assert rt.iterations == rj.iterations < 5000
    _close(rt.state, rj.state, 1e-10)


@pytest.mark.parametrize("precision", [0.0, 1e-5])
def test_run_time_loop_chunk_1_equals_chunk_4(precision):
    """Without stationarity chunk 1 and chunk 4 give the same 10 steps; with
    it the chunked loop stops at the end of the chunk where it tripped, as
    the JAX loop does."""
    jmod, tmod = _models((10, 10), (1.0, 0.0), True, 1e3 / 2)
    kw = dict(tmax=1e9, ntmax=10, precision=precision, log=None)
    r1 = t_run(tmod.fft_stepper(), tmod.initial_state(), tmod.dt, chunk=1, **kw)
    r4 = t_run(tmod.fft_stepper(), tmod.initial_state(), tmod.dt, chunk=4, **kw)
    j4 = j_run(jmod.fft_stepper(), jmod.initial_state(), jmod.dt, chunk=4, **kw)
    assert r4.iterations == j4.iterations and r4.stationary == j4.stationary
    _close(r4.state, j4.state, 1e-10)
    if precision == 0.0:
        assert r1.iterations == r4.iterations == 10 and len(r4.diagnostics) == 3
        _close(r4.state, r1.state.numpy(), 1e-12)
    else:
        assert r1.stationary and r4.stationary
        assert r4.iterations == 4 * -(-r1.iterations // 4)


def test_run_time_loop_logs_nonconvergence():
    _, tmod = _models((8, 6, 5), (1.0, 0.0, 0.0), False, 50.0)
    step = tmod.implicit_stepper(rtol=1e-14, atol=1e-14, maxiter=2)
    lines = []
    res = t_run(step, tmod.initial_state(), tmod.dt, tmax=1e9, ntmax=2, log=lines.append)
    assert res.iterations == 2
    assert sum("did NOT converge" in ln for ln in lines) == 2
    assert all(d["extras"][0] == 2 and d["extras"][2] is False for d in res.diagnostics)


def test_scan_steps_equals_loop():
    _, tmod = _models((6, 5, 8), (1.0, 0.0, 0.0), True, 1e3 / 3)
    step = tmod.fft_stepper("matmul")
    uf, dnorms = scan_steps(step, tmod.initial_state(), 3)
    tr = _trajectory(step, tmod.initial_state(), 3)
    assert dnorms.shape == (3,)
    np.testing.assert_array_equal(uf.numpy(), tr[-1][0])
