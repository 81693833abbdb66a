"""The port's grid V-cycle on a z-slab-sharded state
(circulantpreconditioner_tpu_torch/parallel/vcycle_dist.py) at P = 1, 2 and
4 gloo ranks on the CPU, float64, against the port's one-device
GridVCyclePC and the JAX package's GridVCyclePC applied to a vector sharded
as NamedSharding(device_mesh(P), PS("shard")) (GSPMD, tests/conftest.py's
virtual devices), on the same NumPy inputs.

Cases (bottom_max 8, cfl 100): Kershaw 8³, which gathers at the bottom 2³
for P = 1 and 2 and at the 4³ level (one plane per rank) for P = 4; Kershaw
12³, whose slabs turn odd at the 3³ level for P = 1, at the 6³ level (three
planes) for P = 2, and at the fine level (three planes) for P = 4. The
applies agree within 1e-12 × max|z|; an apply issues two ring exchanges
(all_to_all_single) per sharded level and one all-gather. JAX's stage (e)
case (__graft_entry__.py: Kershaw 8³, cfl 100, bottom_max 8, GMRES right
with rtol 1e-4) takes the same iterations sharded in the port, sharded in
JAX and on one device, the states within 1e-10. nz % P ≠ 0 raises."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as PS

from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.parallel import device_mesh
from circulantpreconditioner_tpu.solvers import make_gmres as j_make_gmres
from circulantpreconditioner_tpu.solvers.aggregation_pc import GridVCyclePC as JGrid
from torch_parallel_worker import spawn, vcycle_checks

CASES = ((8, 8, 100.0), (12, 8, 100.0))
GMRES_CASE = (8, 8, 100.0, 1e-4)  # __graft_entry__.py stage (e)


@pytest.fixture(scope="module", params=[1, 2, 4])
def world(request, tmp_path_factory):
    P = request.param
    return P, spawn(vcycle_checks, P, tmp_path_factory.mktemp(f"vcycle{P}"), CASES,
                    GMRES_CASE)


def _jax_pc(n, bottom_max, cfl):
    km = j_kershaw(((0.0, 1.0),) * 3, (n, n, n))
    model = JWave(km, cfl=cfl, dtype=jnp.float64)
    pc = JGrid.from_grid_model(model.divergence, km.topology_shape, cells_per_site=1,
                               A0_apply=model.implicit_matvec(), shift=1.0,
                               bottom_max=bottom_max, dtype=jnp.float64)
    return model, pc


def _sharded(x, P):
    return jax.device_put(np.asarray(x), NamedSharding(device_mesh(P), PS("shard")))


def _cm(z_fm):
    """Field-major flat (4·N,) → cell-major flat."""
    return np.asarray(z_fm).reshape(4, -1).T.reshape(-1)


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"kershaw{c[0]}")
def test_sharded_apply_equals_one_device_and_gspmd(world, case):
    P, ranks = world
    n, bottom_max, cfl = case
    got = ranks[0][("apply", n)]
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[("apply", n)]["z"], got["z"])
    _close(got["z"], got["z_1dev"], 1e-12)
    model, pc = _jax_pc(n, bottom_max, cfl)
    r_cm = np.random.default_rng(n).random(model.divergence.shape[0])
    zj = np.asarray(jax.jit(pc.apply)(_sharded(r_cm, P)))
    _close(_cm(got["z"]), zj, 1e-12)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"kershaw{c[0]}")
def test_collectives_per_apply(world, case):
    """Two ring exchanges per sharded level and one all-gather; which levels
    are sharded follows the planes per rank."""
    P, ranks = world
    n = case[0]
    got = ranks[0][("apply", n)]
    k = got["sharded_levels"]
    assert got["collectives"] == ({"all_to_all_single": 2 * k, "all_gather": 1} if k
                                  else {"all_gather": 1}), got["describe"]
    want = {(8, 1): 2, (8, 2): 2, (8, 4): 1, (12, 1): 2, (12, 2): 1, (12, 4): 0}[(n, P)]
    assert k == want and got["gather_level"] == k, got["describe"]
    assert got["levels"] == (2 if n == 8 else 3)


def test_stage_e_gmres_iterations(world):
    """JAX's stage (e): the same GMRES iterations sharded in the port,
    sharded in JAX and on one device."""
    P, ranks = world
    n, bottom_max, cfl, rtol = GMRES_CASE
    got = ranks[0]["gmres"]
    model, pc = _jax_pc(n, bottom_max, cfl)
    solver = j_make_gmres(model.implicit_matvec(), pc.apply_partial(), rtol=rtol, atol=rtol,
                          maxiter=100, side="right", layout="flat")
    u0 = np.asarray(model.initial_state())
    res_s = solver(_sharded(u0, P), _sharded(u0, P))
    res_1 = solver(jnp.asarray(u0), jnp.asarray(u0))
    assert got["converged"] and bool(res_s.converged)
    assert got["iters"] == int(res_s.iters) == int(res_1.iters) == got["iters_1dev"]
    _close(_cm(got["x"]), np.asarray(res_s.x), 1e-10)
    _close(got["x"], got["x_1dev"], 1e-10)


def test_indivisible_slab_raises(world):
    P, ranks = world
    if P == 1:
        assert ranks[0]["indivisible"] is None
    else:
        assert f"must divide over {P} devices" in ranks[0]["indivisible"]
