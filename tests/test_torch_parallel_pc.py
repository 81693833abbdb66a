"""The port's distributed preconditioned solves at P = 1, 2 and 4 gloo ranks
on the CPU, against the JAX package's at device_mesh(P), float64, on the
same NumPy inputs: the personalised-exchange plan of the distributed
projection PC (equal tables), its apply in both forms (within 1e-10) and
the collectives an apply issues (four all-to-alls and no all-gather with
halo=True), and the sharded GMRES over each distributed operator, with no
PC, point-block Jacobi and the circulant2l composition on Kershaw 8³ at cfl
333: the same iteration counts, solutions within rtol 1e-6."""

import warnings

import numpy as np
import pytest

import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cartesian
from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.parallel import (
    DistributedBlockCirculantPC,
    HaloELLMatrix,
    ShardedELLMatrix,
    device_mesh,
    sharded_pbjacobi,
)
from circulantpreconditioner_tpu.solvers import make_gmres
from circulantpreconditioner_tpu.solvers import preconditioners as pcs
from torch_parallel_worker import pc_checks, spawn


@pytest.fixture(scope="module", params=[1, 2, 4])
def world(request, tmp_path_factory):
    P = request.param
    return P, spawn(pc_checks, P, tmp_path_factory.mktemp(f"pc{P}"))[0]


@pytest.fixture(scope="module")
def kershaw8():
    km = j_kershaw(((0.0, 1.0),) * 3, (8, 8, 8))
    return km, JWave(km, cfl=333.0, dtype=jnp.float64)


def _close(a, b, tol):
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1.0))


def _same_solve(got, res, unshard, same_iters=True):
    x, iters, converged = got
    assert converged and bool(res.converged)
    assert iters == int(res.iters) or not same_iters
    xj = unshard(res.x)
    np.testing.assert_allclose(x, xj, rtol=1e-6, atol=1e-6 * np.abs(xj).max())


@pytest.mark.parametrize("P", [1, 2, 4])
def test_exchange_plan_equals_jax(P):
    """_build_exchange on the projection matrices of Kershaw 8³: the same
    send tables, remapped columns and halo widths as the JAX package's."""
    import torch

    from circulantpreconditioner_tpu.parallel.pc_dist import _build_exchange as j_build
    from circulantpreconditioner_tpu.parallel.pc_dist import _derive_slab_grid as j_grid
    from circulantpreconditioner_tpu.parallel.pc_dist import _pad_ell as j_pad
    from circulantpreconditioner_tpu.solvers.circulant_pc import build_projection_matrices as j_bpm
    from circulantpreconditioner_tpu_torch.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu_torch.parallel.pc_dist import (
        _build_exchange,
        _derive_slab_grid,
        _pad_ell,
    )
    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import build_projection_matrices

    km = kershaw_mesh(((0.0, 1.0),) * 3, (8, 8, 8))
    n_xyz, _, bbox = _derive_slab_grid(km, P)
    jkm = j_kershaw(((0.0, 1.0),) * 3, (8, 8, 8))
    assert n_xyz == j_grid(jkm, P)[0]
    Pm, Pb = build_projection_matrices(km, n_xyz, bbox, 3, device=torch.device("cpu"),
                                       dtype=torch.float64)
    jPm, jPb = j_bpm(jkm, n_xyz, j_grid(jkm, P)[2], 3, jnp.float64)
    ncart, n_blocks = int(np.prod(n_xyz)), km.n_cells
    for (A, jA, n_rows, n_src) in ((Pm, jPm, ncart, n_blocks), (Pb, jPb, n_blocks, ncart)):
        cols, vals = _pad_ell(A, n_rows)
        jcols, jvals = j_pad(jA, n_rows)
        assert np.array_equal(cols, jcols) and np.array_equal(vals, np.asarray(jvals))
        with warnings.catch_warnings(record=True) as w_port:
            warnings.simplefilter("always")
            got = _build_exchange(cols, n_src, P)
        with warnings.catch_warnings(record=True) as w_jax:
            warnings.simplefilter("always")
            want = j_build(jcols, n_src, P)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        # the RuntimeWarning when the padded buffer reaches the source size
        assert [str(w.message) for w in w_port] == [str(w.message) for w in w_jax]
        assert all(w.category is RuntimeWarning for w in w_port)


def test_projection_pc_matches_jax(world, kershaw8):
    """Both forms of the distributed PC apply equal JAX's (1e-10) and the
    port's single-device BlockCirculantProjectionPC on the same grid."""
    import torch

    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import BlockCirculantProjectionPC
    from torch_parallel_worker import kershaw8_wave

    P, out = world
    km, model = kershaw8
    dm = device_mesh(P)
    Ah = HaloELLMatrix(model.divergence.to_csr(jnp.float64), dm, row_multiple=4)
    r = Ah.shard_vector(np.random.default_rng(9).random(model.divergence.shape[0]))
    for halo, key in ((True, "pc_halo"), (False, "pc_gather")):
        pc = DistributedBlockCirculantPC(km, model.dt, model.c0, dm, Ah.n_padded,
                                         dtype=jnp.float64, precision="highest", halo=halo)
        z = Ah.unshard_vector(pc.apply(r))
        _close(out[key], z, 1e-10)
        assert out["pc_grid"] == pc.n_xyz == (8, 8, 8)
        if halo:
            assert out["pc_halo_widths"] == (pc.halo_fwd, pc.halo_bak)
    tkm, tmodel = kershaw8_wave()
    local = BlockCirculantProjectionPC(tkm, tmodel.dt, tmodel.c0, device=torch.device("cpu"),
                                       dtype=torch.float64)
    rr = np.random.default_rng(9).random(model.divergence.shape[0])
    _close(out["pc_halo"], local(torch.as_tensor(rr)).numpy(), 1e-10)


def test_projection_pc_collectives_per_apply(world):
    """The counterpart of JAX's compiled-HLO lock: with halo=True one apply
    is four all-to-alls (two personalised exchanges and the solver's
    transpose pair) and no all-gather; with halo=False two all-gathers and
    the transpose pair."""
    P, out = world
    assert out["pc_halo_collectives"] == {"all_to_all_single": 4}
    assert out["pc_gather_collectives"] == {"all_gather": 2, "all_to_all_single": 2}


def test_sharded_gmres_no_pc_matches_jax(world):
    """The halo SpMV's GMRES of the JAX package's test_distributed.py
    ((6, 16), cfl 200): at its rtol 1e-10 the solve takes 144 iterations, a
    count that perturbations of b by 1e-15 move in one process (the test
    below), so there the solutions are compared, as JAX's test does, and
    the counts at rtol 1e-8 (113, unmoved by such perturbations)."""
    P, out = world
    dm = device_mesh(P)
    w = JWave(j_cartesian(((-0.5, 0.5),) * 2, (6, 16)), cfl=200.0, dtype=jnp.float64)
    A = HaloELLMatrix(w.divergence.to_csr(jnp.float64), dm)
    b = A.shard_vector(np.asarray(w.initial_state()))
    for tol in (1e-10, 1e-8):
        res = make_gmres(lambda x: x + A.matvec(x), rtol=tol, atol=tol * 1e-2,
                         maxiter=500)(b, b)
        _same_solve(out[f"gmres_halo_{tol:g}"], res, A.unshard_vector, same_iters=tol > 1e-10)

    w = JWave(j_cartesian(((-0.5, 0.5),) * 2, (8, 8)), cfl=1e3 / 2, dtype=jnp.float64)
    A = ShardedELLMatrix(w.divergence.to_csr(jnp.float64), dm)
    b = A.shard_vector(np.asarray(w.initial_state()))
    res = make_gmres(lambda x: x + A.matvec(x), rtol=1e-10, atol=1e-12, maxiter=500)(b, b)
    _same_solve(out["gmres_allgather"], res, A.unshard_vector)


@pytest.mark.parametrize("rtol,moves", [(1e-10, True), (1e-8, False)])
def test_halo_gmres_count_moves_under_roundoff_at_rtol_1e10(rtol, moves):
    """Why test_sharded_gmres_no_pc_matches_jax compares counts at rtol 1e-8
    only: on one device, perturbing b by 1e-15 relative moves the count of
    the (6, 16), cfl 200 solve at rtol 1e-10 (144 unperturbed), not at 1e-8."""
    import torch

    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.solvers import make_gmres as t_gmres

    w = WaveSystem(cartesian_mesh(((-0.5, 0.5),) * 2, (6, 16)), cfl=200.0,
                   device=torch.device("cpu"), dtype=torch.float64)
    D, b = w.divergence, w.initial_state()
    solve = t_gmres(lambda v: v + D.matvec(v), rtol=rtol, atol=rtol * 1e-2, maxiter=500)
    rng = np.random.default_rng(0)
    its = [solve(bb, bb).iters for bb in
           [b] + [b * (1 + 1e-15 * torch.as_tensor(rng.standard_normal(b.shape[0])))
                  for _ in range(3)]]
    assert (len(set(its)) > 1) == moves, its


def test_sharded_gmres_slab_stencil_matches_jax(world):
    from circulantpreconditioner_tpu.ops.stencil import VaryingStencilOperator
    from circulantpreconditioner_tpu.parallel import SlabStencilOperator

    P, out = world
    k = j_kershaw(((0.0, 1.0),) * 3, (4, 4, 8))
    w = JWave(k, cfl=50.0, dtype=jnp.float64)
    S = SlabStencilOperator(VaryingStencilOperator.from_bsr(w.divergence, k.topology_shape),
                            device_mesh(P))
    g4 = (8, 4, 4, 4)

    def A(v):
        v4 = v.reshape(g4)
        return (v4 + S.matvec(v4)).reshape(-1)

    b = S.shard_vector(np.asarray(w.initial_state())).reshape(-1)
    res = make_gmres(A, rtol=1e-8, atol=1e-10, maxiter=500)(b, b)
    _same_solve(out["gmres_slab"], res, lambda x: np.asarray(x))


def test_sharded_gmres_pbjacobi_matches_jax(world):
    P, out = world
    dm = device_mesh(P)
    w = JWave(j_cartesian(((-0.5, 0.5),) * 2, (8, 16)), cfl=100.0, dtype=jnp.float64)
    D = w.divergence
    b = D.block_size
    A = HaloELLMatrix(D.to_csr(jnp.float64), dm, row_multiple=b)
    Dinv = np.linalg.inv(np.asarray(D.block_diagonal()) + np.eye(b)[None, :, :])
    M = sharded_pbjacobi(Dinv, A.n_padded, dm, dtype=jnp.float64)
    bb = A.shard_vector(np.asarray(w.initial_state()))
    res = make_gmres(lambda x: x + A.matvec(x), M, rtol=1e-8, atol=1e-10, maxiter=500)(bb, bb)
    _same_solve(out["gmres_pbjacobi"], res, A.unshard_vector)


def test_sharded_gmres_circulant2l_matches_jax(world, kershaw8):
    """The flagship composition: distributed GMRES with the additive
    two-level (projection PC + pbjacobi) right preconditioner, Kershaw 8³ at
    cfl 333: JAX's iterations and solution at the same P."""
    P, out = world
    km, model = kershaw8
    dm = device_mesh(P)
    D = model.divergence
    Ah = HaloELLMatrix(D.to_csr(jnp.float64), dm, row_multiple=4)
    coarse = DistributedBlockCirculantPC(km, model.dt, model.c0, dm, Ah.n_padded,
                                         dtype=jnp.float64, precision="highest")
    Dinv = np.linalg.inv(np.asarray(D.block_diagonal()) + np.eye(4)[None, :, :])
    M = pcs.additive(coarse.apply, sharded_pbjacobi(Dinv, Ah.n_padded, dm, dtype=jnp.float64))
    bb = Ah.shard_vector(np.asarray(model.initial_state()))
    res = make_gmres(lambda x: x + Ah.matvec(x), M, rtol=1e-8, atol=1e-10, maxiter=500,
                     side="right")(bb, bb)
    _same_solve(out["gmres_circulant2l"], res, Ah.unshard_vector)


def test_sharded_right_gmres_checks_the_true_residual(world):
    """GMRES's true-residual check on row-sharded vectors: the transport
    problem of test_torch_true_residual.py, its preconditioner Jacobi plus a
    term ‖r‖·e that makes the estimate lie, takes at every P the one-device
    solve's iterations and forced cycles, and ends with ‖b − A x‖ < tol."""
    import torch

    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh as t_cartesian
    from circulantpreconditioner_tpu_torch.models import TransportEquation
    from circulantpreconditioner_tpu_torch.solvers import make_gmres as t_gmres
    from circulantpreconditioner_tpu_torch.utils.graphs import STATS

    P, out = world
    x, iters, converged, forced, resnorm, true, bnorm = out["gmres_true_residual"]
    t = TransportEquation(t_cartesian(((-0.5, 0.5),) * 3, (8, 6, 5), periodic=False),
                          (1.0, 0.5, 0.25), cfl=20.0, device=torch.device("cpu"),
                          dtype=torch.float64)
    dinv = 1.0 / (t.divergence.diagonal() + 1.0)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=t.mesh.n_cells) + 600.0)
    e = torch.as_tensor(np.random.default_rng(5).random(t.mesh.n_cells))
    e = e * (1e-3 / torch.linalg.norm(e))
    STATS.reset()
    ref = t_gmres(t.implicit_matvec(), lambda r: dinv * r + torch.linalg.norm(r) * e,
                  rtol=1e-8, atol=0.0, maxiter=500, side="right", true_residual=True)(b)
    assert converged and true < 1e-8 * bnorm
    assert resnorm == pytest.approx(true, rel=1e-6)
    assert (iters, forced) == (ref.iters, STATS.true_restarts) and forced >= 1
    np.testing.assert_allclose(x, ref.x.numpy(), rtol=0, atol=1e-6 * np.abs(x).max())
