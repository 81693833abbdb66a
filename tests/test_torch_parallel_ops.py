"""The port's distributed operators (circulantpreconditioner_tpu_torch/
parallel/) at P = 1, 2 and 4 gloo ranks on the CPU, against the JAX
package's at device_mesh(P) on as many virtual devices, float64, on the same
NumPy inputs: the padded-ELL form; the all-gather, halo and window SpMVs and
the slab stencil (matvecs within 1e-12); point-block Jacobi; the slab and
pencil circulant solves, the distributed FFT and the all-matmul slab block
solve (within 1e-10 of JAX's and of the port's single-device solves); and
the collectives one apply issues. Each world runs every check of one P in
one spawn (tests/torch_parallel_worker.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cartesian
from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.models import TransportEquation as JTransport
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.parallel import device_mesh, device_mesh_2d
from torch_parallel_worker import PENCIL, banded_bsr_coo, ops_checks, spawn, spawn_multihost

TOL = 1e-12


@pytest.fixture(scope="module", params=[1, 2, 4])
def world(request, tmp_path_factory):
    """(P, rank 0's results, every rank's results) of one world of P ranks."""
    P = request.param
    results = spawn(ops_checks, P, tmp_path_factory.mktemp(f"ops{P}"))
    return P, results[0], results


def _close(a, b, tol):
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1.0))


def test_ell_matrix_equals_jax():
    """CSRMatrix.to_ell: the same (cols, vals) tables as the JAX package's."""
    import torch

    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    m = cartesian_mesh(((-0.5, 0.5),) * 2, (9, 7))
    A = WaveSystem(m, cfl=100.0, device=torch.device("cpu"),
                   dtype=torch.float64).divergence.to_csr(torch.float64)
    ell = A.to_ell()
    jA = JWave(j_cartesian(((-0.5, 0.5),) * 2, (9, 7)), cfl=100.0,
               dtype=jnp.float64).divergence.to_csr(jnp.float64)
    jell = jA.to_ell()
    assert np.array_equal(ell.cols.numpy(), np.asarray(jell.cols))
    assert np.array_equal(ell.vals.numpy(), np.asarray(jell.vals))
    assert ell.shape == tuple(jell.shape)
    x = np.random.default_rng(0).random(A.shape[1])
    _close(ell.matvec(torch.as_tensor(x)).numpy(), jell.matvec(jnp.asarray(x)), TOL)


def test_row_sharded_spmvs_match_jax(world):
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix, ShardedELLMatrix

    P, out, _ = world
    dm = device_mesh(P)
    A = JWave(j_cartesian(((-0.5, 0.5),) * 2, (9, 7)), cfl=100.0,
              dtype=jnp.float64).divergence.to_csr(jnp.float64)
    As = ShardedELLMatrix(A, dm)
    x = np.random.default_rng(2).random(A.shape[1])
    y = As.unshard_vector(As.matvec(As.shard_vector(x)))
    _close(out["sharded_ell"], y, TOL)
    _close(out["sharded_ell_local"], y, TOL)

    A = JWave(j_cartesian(((-0.5, 0.5),) * 3, (4, 4, 16)), cfl=100.0,
              dtype=jnp.float64).divergence.to_csr(jnp.float64)
    Ah = HaloELLMatrix(A, dm)
    x = np.random.default_rng(5).random(A.shape[1])
    y = Ah.unshard_vector(Ah.matvec(Ah.shard_vector(x)))
    _close(out["halo_ell"], y, TOL)
    _close(out["halo_ell_local"], y, TOL)
    assert out["halo_ell_w"] == Ah.halo


def test_halo_spmv_rejects_wide_band_as_jax_does(world):
    """The periodic wrap's band is rejected exactly where JAX rejects it."""
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix

    P, out, _ = world
    t = JTransport(j_cartesian(((-0.5, 0.5),), (64,), periodic=True), velocity=[1.0],
                   cfl=10.0, dtype=jnp.float64)
    try:
        HaloELLMatrix(t.divergence, device_mesh(P))
        expected = None
    except ValueError as e:
        expected = str(e)
    assert out["wide_band"] == expected
    assert (expected is not None) == (P == 4)  # B = 16 < 63/2 only at 4 ranks


def test_halo_spmvs_issue_no_all_gather(world):
    """The counterpart of JAX's compiled-HLO lock: one halo apply is one
    all-to-all (the ring exchange) and no all-gather; the all-gather SpMV
    issues one all-gather."""
    P, out, _ = world
    for key in ("halo_ell_collectives", "slab_collectives", "window_collectives"):
        assert out[key] == {"all_to_all_single": 1}, (key, out[key])
    assert out["sharded_ell_collectives"] == {"all_gather": 1}
    assert out["slab_solve_collectives"] == {"all_to_all_single": 2}
    assert out["slab_block_collectives"] == {"all_to_all_single": 2}


def test_slab_stencil_matches_jax(world):
    from circulantpreconditioner_tpu.ops.stencil import VaryingStencilOperator
    from circulantpreconditioner_tpu.parallel import SlabStencilOperator

    P, out, _ = world
    dm = device_mesh(P)
    rng = np.random.default_rng(0)
    km = j_kershaw(((0.0, 1.0),) * 3, (4, 3, 8))
    V = VaryingStencilOperator.from_bsr(JWave(km, cfl=10.0, dtype=jnp.float64).divergence,
                                        km.topology_shape)
    S = SlabStencilOperator(V, dm)
    x = rng.random(km.n_cells * 4)
    assert out["slab_flat_layout"] == V.layout == "flat"
    y = S.unshard_vector(S.matvec(S.shard_vector(x)))
    _close(out["slab_flat"], y, TOL)
    _close(out["slab_flat_local"], y, TOL)

    km2 = j_kershaw(((0.0, 1.0),) * 3, (4, 4, 8))
    km2.set_periodic()
    t2 = JTransport(km2, velocity=[1.0, 0.5, -0.2], cfl=3.0, dtype=jnp.float64)
    V2 = VaryingStencilOperator.from_csr(t2.divergence, km2.topology_shape)
    S2 = SlabStencilOperator(V2, dm)
    x2 = rng.random(km2.n_cells)
    assert out["slab_grid_last_layout"] == V2.layout == "grid_last"
    y2 = S2.unshard_vector(S2.matvec(S2.shard_vector(x2)))
    _close(out["slab_grid_last"], y2, TOL)
    _close(out["slab_grid_last_local"], y2, TOL)


def test_halo_window_matches_jax(world):
    from circulantpreconditioner_tpu.ops.csr import BSRMatrix
    from circulantpreconditioner_tpu.ops.window_spmv import WindowedBlockOperator
    from circulantpreconditioner_tpu.parallel import HaloWindowOperator

    P, out, _ = world
    rows, cols, blocks = banded_bsr_coo()
    A = BSRMatrix.from_block_coo(203, 203, rows, cols, blocks, dtype=jnp.float64)
    H = HaloWindowOperator(WindowedBlockOperator.from_bsr(A, G=8, unit=2), device_mesh(P))
    x = np.random.default_rng(12).standard_normal(203 * 4)
    y = H.unshard_vector(H.matvec(H.shard_vector(x)))
    _close(out["window"], y, TOL)
    _close(out["window_local"], A.matvec(jnp.asarray(x)), TOL)
    assert out["window_halo_units"] == H.halo_units
    assert (H.halo_units > 0) == (P > 1)  # the band crosses rank boundaries


def test_sharded_pbjacobi_matches_jax(world):
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix
    from circulantpreconditioner_tpu.parallel.pc_dist import sharded_pbjacobi

    P, out, _ = world
    dm = device_mesh(P)
    D = JWave(j_cartesian(((-0.5, 0.5),) * 2, (6, 16)), cfl=200.0,
              dtype=jnp.float64).divergence
    b = D.block_size
    Ah = HaloELLMatrix(D.to_csr(jnp.float64), dm, row_multiple=b)
    Dinv = np.linalg.inv(np.asarray(D.block_diagonal()) + np.eye(b)[None, :, :])
    M = sharded_pbjacobi(Dinv, Ah.n_padded, dm, dtype=jnp.float64)
    r = np.random.default_rng(8).random(D.shape[0])
    _close(out["pbjacobi"], Ah.unshard_vector(M(Ah.shard_vector(r))), TOL)


def test_slab_and_pencil_solves_match_jax(world):
    from circulantpreconditioner_tpu.ops.circulant import CirculantTransportOperator
    from circulantpreconditioner_tpu.parallel import PencilCirculantSolver, SlabCirculantSolver

    P, out, _ = world
    op = CirculantTransportOperator.create((16, 8, 12), (0.3, 0.8, 2.0), jnp.float64)
    slab = SlabCirculantSolver.from_operator(op, device_mesh(P))
    bb = np.random.default_rng(1).random((16, 8, 12))
    x = np.asarray(slab.solve(slab.shard(bb)))
    _close(out["slab_solve"], x, 1e-10)
    _close(out["slab_solve_local"], x, 1e-10)

    mesh2 = device_mesh_2d(PENCIL[P])
    rng = np.random.default_rng(3)
    for shape in ((8, 8, 6), (8, 8, 7)):
        op = CirculantTransportOperator.create(shape, (0.4, -0.3, 5.0), jnp.float64)
        pen = PencilCirculantSolver.from_operator(op, mesh2)
        bb = rng.random(shape)
        x = np.asarray(pen.solve(pen.shard(jnp.asarray(bb))))
        key = "pencil_" + "x".join(map(str, shape))
        _close(out[key], x, 1e-10)
        _close(out[key + "_local"], x, 1e-10)
        assert out[key + "_residual"] < 1e-10


def test_distributed_fft3_matches_jax(world):
    from circulantpreconditioner_tpu.parallel.fft_dist import make_distributed_fft3

    P, out, _ = world
    rng = np.random.default_rng(0)
    v = rng.random((8, 8, 4)) + 1j * rng.random((8, 8, 4))
    got = np.asarray(make_distributed_fft3(device_mesh(P))(jnp.asarray(v)))
    _close(out["fft3"], got, 1e-10)
    _close(out["fft3"], np.fft.fftn(v), 1e-10)
    _close(out["fft3_back"], v, 1e-10)


def test_slab_block_circulant_solver_matches_jax(world):
    from circulantpreconditioner_tpu.ops.assembly import wave_block_stencil
    from circulantpreconditioner_tpu.ops.circulant import BlockCirculantOperator
    from circulantpreconditioner_tpu.parallel.pc_dist import SlabBlockCirculantSolver

    P, out, _ = world
    offsets, blocks = wave_block_stencil(3, 0.01, 700.0, (1 / 6, 1 / 8, 1 / 8))
    slab = SlabBlockCirculantSolver.from_stencil((8, 8, 6), offsets, blocks, device_mesh(P),
                                                 dtype=jnp.float64, precision="highest")
    b = np.random.default_rng(7).random(8 * 8 * 6 * 4)
    x = np.asarray(slab.solve(slab.shard(b))).reshape(-1)
    _close(out["slab_block"], x, 1e-10)
    ref = BlockCirculantOperator.from_stencil((8, 8, 6), offsets, blocks, jnp.float64)
    _close(out["slab_block"], ref.solve(jnp.asarray(b)), 1e-10)


def test_every_rank_gathers_the_same_and_host0_alone_holds_it(world):
    P, out, results = world
    for r in results[1:]:
        for key in ("halo_ell", "slab_flat", "window", "slab_solve", "pencil_8x8x7"):
            assert np.array_equal(r[key], out[key])
        assert r["gather_to_host0"] is None
    assert np.array_equal(out["gather_to_host0"],
                          np.repeat(np.arange(P, dtype=np.float32), 2)[:, None]
                          * np.ones((1, 3)))


def test_meshes_need_the_whole_world():
    """Asking for more ranks than the world has raises, as JAX's
    device_mesh does; so does asking for fewer (a mesh spans the world)."""
    import torch.distributed as dist

    from circulantpreconditioner_tpu_torch.parallel import device_mesh as t_mesh
    from circulantpreconditioner_tpu_torch.parallel import device_mesh_2d as t_mesh_2d

    with pytest.raises(ValueError, match="requested 9 devices"):
        device_mesh(9)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="requested 2 devices, have 1"):
            t_mesh(2)
        with pytest.raises(ValueError, match="requested 4 devices, have 1"):
            t_mesh_2d((2, 2))
        assert t_mesh().shape == {"shard": 1} and t_mesh_2d((1, 1)).shape == {"z": 1, "y": 1}
    finally:
        dist.destroy_process_group()
    assert len(jax.devices()) >= 4


def test_init_multihost_joins_a_world_and_gathers_to_host0(tmp_path):
    """Two ranks join through init_multihost (MPI_Init analog, gloo on the
    CPU) at a localhost port; global_device_mesh spans both, and
    gather_to_host0 hands rank 0 alone the whole array."""
    results = spawn_multihost(2, tmp_path)
    assert [r[:2] for r in results] == [({"shard": 2}, {"shard": 0}), ({"shard": 2}, {"shard": 1})]
    assert np.array_equal(results[0][2], np.array([0.0, 0.0, 1.0, 1.0], np.float32))
    assert results[1][2] is None
