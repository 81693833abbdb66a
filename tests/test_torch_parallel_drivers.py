"""The port's sharded drivers at P = 1, 2 and 4 gloo ranks on the CPU, each
rank running `main(argv + ["--device", "cpu"])`, against the JAX drivers'
`--shard` runs at `--devices P` on as many virtual devices, float64: the
gathered final state (1e-10 × max|U| for the direct and explicit drivers,
rtol 1e-6 for GMRES at its rtol 1e-5) and the GMRES iterations of every
step. transport_fft --shard slab (with a checkpoint, written by rank 0) and
--shard pencil; wave_explicit --shard slab (with --vtk, written by rank 0
alone), --shard rows and --shard slab --chunk 3 (its 3 steps one chunk, the
global norms inside the chunk); wave_implicit --shard rows with --pc none,
pbjacobi and circulant2l, and its window route on a welded, RCM-ordered
Kershaw-tet Gmsh file (4³, 384 tets: the smallest sizes take it too, from
2³, and at 4³ each of 4 ranks owns 12 clusters and a 16-unit halo)."""

import importlib

import numpy as np
import pytest

from torch_parallel_worker import PENCIL, driver_runs, spawn

KERSHAW = ["--mesh-family", "kershaw", "4", "4", "8"]
IMPLICIT_PCS = (["--pc", "none", "--cfl", "10"], ["--pc", "pbjacobi"], ["--pc", "circulant2l"])


def _runs(P, tmp, tet_file):
    common = ["--tmax", "1e9", "--ntmax", "3", "--f64", "--devices", str(P)]
    pq = [str(v) for v in PENCIL[P]]
    return [
        ("transport_fft", ["8", "8", "8", "--shard", "slab", "--checkpoint-freq", "3"] + common),
        ("transport_fft", ["8", "8", "8", "--shard", "pencil", "--pq", *pq] + common),
        ("wave_explicit", KERSHAW + ["--shard", "slab", "--vtk", "--result-dir", f"{tmp}/vtk"]
         + common),
        ("wave_explicit", KERSHAW + ["--shard", "rows"] + common),
    ] + [("wave_implicit", KERSHAW + ["--shard", "rows"] + pc + common) for pc in IMPLICIT_PCS] + [
        ("wave_implicit", [tet_file, "--shard", "rows", "--pc", "circulant2l"] + common),
        ("wave_explicit", KERSHAW + ["--shard", "slab", "--chunk", "3"] + common)]


@pytest.fixture(scope="module", params=[1, 2, 4])
def world(request, tmp_path_factory):
    """(P, the runs, the port's results on rank 0, the JAX drivers' results)."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_tet_mesh
    from test_torch_mesh_readers import write_gmsh

    P = request.param
    tmp = tmp_path_factory.mktemp(f"drivers{P}")
    mt = kershaw_tet_mesh(((-0.5, 0.5),) * 3, (4, 4, 4))
    cells = np.asarray(mt.cell_vertices)  # each tet its own 4 vertices: read_mesh welds
    tet_file = write_gmsh(tmp / "kershawtet4.msh", mt.points[cells.reshape(-1)],
                          np.arange(cells.size).reshape(cells.shape))
    runs = _runs(P, tmp, tet_file)
    port = spawn(driver_runs, P, tmp, [(n, a + ["--result-dir", str(tmp / "port")]
                                        if "--result-dir" not in a else a) for n, a in runs])[0]
    jax_res = []
    for name, argv in runs:
        argv = [a for a in argv if a != "--vtk"] + ["--result-dir", str(tmp / "jax")]
        jax_res.append(importlib.import_module(
            f"circulantpreconditioner_tpu.drivers.{name}").main(argv))
    return P, tmp, runs, port, jax_res


def _its(res):
    return [d["extras"][0] for d in res.diagnostics if d["extras"]]


def _check(world, which, tol):
    P, tmp, runs, port, jax_res = world
    for k in which:
        state, its, steps, _ = port[k]
        rj = jax_res[k]
        uj = np.asarray(rj.state).reshape(-1)
        assert steps == rj.iterations == 3, runs[k]
        assert its == _its(rj), runs[k]
        np.testing.assert_allclose(state, uj, rtol=tol, atol=tol * np.abs(uj).max(),
                                   err_msg=str(runs[k]))


def test_transport_fft_shard_slab_and_pencil_match_jax(world):
    from circulantpreconditioner_tpu_torch.io import load_checkpoint

    _check(world, (0, 1), 1e-10)
    state, t, it, _ = load_checkpoint(str(world[1] / "port" / "cartesian_8x8x8_ckpt.npz"))
    assert it == 3 and np.array_equal(state.reshape(-1), world[3][0][0])  # rank 0's gather
    assert f"-- sharded over {{'z': {PENCIL[world[0]][0]}, 'y': {PENCIL[world[0]][1]}}}" \
        in world[3][1][3]


def test_wave_explicit_shard_slab_and_rows_match_jax(world):
    P, tmp = world[:2]
    _check(world, (2, 3), 1e-10)
    assert "z-slab sharded" in world[3][2][3] and "halo exchange" in world[3][3][3]
    files = sorted((tmp / "vtk").glob("*.vtk"))
    assert len(files) == 3  # one per step, from rank 0 alone
    pressure = world[3][2][0].reshape(-1, 4)[:, 0]
    text = files[-1].read_text()
    got = np.array(text.split("SCALARS pressure double 1\nLOOKUP_TABLE default\n")[1]
                   .split()[:len(pressure)], dtype=np.float64)
    np.testing.assert_array_equal(got, pressure)


@pytest.mark.parametrize("k", range(len(IMPLICIT_PCS)), ids=["none", "pbjacobi", "circulant2l"])
def test_wave_implicit_shard_rows_matches_jax(world, k):
    _check(world, (4 + k,), 1e-6)
    assert all(world[4][r].iterations == 3 for r in (4 + k,))


def test_wave_implicit_window_route_matches_jax(world):
    """The RCM-ordered tet file takes the halo window SpMV at every P."""
    _check(world, (7,), 1e-6)
    assert "halo windowed" in world[3][7][3]


def test_wave_explicit_shard_slab_chunked_matches_jax(world):
    """--chunk 3: the 3 steps as one chunk (one graph on the card), the
    ranks' dnorms reduced once, as the JAX driver's jit(lax.scan)."""
    _check(world, (8,), 1e-10)
    assert "(3-step device chunk)" in world[3][8][3]
