"""The distributed rows of the port's bench_suite.py (`scale_distributed`,
`scale_distributed48`) on the CPU: their torchrun command line, their names
against the JAX suite's records (results/bench_suite_r05.json), the row's
case (`dist_case`: everything a rank does but its timing) at Kershaw 8³ on
2 gloo ranks in float64 against the calls of the JAX suite's `_scale_worker`
at device_mesh(2) on the same NumPy inputs (iterations equal, states within
1e-10 × max|x_JAX|), the record's keys, and `dist_worker` with stand-ins for
the case and the timer (fake counts, a fake clock): a gate miss exits 1.

circulant2l at cfl 1e3/3 moves by more than 1e-10 in the JAX package itself
when b changes by 1e-15 relative (tests/test_torch_bench.py
`_close_krylov`): there its state is held to ten times that movement."""

import json
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as PS

from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.parallel import HaloELLMatrix, device_mesh
from circulantpreconditioner_tpu.parallel.pc_dist import (
    DistributedBlockCirculantPC,
    sharded_pbjacobi,
)
from circulantpreconditioner_tpu.solvers import make_gmres
from circulantpreconditioner_tpu.solvers import preconditioners as pcs
from circulantpreconditioner_tpu.solvers.aggregation_pc import GridVCyclePC
from circulantpreconditioner_tpu_torch import bench_suite as ts
from torch_parallel_worker import bench_dist_checks, spawn

ROOT = pathlib.Path(__file__).resolve().parents[1]
R05 = {r["metric"]: r for r in
       json.loads((ROOT / "results" / "bench_suite_r05.json").read_text())["results"]}
N, P = 8, 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(bench_dist_checks, P, tmp_path_factory.mktemp("bench_dist"), N)


@pytest.fixture(scope="module")
def jax_row():
    """`_scale_worker`'s calls (bench_suite.py) at device_mesh(2), float64."""
    mesh = j_kershaw(((0.0, 1.0),) * 3, (N,) * 3)
    model = JWave(mesh, cfl=1e3 / 3, dtype=jnp.float64)
    dm = device_mesh(P)
    D = model.divergence
    b = D.block_size
    Ah = HaloELLMatrix(D.to_csr(jnp.float64), dm, row_multiple=b)
    coarse = DistributedBlockCirculantPC(mesh, model.dt, model.c0, dm, Ah.n_padded,
                                         dtype=jnp.float64)
    Dinv = np.linalg.inv(np.asarray(D.block_diagonal()) + np.eye(b)[None, :, :])
    M = pcs.additive(coarse.apply, sharded_pbjacobi(Dinv, Ah.n_padded, dm, dtype=jnp.float64))
    Aop = jax.tree_util.Partial(lambda spmv, x: x + spmv(x), Ah.matvec_partial())
    solver = make_gmres(Aop, M, rtol=1e-5, atol=1e-5, maxiter=1000, side="right")
    U0 = Ah.shard_vector(np.asarray(model.initial_state()))
    res = solver(U0, U0)

    def circ(b):
        Ub = Ah.shard_vector(b)
        return np.asarray(Ah.unshard_vector(solver(Ub, Ub).x))

    gpc = GridVCyclePC.from_grid_model(D, mesh.topology_shape, cells_per_site=1,
                                       A0_apply=model.implicit_matvec(), shift=1.0,
                                       dtype=jnp.float64)
    solver_g = make_gmres(model.implicit_matvec(), gpc.apply_partial(), rtol=1e-5, atol=1e-5,
                          maxiter=1000, side="right", layout="flat")
    Ug = jax.device_put(np.asarray(model.initial_state()), NamedSharding(dm, PS("shard")))
    res_g = solver_g(Ug, Ug)
    return {"circ": (np.asarray(Ah.unshard_vector(res.x)), int(res.iters), bool(res.converged)),
            "circ_solve": circ, "u0": np.asarray(model.initial_state()),
            "grid": (np.asarray(res_g.x), int(res_g.iters), bool(res_g.converged)),
            "halos": (int(coarse.halo_fwd), int(coarse.halo_bak), int(Ah.halo))}


def test_torchrun_command():
    assert ts.dist_command(32, 4) == [
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
        "-m", "circulantpreconditioner_tpu_torch.bench_suite", "--dist-worker", "32"]


def test_rows_are_the_jax_distributed_rows():
    """Each row's records take the JAX record's name with the port's rank count
    in place of the 8 virtual devices; the gates are the JAX records' counts."""
    assert set(ts.DIST_ROWS) == {"scale_distributed", "scale_distributed48"}
    for n, row in zip((32, 48), ts.DIST_ROWS.values()):
        r05 = R05[f"{row.metric}_8dev"]
        assert row.per_ranks and row.unit == r05["unit"]
        assert ts.R05_DIST_ITERS[n] == r05["gmres_iters"] and r05["converged"]
    assert R05["wave_implicit_dist_kershaw32_8dev"]["gridmg_gspmd_iters"] == 33


@pytest.mark.parametrize("solve", ["circ", "grid"])
def test_dist_case_equals_jax_scale_worker(ranks, jax_row, solve):
    x, iters, converged = ranks[0][solve]
    xj, iters_j, conv_j = jax_row[solve]
    if solve == "grid":
        x = x.reshape(4, -1).T.reshape(-1)  # field-major → cell-major
    assert converged and conv_j and iters == iters_j
    scale = np.abs(xj).max()
    diff = np.abs(x - xj).max() / scale
    if solve == "circ" and diff > 1e-10:
        u0 = jax_row["u0"]
        u2 = u0 * (1 + 1e-15 * np.random.default_rng(3).standard_normal(u0.shape))
        spread = np.abs(jax_row["circ_solve"](u2) - xj).max() / scale
        assert spread > 1e-10 and diff <= 10 * spread, (diff, spread)
    else:
        assert diff <= 1e-10, diff
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[solve][0], ranks[0][solve][0])


def test_rank0_solves_on_one_device(ranks):
    x1, iters1, conv1 = ranks[0]["grid_1dev"]
    x, iters, _ = ranks[0]["grid"]
    assert conv1 and iters1 == iters and all(r["grid_1dev"] is None for r in ranks[1:])
    np.testing.assert_allclose(x, x1, rtol=0, atol=1e-10 * np.abs(x1).max())


def test_record_has_the_jax_keys(ranks, jax_row):
    rec = ranks[0]["record"]
    missing = set(R05["wave_implicit_dist_kershaw32_8dev"]) - set(rec)
    assert not missing, missing
    assert rec["metric"] == f"wave_implicit_dist_kershaw{N}_{P}dev" and rec["ranks"] == P
    assert (rec["pc_halo_fwd"], rec["pc_halo_bak"], rec["spmv_halo"]) == jax_row["halos"]
    assert rec["gmres_iters"] == jax_row["circ"][1]
    assert rec["gridmg_gspmd_iters"] == jax_row["grid"][1] == rec["gridmg_one_device_iters"]
    assert "gate_failures" not in rec  # no r05 count at 8³; gridmg equal to one device


@pytest.mark.parametrize("outcome", ["pass", "miss"])
def test_dist_worker_exit_code(ranks, outcome):
    """Fake counts on a fake clock: circulant2l 99 passes, 120 misses r05's 99
    ± 1; every rank returns the same code, and only rank 0 prints."""
    codes = {r[outcome][0] for r in ranks}
    assert codes == ({0} if outcome == "pass" else {1})
    rec = json.loads(ranks[0][outcome][1].strip().splitlines()[-1])
    assert rec["metric"] == f"wave_implicit_dist_kershaw32_{P}dev"
    assert rec["value"] == pytest.approx(40.0) and rec["gridmg_gspmd_ms_per_step"] == \
        pytest.approx(40.0)
    assert rec["chain"]["pairs"] == 3
    assert bool(rec.get("gate_failures")) == (outcome == "miss")
    assert all(r[outcome][1] == "" for r in ranks[1:])


def test_row_runs_torchrun_per_world_size(monkeypatch):
    """The row starts dist_command for each P of --dist-ranks and takes rank
    0's record from the last line of their stdout; a run that exits non-zero
    keeps its record only when it failed a gate, else the row raises."""
    import subprocess

    calls = []

    def fake_run(cmd, stdout, text, env, timeout):
        P = int(cmd[cmd.index("--nproc-per-node") + 1])
        calls.append((cmd, env["PYTHONPATH"].split(":")[0]))
        rec = {"metric": f"wave_implicit_dist_kershaw48_{P}dev", "unit": "ms/step"}
        if P == 4:
            rec["gate_failures"] = ["gmres_iters 120, outside 111 ± 1"]
        return subprocess.CompletedProcess(cmd, int(P == 4), f"log\n{json.dumps(rec)}\n")

    from circulantpreconditioner_tpu_torch.native import build

    monkeypatch.setattr(build, "build", lambda: None)  # no nvcc here: the kernels' build
    monkeypatch.setattr(ts.subprocess, "run", fake_run)
    s = ts.Suite("cuda", log=lambda msg: None, dist_ranks=(1, 4))
    recs, failed = ts.run_rows(s, ["scale_distributed48"])
    assert [c[0] for c in calls] == [ts.dist_command(48, 1), ts.dist_command(48, 4)]
    assert all(root == str(ROOT) for _, root in calls)
    assert [r["metric"] for r in recs] == ["wave_implicit_dist_kershaw48_1dev",
                                           "wave_implicit_dist_kershaw48_4dev"]
    assert failed == ["scale_distributed48"]
    monkeypatch.setattr(ts.subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
        cmd, 1, "Traceback ...\n"))
    recs, failed = ts.run_rows(s, ["scale_distributed"])
    assert failed == ["scale_distributed"] and "no record" in recs[0]["error"]
