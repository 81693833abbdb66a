"""The port's measurement programs (circulantpreconditioner_tpu_torch/bench.py
and bench_suite.py) on the CPU: the paired-chain timer's rules on a fake
clock, the rows' names and gates against the JAX suite's record
(results/bench_suite_r05.json), the modules' imports, and each row's case
builder, that is everything a row does but its timing, against the JAX calls
that the matching function of the repository's bench_suite.py makes, in
float64 at a small size (the same NumPy inputs).

Tolerances: iterations and `converged` equal; states within 1e-10 ×
max|state_JAX| (1e-12 for the direct solves and the explicit steps, which
run no Krylov loop); stored entries equal. Two Krylov cases move by more
than that in the JAX package itself when b changes by 1e-15 relative: GMRES
with no preconditioner and with circulant2l at cfl 1e3/3 (the residual
stalls near 1e-3 of its start for tens of iterations, and the basis
amplifies roundoff: 5e-15 after 10 iterations, 7e-8 after 30). There the bar
is ten times that movement of the JAX solve (`_close_krylov`).
"""

import ast
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cartesian
from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.mesh.unstructured import kershaw_tet_mesh as j_ktet
from circulantpreconditioner_tpu.mesh.unstructured import tet_mesh as j_tet
from circulantpreconditioner_tpu.models import DiffusionEquation as JDiffusion
from circulantpreconditioner_tpu.models import TransportEquation as JTransport
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.models.wave import _identity_plus as j_identity_plus
from circulantpreconditioner_tpu.ops.circulant import CirculantTransportOperator as JOp
from circulantpreconditioner_tpu.ops.csr import CSRMatrix as JCSR
from circulantpreconditioner_tpu.ops.dft_matmul import MatmulCirculantSolver as JStaged
from circulantpreconditioner_tpu.ops.fused_circulant import FusedCirculantSolver as JFused
from circulantpreconditioner_tpu.ops.spectral_collapse import make_circulant_solver as j_mcs
from circulantpreconditioner_tpu.solvers import make_gmres as j_make_gmres
from circulantpreconditioner_tpu.solvers import preconditioners as jpcs
from circulantpreconditioner_tpu.solvers.aggregation_pc import AggregationVCyclePC as JAgg
from circulantpreconditioner_tpu.solvers.aggregation_pc import GridVCyclePC as JGrid
from circulantpreconditioner_tpu.solvers.circulant_pc import (
    BlockCirculantProjectionPC as JBlockPC,
)
from circulantpreconditioner_tpu.solvers.circulant_pc import DCTBlockProjectionPC as JDctPC
from circulantpreconditioner_tpu_torch import bench as tb
from circulantpreconditioner_tpu_torch import bench_suite as ts

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)
B01 = ((0.0, 1.0),) * 3
ROOT = pathlib.Path(__file__).resolve().parents[1]
R05 = json.loads((ROOT / "results" / "bench_suite_r05.json").read_text())


def _close(x, ref, tol):
    ref = np.asarray(ref)
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert x.shape == ref.shape
    np.testing.assert_allclose(x, ref, rtol=0, atol=tol * np.abs(ref).max())


def _close_krylov(x, ref, jax_solve, b, tol=1e-10):
    """x within tol × max|ref| of the JAX solve's ref, or, where the JAX solve
    itself moves by more than that when b changes by 1e-15 relative, within
    ten times that movement."""
    ref, x = np.asarray(ref), x.numpy()
    scale = np.abs(ref).max()
    diff = np.abs(x - ref).max() / scale
    if diff <= tol:
        return
    b = np.asarray(b)
    b2 = b * (1 + 1e-15 * np.random.default_rng(3).standard_normal(b.shape))
    spread = np.abs(np.asarray(jax_solve(jnp.asarray(b2))) - ref).max() / scale
    assert spread > tol and diff <= 10 * spread, (diff, spread)


# --- the paired-chain timer on a fake clock ------------------------------------

class FakeChain:
    """chain(K) → seconds of K calls at `per` each plus a fixed 5 ms, with
    `extra[i]` seconds added to the i-th chain (0-based) when given."""

    def __init__(self, per, extra=None, per_of_pair=None):
        self.per, self.extra = per, dict(extra or {})
        self.per_of_pair = per_of_pair  # pair index → per-call seconds
        self.calls = 0

    def __call__(self, K):
        i = self.calls
        self.calls += 1
        per = self.per if self.per_of_pair is None else self.per_of_pair(i // 2)
        return 5e-3 + per * K + self.extra.get(i, 0.0)


def test_paired_chain_rejects_a_hiccup_pair():
    """A stall during a pair's K1 chain shrinks its difference to nearly 0:
    that pair has no partner and is passed over for the agreeing ones."""
    chain = FakeChain(1e-5, extra={0: 0.9 * 1e-5 * 9000})  # pair 0: K1 chain stalls
    t = tb.paired_chain_estimate(chain, 1000, 10000)
    assert t.per_s == pytest.approx(1e-5, rel=1e-9)
    assert min(t.pairs) < 0.2e-5 and len(t.pairs) == 3


def test_paired_chain_best_pairs_must_agree():
    """With no two of the first pairs within 10 %, more pairs are taken until
    two agree; the smaller of the two is the result."""
    pers = [1.0e-5, 1.3e-5, 1.7e-5, 2.2e-5, 1.05e-5]
    chain = FakeChain(None, per_of_pair=lambda k: pers[k])
    t = tb.paired_chain_estimate(chain, 10, 110)
    assert len(t.pairs) == 5 and chain.calls == 10
    assert t.per_s == pytest.approx(1.0e-5) and t.partner == pytest.approx(1.05e-5)


def test_paired_chain_pairs_that_never_agree_raise():
    chain = FakeChain(None, per_of_pair=lambda k: 1e-5 * 1.5**k)
    with pytest.raises(tb.TimingError, match="agree"):
        tb.paired_chain_estimate(chain, 10, 110, max_pairs=6)
    assert chain.calls == 12


def test_paired_chain_time_below_bound_raises():
    with pytest.raises(tb.TimingError, match="below the card's bound"):
        tb.paired_chain_estimate(FakeChain(1e-6), 10, 110, bound_ms=0.002)
    t = tb.paired_chain_estimate(FakeChain(3e-6), 10, 110, bound_ms=0.002)
    assert t.per_s == pytest.approx(3e-6)


@pytest.mark.parametrize("pers, best", [
    ([1.0, 1.05, 3.0], (1.0, 1.05)),
    ([0.01, 1.0, 1.09], (1.0, 1.09)),      # the hiccup 0.01 has no partner
    ([-0.5, 1.0, 1.2, 1.25], (1.2, 1.25)),  # negative pairs are not times
    ([1.0, 1.2, 1.5], None),
])
def test_agreeing_best(pers, best):
    assert tb.agreeing_best(pers) == best


def test_timer_raises_without_cuda():
    """On the CPU the timer raises before it runs a chain; a CUDA request
    raises where no card is present."""
    chain = FakeChain(1e-5)
    with pytest.raises(tb.TimingError, match="CUDA"):
        tb.paired_chain_time(chain, 10, 110, device="cpu")
    assert chain.calls == 0
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(tb.TimingError, match="is_available"):
        tb.paired_chain_time(chain, 10, 110, device="cuda")
    assert chain.calls == 0


def test_entry_points_exit_non_zero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tb.main() == 1
    assert ts.main(["unused.json", "spmv"]) == 1


# --- names, gates and imports ---------------------------------------------------

def test_rows_carry_the_r05_metric_names_and_units():
    r05 = {r["metric"]: r["unit"] for r in R05["results"]}
    assert len(ts.ROWS) == 14
    for name, row in ts.ROWS.items():
        assert r05[row.metric] == row.unit, name
    assert tb.METRIC in r05 and r05[tb.METRIC] == tb.UNIT


def test_gates_are_the_r05_counts():
    rows = {r["metric"]: r for r in R05["results"]}
    for metric, fields in ts.R05_ITERS.items():
        for field_, (want, conv) in fields.items():
            # the 16³ row's alternatives carry no converged field in r05
            assert rows[metric][field_] == want and rows[metric].get(conv, True) is True, \
                (metric, field_)
    table = rows["wave_implicit_gmres_iters_by_pc"]["value"]
    assert {m: {k: v["iters"] for k, v in row.items()} for m, row in table.items()} \
        == ts.R05_PC_TABLE
    assert all(v["converged"] for row in table.values() for v in row.values())


def test_gate_record_holds_counts_to_the_band():
    rec = {"metric": "wave_implicit_step_ms_kershaw32", "gmres_iters": 34, "converged": True}
    assert "gate_failures" not in ts.gate_record(rec) and rec["r05"] == {"gmres_iters": 33}
    rec = {"metric": "wave_implicit_step_ms_kershaw32", "gmres_iters": 35, "converged": True}
    assert ts.gate_record(rec)["gate_failures"]
    rec = {"metric": "wave_implicit_step_ms_kershaw32", "gmres_iters": 33, "converged": False}
    assert ts.gate_record(rec)["gate_failures"]
    # the 16³ row run with gridmg alone (chip_smoke.py's quick mode)
    rec = {"metric": "wave_implicit_step_ms_kershaw16", "gmres_iters": 25, "converged": True}
    assert "gate_failures" not in ts.gate_record(rec) and rec["r05"] == {"gmres_iters": 25}


@pytest.mark.parametrize("module", ["bench", "bench_suite"])
def test_measurement_modules_import_no_jax(module):
    """Neither module imports jax or the JAX package (the AST), and importing
    it in a fresh interpreter loads neither."""
    src = (ROOT / "circulantpreconditioner_tpu_torch" / f"{module}.py").read_text()
    names = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "circulantpreconditioner_tpu" not in roots, roots
    code = (f"import sys; import circulantpreconditioner_tpu_torch.{module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'circulantpreconditioner_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_merge_by_metric_name(tmp_path):
    """A subset run merges into the file by metric name; a failed row drops
    its older records and a re-run row its older error record."""
    out = str(tmp_path / "suite.json")
    dev = {"name": "card"}
    ts.write_results(out, [{"metric": "spmv_gnnz_per_s_kershaw32", "value": 1.0},
                           {"metric": "wave_ilu_ERROR", "error": "x"},
                           {"metric": "spmv_gnnz_per_s_tet16", "value": 2.0}], None, [], dev)
    ts.write_results(out, [{"metric": "spmv_gnnz_per_s_kershaw32", "value": 3.0},
                           {"metric": "wave_ilu0_step_ms_32cubed", "value": 4.0},
                           {"metric": "spmv_tet_ERROR", "error": "y"}],
                     ["spmv", "wave_ilu", "spmv_tet"], ["spmv_tet"], dev)
    got = {r["metric"]: r for r in json.loads(pathlib.Path(out).read_text())["results"]}
    assert set(got) == {"spmv_gnnz_per_s_kershaw32", "wave_ilu0_step_ms_32cubed",
                        "spmv_tet_ERROR"}
    assert got["spmv_gnnz_per_s_kershaw32"]["value"] == 3.0


# --- the rows' cases against the JAX calls, float64 on the CPU -------------------

def test_flagship_case():
    """bench.py's solvers at 12³ on the same b: the dense collapse and the
    staged DFT solver (use_kernel False and True) against the JAX calls in
    float64; the fused solver against the JAX staged one in float64 (the same
    function: the JAX fused kernel computes in float32 only), and in float32
    against the JAX fused kernel in Pallas interpret mode at the "highest"
    tier, to K1's bar 1e-5 · max|x|: the port runs every tier in full fp32,
    while the JAX "high" tier's bf16×3 products err by 3.5e-5 here (its
    "highest" by 4.0e-7, the port's by 5.1e-7, from float64)."""
    n = 12
    c = tb.flagship_case(n, **F64)
    lams = tb.flagship_lambdas(n)
    op = JOp.create((n,) * 3, lams, jnp.float64)
    b = jnp.asarray(c.u0.numpy())
    staged = JStaged.from_operator(op, precision="high")
    ref = {"flagship": j_mcs((n,) * 3, lams, jnp.float64, precision="high"),
           "staged_full3d": staged,
           "staged_full3d_k3": JStaged.create((n,) * 3, lams, jnp.float64, precision="high",
                                              use_kernel=True),
           "fused_full3d": staged}
    assert set(c.states) == set(ref)
    for name, solver in ref.items():
        _close(c.states[name], solver.solve(b), 1e-12)
        assert c.residuals[name] < 1e-12
    assert type(c.solvers["flagship"]).__name__ == "DenseCirculantSolver"
    c32 = tb.flagship_case(n, device=CPU, dtype=torch.float32)
    j32 = JFused.from_operator(JOp.create((n,) * 3, lams, jnp.float32), precision="highest",
                               interpret=True)
    _close(c32.states["fused_full3d"], j32.solve(jnp.asarray(c32.u0.numpy())), 1e-5)


def test_transport_implicit_case():
    n, steady = 8, 3
    cases = ts.transport_implicit_case(n, steady_steps=steady, **F64)
    model = JTransport(j_cartesian(B01, (n,) * 3), velocity=[1.0, 0.0, 0.0], cfl=1e3 / 3,
                       dtype=jnp.float64)
    op = model.fft_operator
    M = j_mcs(op.shape_zyx, op.lambdas_zyx, dtype=jnp.float64,
              precision="high").as_preconditioner()
    u0 = model.initial_state()
    for name, M_, side, restart in (("circulant", M, "right", 8), ("pcnone", None, "left", 30)):
        step = model.implicit_stepper(M=M_, rtol=1e-5, atol=1e-5, maxiter=1000, side=side,
                                      restart=restart, layout="lane")
        x, _, it, _, conv = step(u0)
        v = u0
        for _ in range(steady):
            v = step(v)[0]
        c = cases[name]
        assert (c.iters, c.converged) == (int(it), bool(conv)), name
        assert c.extra["iters_steady"] == int(step(v)[2]), name
        _close(c.state, x, 1e-10)


def test_wave_explicit_case():
    n, steps = 8, 3
    _, _, _, G = ts.wave_explicit_case(n, steps=steps, **F64)
    model = JWave(j_kershaw(B01, (n,) * 3), cfl=1.0 / 3, dtype=jnp.float64)
    step = model.explicit_stepper_fm()
    g = model.pack_fm(model.initial_state())
    for _ in range(steps):
        g = step(g)[0]
    _close(G, g, 1e-12)


@pytest.mark.parametrize("family, n", [("kershaw", 8), ("tet", 4)])
def test_spmv_case(family, n):
    c = ts.spmv_case(n, family, **F64)
    model = JWave((j_kershaw if family == "kershaw" else j_tet)(B01, (n,) * 3), cfl=1e3 / 3,
                  dtype=jnp.float64)
    A = model.divergence.to_csr(jnp.float64)
    assert c.nnz == A.nnz
    D = model.divergence_op_fm()
    x0 = model.pack_fm(c.x_cm)
    y = D(x0)
    ref = y / jnp.maximum(jnp.linalg.norm(y), 1e-30) * jnp.linalg.norm(x0)
    _close(c.link(c.x0), ref, 1e-12)


def _jax_wave_implicit_step(model, mesh, pc):
    """The JAX suite's bench_wave_implicit preconditioner and step."""
    pj_fm = jpcs.pbjacobi_fm(model.divergence, shift=1.0)
    if pc == "gridmg":
        pc_obj = JGrid.from_grid_model(model.divergence, mesh.topology_shape, cells_per_site=1,
                                       A0_apply=model.implicit_matvec(),
                                       A0_apply_fm=model.implicit_matvec_fm(), shift=1.0,
                                       dtype=jnp.float64)
        M_cm, M_fm = None, pc_obj.apply_fm_partial()
    elif pc == "dct2lm":
        coarse = JDctPC(mesh, model.dt, model.c0, dtype=jnp.float64)
        M_cm, M_fm = None, jpcs.multiplicative(
            model.implicit_matvec_fm(), jpcs.cell_major_adapter(coarse.apply, model.nb), pj_fm)
    else:
        cls = JBlockPC if pc == "circulant2l" else JDctPC
        M_cm, M_fm = cls(mesh, model.dt, model.c0, dtype=jnp.float64).apply, pj_fm
    return model.implicit_stepper_fm(M_cm=M_cm, M_fm=M_fm, rtol=1e-5, atol=1e-5, maxiter=1000,
                                     side="right")


@pytest.mark.parametrize("pc", ["gridmg", "dct2lm", "dct2l", "circulant2l"])
def test_wave_implicit_case(pc):
    n = 10
    c = ts.wave_implicit_case(n, pc, **F64)
    mesh = j_kershaw(B01, (n,) * 3)
    model = JWave(mesh, cfl=1e3 / 3, dtype=jnp.float64)
    U = model.pack_fm(model.initial_state()).reshape(-1)
    step = _jax_wave_implicit_step(model, mesh, pc)
    x, _, it, _, conv = step(U)
    assert (c.iters, c.converged) == (int(it), bool(conv))
    _close(c.U0, U, 0)
    _close_krylov(c.state, x, lambda b: step(b)[0], U)


def test_wave_dct_direct_case():
    n, steps = 8, 2
    _, _, _, U = ts.wave_dct_direct_case(n, steps=steps, **F64)
    model = JWave(j_cartesian(B01, (n,) * 3), cfl=1e3 / 3, dtype=jnp.float64)
    step = model.dct_fft_stepper_fm()
    u = model.pack_fm(model.initial_state())
    for _ in range(steps):
        u = step(u)[0]
    _close(U, u, 1e-12)


def test_diffusion_case():
    n, steps = 8, 2
    cg, _, _, u_fft = ts.diffusion_case(n, fft_steps=steps, **F64)
    model = JDiffusion(j_cartesian(B01, (n,) * 3), cfl=10.0, dtype=jnp.float64)
    x, _, it, _, conv = model.implicit_stepper(rtol=1e-5, atol=1e-5, maxiter=1000)(
        model.initial_state())
    assert (cg.iters, cg.converged) == (int(it), bool(conv))
    _close(cg.state, x, 1e-10)
    modelp = JDiffusion(j_cartesian(B01, (n,) * 3, periodic=True), cfl=10.0, dtype=jnp.float64)
    step = modelp.fft_stepper()
    u = modelp.initial_state()
    for _ in range(steps):
        u = step(u)[0]
    _close(u_fft, u, 1e-12)


def test_wave_ilu_case():
    n = 8
    c = ts.wave_ilu_case(n, **F64)
    model = JWave(j_cartesian(B01, (n,) * 3), cfl=1e3 / 3, dtype=jnp.float64)
    A_I = JCSR.from_scipy((sp.eye(model.divergence.shape[0])
                           + model.divergence.to_csr(jnp.float64).to_scipy()).tocsr(),
                          dtype=jnp.float64)
    ilu = jpcs.ilu0(A_I)
    M = ilu.apply_partial() if hasattr(ilu, "apply_partial") else ilu.apply
    U0 = model.initial_state()
    out = j_make_gmres(model.implicit_matvec(), M, rtol=1e-5, atol=1e-5, maxiter=100,
                       side="left", layout="lane")(U0, U0)
    assert (c.iters, c.converged) == (int(out.iters), bool(out.converged))
    assert c.extra["unknowns"] == A_I.shape[0]
    _close(c.state, out.x, 1e-10)


@pytest.fixture(scope="module")
def pc_table_8():
    """The JAX suite's iteration table at Kershaw 8³ and the port's cases."""
    n = 8
    mesh = j_kershaw(B01, (n,) * 3)
    model = JWave(mesh, cfl=1e3 / 3, dtype=jnp.float64)
    pj = jpcs.pbjacobi(model.divergence, shift=1.0)
    coarse = JBlockPC(mesh, model.dt, model.c0, dtype=jnp.float64)
    dct = JDctPC(mesh, model.dt, model.c0, dtype=jnp.float64)
    gridmg = JGrid.from_grid_model(model.divergence, mesh.topology_shape, cells_per_site=1,
                                   A0_apply=model.implicit_matvec(), shift=1.0,
                                   dtype=jnp.float64)
    aggv = JAgg.from_bsr(model.divergence, A0_apply=model.implicit_matvec(), shift=1.0,
                         factor=4, bottom_max=600, dtype=jnp.float64)
    pcs_by_name = {"none": None, "pbjacobi": pj,
                   "circulant2l": jpcs.additive(coarse.apply, pj),
                   "dct2l": jpcs.additive(dct.apply, pj),
                   "dct2lm": jpcs.multiplicative(model.implicit_matvec(), dct.apply, pj),
                   "gridmg": gridmg.apply_partial(), "aggvcycle": aggv.apply_partial()}
    return model, pcs_by_name, ts.pc_table_case(n, **F64)


@pytest.mark.parametrize("name", ts.PC_NAMES)
def test_pc_table_case(pc_table_8, name):
    model, pcs_by_name, cases = pc_table_8
    step = model.implicit_stepper(M=pcs_by_name[name], rtol=1e-5, atol=1e-5, maxiter=1000,
                                  side="right")
    U0 = model.initial_state()
    x, _, it, _, conv = step(U0)
    assert (cases[name].iters, cases[name].converged) == (int(it), bool(conv))
    _close_krylov(cases[name].state, x, lambda b: step(b)[0], U0)


def test_ladder_top_case():
    """Kershaw-tet 4³: field-major GMRES over the supercell operator with the
    grid V-cycle whose fine level reuses it, built by the port's model and
    stepper as its driver builds them (by hand in the JAX suite's
    bench_ladder_top)."""
    n = 4
    c = ts.ladder_top_case(n, **F64)
    mesh = j_ktet(B01, (n,) * 3)
    model = JWave(mesh, cfl=1e3 / 3, dtype=jnp.float64)
    A_fm = jax.tree_util.Partial(j_identity_plus, model.divergence_op_fm(flat=True))
    pc = JGrid.from_grid_model(model.divergence, mesh.topology_shape, cells_per_site=6,
                               A0_apply=A_fm, A0_apply_fm=A_fm, shift=1.0, dtype=jnp.float64)
    U0 = model.pack_fm(model.initial_state()).reshape(-1)
    out = j_make_gmres(A_fm, pc.apply_fm_partial(), rtol=1e-5, atol=1e-5, maxiter=1000,
                       side="right")(U0, U0)
    assert (c.iters, c.converged) == (int(out.iters), bool(out.converged))
    assert c.extra["pc"].n_levels == pc.n_levels
    _close(c.state, out.x, 1e-10)
    assert ts.tensor_bytes(c.extra["pc"]) > 0


def test_tensor_bytes_counts_each_tensor_once():
    a, b = torch.zeros(10), torch.zeros(3, dtype=torch.float64)
    assert ts.tensor_bytes({"x": (a, a), "y": functools.partial(torch.add, b)}) == 40 + 24
