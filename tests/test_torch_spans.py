"""The port's spans and wait counter (utils/profiling.py, utils/graphs.py).

On the CPU: the device spans' accounting on the host clock (nesting, self
against inclusive time, entries); nothing accumulates and nothing is
recorded while no profiler runs; the snapshot's keys do not change; under
a CPU profiler the spans of a small wave GMRES solve count the operator's
applies, the iterations and the PC's applies, with the grid V-cycle and
with the multiplicative DCT projection PC; `wait_seconds` grows with the
flag ring's waits; the host spans are host ops, never user annotations
(the kind the profiler copies onto the device timeline).

The `gpu`-marked tests run on the card: a graph replayed while no profiler
runs runs no marker and takes the time of the same graph captured with no
markers; under the profiler the spans count as on the CPU, and once the
profiler stops the markers are off again. This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from circulantpreconditioner_tpu_torch.mesh.unstructured import kershaw_mesh
from circulantpreconditioner_tpu_torch.models import WaveSystem, run_time_loop
from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC
from circulantpreconditioner_tpu_torch.solvers.circulant_pc import DCTBlockProjectionPC
from circulantpreconditioner_tpu_torch.utils import graphs, profiling
from circulantpreconditioner_tpu_torch.utils.profiling import DEVICE_SPANS, device_span, host_span

CPU = torch.device("cpu")
FUNCTION_SCOPE = 0  # RecordScope::FUNCTION; a user annotation (record_function) is USER_SCOPE, 7
SPAN_KEYS = {f"span_{n.replace('.', '_')}{s}" for n in DEVICE_SPANS
             for s in ("_n", "_s", "_incl_s")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("runs on the card (the span markers are a CUDA kernel): need a GPU "
                    "(torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _totals():
    return dict(zip(DEVICE_SPANS, profiling.SPANS.totals().tolist()))


def test_host_clock_accounting_nests():
    graphs.STATS.reset()
    with _cpu_profile():
        with device_span("port.gmres.apply", CPU):
            time.sleep(0.002)
            for _ in range(2):
                with device_span("port.pc", CPU):
                    time.sleep(0.003)
                    with device_span("port.pc.coarse", CPU):
                        time.sleep(0.001)
    t = _totals()
    (n_a, incl_a, self_a), (n_p, incl_p, self_p), (n_c, incl_c, self_c) = (
        t["port.gmres.apply"], t["port.pc"], t["port.pc.coarse"])
    assert (n_a, n_p, n_c) == (1, 2, 2)
    assert self_c == incl_c >= 2 * 1_000_000  # a leaf: self is inclusive
    assert self_p == incl_p - incl_c and self_p >= 2 * 3_000_000
    assert self_a == incl_a - incl_p and self_a >= 2_000_000
    assert incl_a >= incl_p + 2_000_000
    snap = graphs.STATS.snapshot()
    assert snap["span_port_pc_n"] == 2 and snap["span_port_pc_incl_s"] == incl_p * 1e-9
    assert snap["span_port_pc_s"] == self_p * 1e-9


def test_nothing_accumulates_or_is_recorded_without_a_profiler():
    graphs.STATS.reset()
    assert not profiling.tracing()
    assert device_span("port.op", CPU) is host_span("port.time_loop")  # the shared no-op
    with device_span("port.op", CPU), host_span("port.loop.host"):
        time.sleep(0.001)
    assert all(v == 0 for k, v in graphs.STATS.snapshot().items() if k in SPAN_KEYS)
    with _cpu_profile() as prof:
        torch.ones(3).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not any(n.startswith("port.") for n in names)
    assert all(v == 0 for k, v in graphs.STATS.snapshot().items() if k in SPAN_KEYS)


def test_snapshot_keys_stay_the_same():
    graphs.STATS.reset()
    before = graphs.STATS.snapshot()
    assert SPAN_KEYS | {"wait_seconds", "waits", "solves"} <= set(before)
    assert all(before[k] == 0 for k in SPAN_KEYS)
    with _cpu_profile():
        with device_span("port.op", CPU):
            pass
    after = graphs.STATS.snapshot()
    assert set(after) == set(before) and after["span_port_op_n"] == 1


def _wave_solve(pc_name: str, device: torch.device, n: int = 12):
    """A small wave GMRES step (field-major, right) with the grid V-cycle or
    the multiplicative DCT projection PC, counting the divergence's applies
    (the operator I + D's) and the PC's applies."""
    mesh = kershaw_mesh(((-0.5, 0.5),) * 3, (n,) * 3)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    model = WaveSystem(mesh, cfl=1e3 / 3, device=device, dtype=dtype)
    count = {"op": 0, "pc": 0}
    fm = model.divergence_op_fm

    def counted_fm(*args, **kw):
        D = fm(*args, **kw)

        def D_counted(u):
            count["op"] += 1
            return D(u)
        return D_counted

    model.divergence_op_fm = counted_fm
    if pc_name == "gridmg":
        pc = GridVCyclePC.from_grid_model(model.divergence, mesh.topology_shape,
                                          A0_apply=model.implicit_matvec(),
                                          A0_apply_fm=model.implicit_matvec_fm(), shift=1.0,
                                          dtype=dtype)
        assert pc.n_levels > 1
        M = pc.apply_fm
    else:
        coarse = DCTBlockProjectionPC(mesh, model.dt, model.c0, device=device, dtype=dtype,
                                      precision="high")
        M = pcs.multiplicative(model.implicit_matvec_fm(),
                               pcs.cell_major_adapter(coarse.apply, model.nb),
                               pcs.pbjacobi_fm(model.divergence, shift=1.0))

    def M_counted(r):
        count["pc"] += 1
        return M(r)

    step = model.implicit_stepper_fm(M_fm=M_counted, side="right")
    G = model.pack_fm(model.initial_state()).reshape(-1)
    return step, G, count


@pytest.mark.parametrize("pc_name", ["gridmg", "dct2lm"])
def test_gmres_spans_count_the_solve(pc_name):
    step, G, count = _wave_solve(pc_name, CPU)
    step(G)  # untraced: counts nothing
    graphs.STATS.reset()
    count.update(op=0, pc=0)
    with _cpu_profile():
        _, _, iters, _, converged = step(G)
    snap = graphs.STATS.snapshot()
    assert converged and iters > 1
    assert snap["span_port_op_n"] == count["op"] > iters
    assert snap["span_port_gmres_ortho_n"] == snap["iterations"] + snap["masked"]
    assert snap["span_port_pc_n"] == snap["span_port_pc_coarse_n"] == count["pc"]
    assert snap["span_port_gmres_apply_n"] == snap["iterations"] + snap["masked"]
    assert snap["span_port_gmres_cycle_n"] >= 3  # init, start, finish
    assert snap["span_port_pc_coarse_incl_s"] <= snap["span_port_pc_incl_s"]


class _SlowEvent:
    def synchronize(self):
        time.sleep(0.002)


def test_wait_seconds_grow_with_waits():
    graphs.STATS.reset()
    ring = graphs.FlagRing(3, 7, CPU)
    ring.on_card, ring.events = True, [_SlowEvent() for _ in range(3)]  # a card's ring
    for k in range(5):
        ring.read(k % 3)
        snap = graphs.STATS.snapshot()
        assert snap["waits"] == k + 1
        assert snap["wait_seconds"] >= 0.002 * (k + 1)


def test_host_spans_are_host_ops():
    step, G, _ = _wave_solve("gridmg", CPU)
    with _cpu_profile() as prof:
        run_time_loop(step, G, 1.0, tmax=1e30, ntmax=2, precision=0.0, log=None)
    scopes = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("port."):
            scopes.setdefault(e.name(), set()).add(e.scope())
    assert set(scopes) == {"port.time_loop", "port.loop.host"}
    assert all(s == {FUNCTION_SCOPE} for s in scopes.values()), scopes


# --- on the card -------------------------------------------------------------


def _spans_fn(x, y, dev):
    def fn():
        with device_span("port.gmres.apply", dev):
            with device_span("port.op", dev):
                torch.mul(x, 2.0, out=y)
                y.add_(1.0)
            with device_span("port.pc", dev):
                y.mul_(0.5)
                y.sub_(x)
    return fn


def _replay_ms(replay, n: int = 1000) -> float:
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


@pytest.mark.gpu
def test_untraced_replay_runs_no_marker(card):
    x = torch.randn(1 << 24, device=card)
    y = torch.empty_like(x)
    gs = graphs.GraphSet(card)
    gs.run("f", _spans_fn(x, y, card))  # warm-up and capture, with its markers
    g = gs._graphs["f"]
    assert len(g.markers) == 6 and not g.traced
    plain = torch.cuda.CUDAGraph()  # captured outside a GraphSet: no markers
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        plain.capture_begin()
        _spans_fn(x, y, card)()
        plain.capture_end()
    torch.cuda.current_stream(card).wait_stream(side)
    graphs.STATS.reset()
    marked, unmarked = [], []
    for _ in range(5):
        marked.append(_replay_ms(lambda: gs.run("f", None)))
        unmarked.append(_replay_ms(plain.replay))
    assert profiling.SPANS.buffers[card.index].count_nonzero().item() == 0  # no marker ran
    assert min(marked) <= 1.01 * min(unmarked), (marked, unmarked)


@pytest.mark.gpu
def test_traced_solve_counts_on_card_and_markers_go_off(card):
    step, G, _ = _wave_solve("gridmg", card, n=16)
    step(G)  # warm-up: captures
    graphs.STATS.reset()
    k2 = graphs.kernel_launches()[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, iters, _, converged = step(G)
        torch.cuda.synchronize()
    k2 = graphs.kernel_launches()[1] - k2
    snap = graphs.STATS.snapshot()
    assert converged and iters > 1 and k2 > 0
    assert snap["span_port_op_n"] == k2
    assert snap["span_port_gmres_ortho_n"] == snap["iterations"] + snap["masked"]
    assert snap["span_port_pc_n"] == snap["span_port_pc_coarse_n"] > 0
    assert 0 < snap["span_port_pc_coarse_incl_s"] <= snap["span_port_pc_incl_s"]
    assert 0 < snap["span_port_op_s"] <= snap["span_port_op_incl_s"]
    events = prof.profiler.kineto_results.events()
    marks = [e for e in events if "span_mark" in e.name()]
    on_card = {e.name() for e in events if str(e.device_type()).endswith("CUDA")}
    assert "port.flag_wait" in {e.name() for e in events}  # a host span
    assert not any(n.startswith("port.") for n in on_card)  # and never on the device timeline
    assert len(marks) == 2 * sum(snap[f"span_{n.replace('.', '_')}_n"] for n in DEVICE_SPANS)
    step(G)  # the first replays after the profiler stopped disable the markers
    after = graphs.STATS.snapshot()
    assert after["solves"] == snap["solves"] + 1
    assert {k: after[k] for k in SPAN_KEYS} == {k: snap[k] for k in SPAN_KEYS}
