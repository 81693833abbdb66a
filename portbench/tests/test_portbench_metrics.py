"""The readers of the port's spans and wait counter: each metric's value
from a hand-made Context, and None where the counters are absent or zero
(the direct cell, a parent without the counters); and a traced run of the
tiny dct2lm cell on the CPU, whose spans run on the host clock, reporting
the span metrics."""

from __future__ import annotations

import pytest

from portbench import roofline
from portbench.metrics import (
    Context,
    host_wait_ms_per_solve,
    op_apply_roofline,
    ortho_ms_per_step,
    pc_coarse_ms_per_step,
    pc_ms_per_step,
)
from portbench.trace import Trace

CONFIG = {"mesh": {"n": [64, 64, 64]}}
STATS = {"solves": 4, "waits": 160, "wait_seconds": 0.02,
         "span_port_pc_incl_s": 0.5, "span_port_pc_coarse_incl_s": 0.3,
         "span_port_gmres_ortho_incl_s": 0.2, "span_port_op_n": 1000,
         "span_port_op_incl_s": 0.025}


def _ctx(stats, steps=10):
    return Context(CONFIG, {}, 40, [38] * 4, stats,
                   Trace(window_s=2.0, busy_s=1.5, steps=steps), 0.08)


@pytest.mark.parametrize("reader,expected", [
    (pc_ms_per_step, 0.5e3 / 10),
    (pc_coarse_ms_per_step, 0.3e3 / 10),
    (ortho_ms_per_step, 0.2e3 / 10),
    (op_apply_roofline, 100 * roofline.k2_bytes(64**3, 4, 6) * 1000 / roofline.PEAK_BYTES / 0.025),
    (host_wait_ms_per_solve, 0.02e3 / 4),
])
def test_reader_value_and_absence(reader, expected):
    assert reader.read(_ctx(STATS)) == pytest.approx(expected)
    assert reader.read(_ctx({})) is None  # the counters absent
    assert reader.read(_ctx({k: 0 for k in STATS})) is None  # present, nothing ran


def test_span_readers_need_the_traced_steps():
    for reader in (pc_ms_per_step, pc_coarse_ms_per_step, ortho_ms_per_step):
        assert reader.read(_ctx(STATS, steps=0)) is None
        assert reader.read(Context(CONFIG, {}, 40, [], STATS, None)) is None


def test_a_traced_wave_run_reports_the_span_metrics(tmp_path):
    import torch

    from portbench import run, spec
    from portbench.tests.conftest import tiny_root

    cell = spec.load_cell("wave_kershaw64.gmres_dct2lm", tiny_root(tmp_path))
    result = run.run(cell, 2**35 + 7, 2.5, True, torch.device("cpu"))
    assert result["correct"]
    m = result["metrics"]
    assert {"pc_ms_per_step", "pc_coarse_ms_per_step", "ortho_ms_per_step",
            "op_apply_roofline"} <= set(m)
    assert "host_wait_ms_per_solve" not in m  # the CPU's flag ring does not wait
    assert 0 < m["pc_coarse_ms_per_step"]["value"] <= m["pc_ms_per_step"]["value"]
