"""The cell transport100_fftpc.gmres_circulant and its two readers: the FFT
preconditioner inside right-preconditioned GMRES on the transport cube, at
the tiny size on the CPU. The cell judges the program's answers correct and
the TF32 control's not; a traced run reports the restarts that the true
residual forced and the dense collapse's share of its bytes bound (its
span on the host clock here); each reader gives its value from a hand-made
Context, and None where its counter or span is absent (a program without
them) or zero."""

from __future__ import annotations

import pytest
import torch

from portbench import roofline, run, spec
from portbench.metrics import Context, circulant_pc_roofline, true_restarts_per_solve
from portbench.tests.conftest import tiny_root
from portbench.tests.test_portbench_faults import broken_run, tf32_control

CELL = "transport100_fftpc.gmres_circulant"
CONFIG = {"mesh": {"n": [100, 100, 100]}, "velocity": [1.0, 0.0, 0.0], "dtype": "float32"}


def _ctx(stats, config=CONFIG):
    return Context(config, {}, 40, [6] * 40, stats)


@pytest.mark.parametrize("fault", [None, tf32_control], ids=["program", "tf32_control"])
def test_the_cell_judges_the_program_and_refuses_the_control(monkeypatch, tmp_path, fault):
    result = broken_run(monkeypatch, spec.load_cell(CELL, tiny_root(tmp_path)), fault,
                        torch.device("cpu"))
    (check,) = result["checks"].values()
    assert result["correct"] is (fault is None), check
    assert result["failed"] == 0


def test_a_traced_run_reports_the_true_restarts_and_the_collapse_roofline(tmp_path):
    result = run.run(spec.load_cell(CELL, tiny_root(tmp_path)), 2**34 + 25, 2.5, True,
                     torch.device("cpu"))
    assert result["correct"]
    m = result["metrics"]
    assert m["true_restarts_per_solve"]["value"] >= 0
    assert m["circulant_pc_roofline"]["value"] > 0
    assert "gmres_iters" not in m  # its workloads list the wave cells alone


def test_true_restarts_per_solve_reads_the_counter():
    assert true_restarts_per_solve.read(_ctx({"solves": 40, "true_restarts": 50})) == 1.25
    assert true_restarts_per_solve.read(_ctx({"solves": 40, "true_restarts": 0})) == 0.0
    assert true_restarts_per_solve.read(_ctx({"solves": 40})) is None  # no such counter
    assert true_restarts_per_solve.read(_ctx({"solves": 0, "true_restarts": 0})) is None


def test_circulant_pc_roofline_reads_the_span():
    stats = {"span_port_pc_circulant_n": 1000, "span_port_pc_circulant_incl_s": 0.012}
    least = (2 * 100**3 + 100**2) * 4  # b, x and the 100 × 100 inverse: 8.04 MB
    assert circulant_pc_roofline.least_bytes([100, 100, 100], [1.0, 0.0, 0.0]) == least
    assert circulant_pc_roofline.read(_ctx(stats)) == pytest.approx(
        100 * least * 1000 / roofline.PEAK_BYTES / 0.012)
    assert circulant_pc_roofline.read(_ctx({})) is None  # no such span
    assert circulant_pc_roofline.read(_ctx({k: 0 for k in stats})) is None
    wave = {"mesh": {"n": [64, 64, 64]}, "dtype": "float32"}
    assert circulant_pc_roofline.read(_ctx(stats, wave)) is None  # no velocity
    oblique = {**CONFIG, "velocity": [1.0, 0.5, 0.0]}  # not the one-axis collapse
    assert circulant_pc_roofline.read(_ctx(stats, oblique)) is None
