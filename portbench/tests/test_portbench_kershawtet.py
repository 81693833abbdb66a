"""The Kershaw-tetra cell `kershawtet50.gmres_gridmg` on the CPU: its tiny
tree (6³ hexahedra, 1,296 tets) runs end to end through the unchanged
`wave_gmres` route and reads `correct`, and a traced run reports its two
metrics from the port's spans (on the host clock here); the closed-form face
count of `supercell_spmv_roofline` is the frozen family's; and both metrics
read None where their spans are absent or nothing ran in them (a parent
without the spans)."""

from __future__ import annotations

import pytest
import torch

from portbench import roofline, run, spec
from portbench.metrics import Context, site_level_ms_per_step, supercell_spmv_roofline
from portbench.reference.families import kershawtet
from portbench.tests.conftest import tiny_root
from portbench.trace import Trace

CELL = "kershawtet50.gmres_gridmg"
CONFIG = {"mesh": {"family": "kershawtet", "n": [50, 50, 50]}}
STATS = {"span_port_supercell_n": 1000, "span_port_supercell_incl_s": 0.5,
         "span_port_pc_site_incl_s": 0.8}


def _ctx(stats, steps=10):
    return Context(CONFIG, {}, 40, [42] * 4, stats, Trace(window_s=2.0, busy_s=1.9, steps=steps),
                   0.16)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_cells_tiny_tree_runs_and_is_correct(tmp_path, trace):
    cell = spec.load_cell(CELL, tiny_root(tmp_path))
    assert (cell.config["mesh"]["family"], cell.config["mesh"]["n"]) == ("kershawtet", [6, 6, 6])
    assert cell.limits == {"check": "error", "limit": 3e-05, "samples": 3}
    result = run.run(cell, 2**35 + 21, 2.0, trace, torch.device("cpu"))
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    m = result["metrics"]
    if not trace:
        assert set(m) == {"step_ms", "peak_mem_gib", "setup_s"}  # no p95: not listed there
        return
    assert {"supercell_spmv_roofline", "site_level_ms_per_step"} <= set(m)
    assert "gmres_iters" not in m and "pc_ms_per_step" not in m  # listed for other cells
    assert m["supercell_spmv_roofline"]["value"] > 0 and m["site_level_ms_per_step"]["value"] > 0


@pytest.mark.parametrize("n", [(1, 1, 1), (2, 3, 4), (4, 4, 4), (6, 5, 3)])
def test_closed_form_faces_are_the_frozen_familys(n):
    geo = kershawtet.geometry({"family": "kershawtet", "n": list(n), "eps": 0.3})
    assert geo.neighbour.shape == (6 * n[0] * n[1] * n[2], 4)
    assert supercell_spmv_roofline.interior_faces(n) == int((geo.neighbour >= 0).sum()) // 2
    assert 4 * (n[0] * n[1] + n[1] * n[2] + n[0] * n[2]) == int((geo.neighbour < 0).sum())


def test_least_bytes_at_50_cubed():
    assert supercell_spmv_roofline.least_bytes([50, 50, 50]) == 119_520_000
    t, by = roofline.bound(0.0, supercell_spmv_roofline.least_bytes([50, 50, 50]))
    assert by == "bytes" and t == pytest.approx(35.68e-6, rel=1e-3)


@pytest.mark.parametrize("reader,expected", [
    (supercell_spmv_roofline, 100 * 119_520_000 * 1000 / roofline.PEAK_BYTES / 0.5),
    (site_level_ms_per_step, 0.8e3 / 10),
])
def test_readers_value_and_absence(reader, expected):
    assert reader.read(_ctx(STATS)) == pytest.approx(expected)
    assert reader.read(_ctx({})) is None  # the spans absent: a parent without them
    assert reader.read(_ctx({k: 0 for k in STATS})) is None  # present, nothing ran
