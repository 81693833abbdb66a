"""BENCHMARK.json and the files it names, as data: every cell finds its
configuration, traffic mix, route, limits and metric readers by name, within
the limits of the benchmark's contract; and a cell added by files alone runs."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import spec
from portbench.reference import checks
from portbench.tests.conftest import add_cell, tiny_root

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"] + BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_as_data(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    importlib.import_module(f"portbench.routes.{c.mix['route']}")
    for m in c.per_layer:
        assert callable(importlib.import_module(f"portbench.metrics.{m['name']}").read)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert isinstance(checks.kind(c.limits["check"], c.config, c.mix), checks.Kind)
    assert c.limits["samples"] >= 1


def test_each_config_is_used_and_has_its_own_file():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    assert all(f.startswith("portbench/") for f in files)


def test_a_cell_added_by_files_alone_runs_on_the_cpu(tmp_path):
    import torch

    from portbench import run

    root = tiny_root(tmp_path, rename=lambda c: f"dummy_{c}")
    cell = spec.load_cell("dummy_wave_kershaw64.gmres_gridmg", root)
    result = run.run(cell, 2**33 + 1, 0.3, False, torch.device("cpu"))
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"step_ms", "step_p95_ms", "peak_mem_gib", "setup_s"}
    assert list(result)[-1] == "checks"


def test_a_route_with_no_cell_yet_returns_by_data_alone(tmp_path):
    """The transport GMRES route and its traffic mix stay without a cell (its
    answers miss the configuration's tolerance; PERF.md, Open questions): a
    BENCHMARK.json entry and a limits file bring the cell back."""
    import torch

    from portbench import run

    root = tiny_root(tmp_path)
    name = "transport100.gmres_circulant"
    add_cell(root, {"name": name, "config": "transport100", "traffic": "gmres_circulant",
                    "chips": 1, "why": "returns"},
             {"check": "error", "limit": 1.0, "samples": 2},
             mix=json.loads((REPO / "portbench" / "traffic" / "gmres_circulant.json").read_text()))
    cell = spec.load_cell(name, root)
    assert [m["name"] for m in cell.end_to_end] == ["step_ms", "peak_mem_gib", "setup_s"]
    result = run.run(cell, 2**33 + 2, 0.3, False, torch.device("cpu"))
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
