"""Shared fixtures of the benchmark's own tests (run them with
`python -m pytest portbench/tests -q`; the `gpu`-marked ones skip without a
card and run on the card with `python -m pytest portbench/tests -q -m gpu`)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = {"transport100": [12, 10, 8], "wave_kershaw64": [8, 8, 8]}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; the test skips itself "
                                       "where there is none")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided in the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_n(config: str, n) -> list[int]:
    """The mesh size of configuration `config` in a tiny tree: TINY's, or
    each axis of `n` cut to at most 6."""
    return TINY.get(config, [min(int(v), 6) for v in n])


def tiny_root(tmp_path: Path, rename=lambda c: c) -> Path:
    """A checkout holding BENCHMARK.json and portbench's data files, every cell
    added by files only: the real configurations at a tiny mesh (`tiny_n`),
    the real traffic mixes with one warm-up request, the real limits."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    data = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir(parents=True)
    configs = []
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["mesh"]["n"] = tiny_n(c["name"], cfg["mesh"]["n"])
        name = rename(c["name"])
        (data / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        configs.append({**c, "name": name, "file": f"portbench/configs/{name}.json",
                        "reduced": ["mesh"]})
    cells = []
    for w in bench["workloads"]:
        name = f"{rename(w['config'])}.{w['traffic']}"
        mix = json.loads((REPO / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        mix["warm_requests"] = 1
        (data / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
        shutil.copy(REPO / "portbench" / "limits" / f"{w['name']}.json",
                    data / "limits" / f"{name}.json")
        cells.append({**w, "name": name, "config": rename(w["config"])})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"{rename(x.split('.')[0])}.{x.split('.', 1)[1]}"
                              for x in m["workloads"]]
    bench.update(configs=configs, workloads=cells)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp_path


def add_cell(root: Path, cell: dict, limits: dict, config: dict | None = None,
             mix: dict | None = None) -> None:
    """Add the BENCHMARK.json entry `cell` to a tiny tree by files alone: its
    limits file and, where given, a new configuration (written at `tiny_n`'s
    size) and its traffic mix."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    data = root / "portbench"
    if config is not None:
        name = cell["config"]
        config = {**config, "mesh": {**config["mesh"],
                                     "n": tiny_n(name, config["mesh"]["n"])}}
        (data / "configs" / f"{name}.json").write_text(json.dumps(config))
        bench["configs"].append({"name": name, "source": "added by files",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": ["mesh"], "why": "added by files"})
    if mix is not None:
        (data / "traffic" / f"{cell['traffic']}.json").write_text(json.dumps(mix))
    (data / "limits" / f"{cell['name']}.json").write_text(json.dumps(limits))
    bench["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
