"""The benchmark as data: BENCHMARK.json at the root of a checkout names the
cells and the metrics; each cell's configuration, traffic mix and limits are
files of their own, found by name. Adding a cell, a configuration or a
per-layer metric adds files and entries and edits none.

- configuration: the `file` of its entry in `configs`;
- traffic mix `<mix>`: `portbench/traffic/<mix>.json`, whose `route` names a
  module `portbench.routes.<route>`;
- per-layer metric `<name>`: a module `portbench.metrics.<name>` with
  `read(ctx)`;
- the limits of cell `<cell>`: `portbench/limits/<cell>.json`, whose
  `check` names a built-in kind or a module `portbench.reference.kinds.<kind>`;
- the reference's geometry of a mesh family: `portbench.reference.family`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list[dict]  # the end-to-end metrics this cell reports
    per_layer: list[dict]  # the per-layer metrics read in this cell


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path | None = None) -> Cell:
    root = ROOT if root is None else root
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"known: {', '.join(sorted(cells))}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text())
    return Cell(workload, int(w["chips"]), config, mix, limits,
                [m for m in bench["end_to_end"] if _reported(m, workload)],
                [m for m in bench["per_layer"] if _reported(m, workload)])
