"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
tiny size, once for each fault the cells can have (no cell has a batch or an
exchange between cards): a step that returns its state unchanged, and an
answer altered where it is produced. The same runs unbroken come out
correct. The control, the reference computed in TF32 (reference/control.py)
put in the route's place, comes out not correct the same way: on the CPU at
the tiny size, and in the gpu-marked test on the card at the cells' sizes."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run, spec
from portbench.tests.conftest import tiny_root

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def unchanged(cell):
    return lambda U0, U1: U0.clone()


def altered(cell):
    def fault(U0, U1):
        U1 = U1.clone()
        U1[0] += 0.1 * U1.abs().max()
        return U1

    return fault


def tf32_control(cell):
    """The route's answer replaced by the TF32 control's answer to the same
    request."""
    from portbench.reference.control import control_answers
    from portbench.reference.operators import implicit_operator

    A, _ = implicit_operator(cell.config, cell.mix["boundary"])

    def fault(U0, U1):
        x = control_answers(cell.limits["check"], A, U0.double().cpu().numpy()[:, None],
                            int(cell.mix["steps_per_request"]),
                            gmres_cfg=cell.config.get("gmres"),
                            shape_xyz=cell.config["mesh"]["n"], device=U0.device)
        return torch.as_tensor(x[:, 0], dtype=U1.dtype, device=U1.device)

    return fault


def broken_run(monkeypatch, cell, make_fault, device, seconds=0.2):
    module = __import__(f"portbench.routes.{cell.mix['route']}", fromlist=["build"])
    build = module.build

    def build_broken(config, mix, device):
        route = build(config, mix, device)
        if make_fault is not None:
            inner, fault = route._request, make_fault(cell)

            def request(U0):
                U1, iters, ok = inner(U0)
                return fault(U0, U1), iters, ok

            route._request = request
        return route

    monkeypatch.setattr(module, "build", build_broken)
    return run.run(cell, 2**32 + 17, seconds, False, device)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, unchanged, altered, tf32_control],
                         ids=["sound", "unchanged", "altered", "tf32_control"])
def test_a_broken_step_is_not_correct(monkeypatch, tmp_path, cell, fault):
    result = broken_run(monkeypatch, spec.load_cell(cell, tiny_root(tmp_path)), fault,
                        torch.device("cpu"))
    (check,) = result["checks"].values()
    assert result["correct"] is (fault is None), check
    assert (check["value"] <= check["limit"]) is (fault is None)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct_on_the_card(monkeypatch, card, cell):
    """At the cell's own size, one warm-up request and a window of one or two:
    under a minute a cell."""
    c = spec.load_cell(cell)
    c.mix["warm_requests"] = 1
    result = broken_run(monkeypatch, c, tf32_control, card)
    (check,) = result["checks"].values()
    assert result["correct"] is False, check
    assert check["value"] > check["limit"]


def test_fault_changes_only_what_it_says():
    U0, U1 = torch.zeros(4), torch.arange(4.0)
    assert torch.equal(unchanged(None)(U0, U1), U0)
    assert np.count_nonzero((altered(None)(U0, U1) - U1).numpy()) == 1
