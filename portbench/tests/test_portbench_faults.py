"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
tiny size, once for each fault the cells can have (no cell has a batch or an
exchange between cards): a step that returns its state unchanged, and an
answer altered where it is produced. The same runs unbroken come out
correct. The control, the reference computed in TF32 (reference/control.py)
put in the route's place, comes out not correct the same way: on the CPU at
the tiny size, and in the gpu-marked test on the card at the cells' sizes.
The same holds for a Kershaw-tetra configuration and for a check kind given
as a module, each added to a tiny tree by files alone; a check kind is
found at set-up, and one that loads a module the benchmark may not load
ends the run without a result."""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, run, spec
from portbench.tests.conftest import add_cell, tiny_root

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
CPU = torch.device("cpu")


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
    from portbench.reference import checks

    check = checks.kind(cell.limits["check"], cell.config, cell.mix)

    def fault(U0, U1):
        x = check.control(U0.double().cpu().numpy()[:, None], U0.device)
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


def cell_major_pbjacobi() -> types.ModuleType:
    """A route as a configuration's own file would bring it:
    drivers/wave_implicit.py --pc pbjacobi on a supercell mesh, whose GMRES
    runs cell-major (the field-major stepper is None there)."""

    def build(config, mix, device):
        from circulantpreconditioner_tpu_torch.models import WaveSystem
        from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
        from portbench.routes import Route, dtype_of, implicit_request, port_mesh

        model = WaveSystem(port_mesh(config, periodic=False), c0=config["c0"],
                           cfl=config["cfl"], device=device, dtype=dtype_of(config))
        g = config["gmres"]
        step = model.implicit_stepper(M=pcs.pbjacobi(model.divergence, shift=1.0),
                                      rtol=g["rtol"], atol=g["atol"], maxiter=g["maxits"],
                                      restart=g["restart"])
        n = int(mix["steps_per_request"])
        return Route(implicit_request(step, model.dt, n), n, step)

    module = types.ModuleType("portbench.routes.cell_major_pbjacobi")
    module.build = build
    return module


@pytest.mark.parametrize("fault", [None, unchanged, altered],
                         ids=["sound", "unchanged", "altered"])
def test_a_kershawtet_configuration_added_by_files_alone(monkeypatch, tmp_path, fault):
    monkeypatch.setitem(sys.modules, "portbench.routes.cell_major_pbjacobi",
                        cell_major_pbjacobi())
    root = tiny_root(tmp_path)
    config = json.loads((REPO / "portbench/configs/wave_kershaw64.json").read_text())
    config.update(name="kershawtet50", mesh={"family": "kershawtet", "n": [50, 50, 50],
                                             "eps": 0.3, "bounds": config["mesh"]["bounds"]})
    mix = json.loads((REPO / "portbench/traffic/gmres_gridmg.json").read_text())
    mix.update(route="cell_major_pbjacobi", pc="pbjacobi", warm_requests=1)
    name = "kershawtet50.gmres_pbjacobi"
    add_cell(root, {"name": name, "config": "kershawtet50", "traffic": "gmres_pbjacobi",
                    "chips": 1, "why": "by files"},
             {"check": "error", "limit": 3e-05, "samples": 4}, config=config, mix=mix)
    cell = spec.load_cell(name, root)
    assert cell.config["mesh"]["n"] == [6, 6, 6]
    result = broken_run(monkeypatch, cell, fault, CPU)
    (check,) = result["checks"].values()
    assert result["correct"] is (fault is None), check
    assert result["attempted"] > 0 and result["failed"] == 0


def max_error_kind() -> types.ModuleType:
    """A check kind as a module of its own: an implicit step's answer judged
    by its largest error against the reference's solve, relative to the
    solve's largest entry; the control is the TF32 GMRES of `error`."""
    from portbench.reference import checks

    def answers(config, mix, u0, device):
        return checks.kind("error", config, mix).answers(u0, device)

    def readings(u1, ref):
        err = np.abs(np.asarray(u1).reshape(ref.shape) - ref).max(axis=0)
        return list(err / np.abs(ref).max(axis=0))

    module = types.ModuleType("portbench.reference.kinds.max_error")
    module.answers, module.readings = answers, readings
    module.control = lambda config, mix, u0, device: checks.kind(
        "error", config, mix).control(u0, device)
    return module


def max_error_root(monkeypatch, tmp_path) -> tuple[Path, str]:
    """A tiny tree whose gridmg cell's limits name the module kind max_error."""
    monkeypatch.setitem(sys.modules, "portbench.reference.kinds.max_error", max_error_kind())
    root = tiny_root(tmp_path)
    name = "wave_kershaw64.gmres_gridmg"
    (root / "portbench" / "limits" / f"{name}.json").write_text(
        json.dumps({"check": "max_error", "limit": 3e-05, "samples": 4}))
    return root, name


@pytest.mark.parametrize("fault", [None, altered, tf32_control],
                         ids=["sound", "altered", "tf32_control"])
def test_a_check_kind_given_as_a_module_is_found_and_judged(monkeypatch, tmp_path, fault):
    root, name = max_error_root(monkeypatch, tmp_path)
    result = broken_run(monkeypatch, spec.load_cell(name, root), fault, CPU)
    ((check_name, check),) = result["checks"].items()
    assert check_name == "max_error_max"
    assert result["correct"] is (fault is None), check


def test_the_control_readings_of_a_module_kind(monkeypatch, tmp_path, capsys):
    root, name = max_error_root(monkeypatch, tmp_path)
    monkeypatch.setattr(spec, "ROOT", root)
    assert control.main(["--workload", name, "--seeds", "5", "6", "--requests", "1",
                         "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["check"] == "max_error"
    assert summary["program_max"] <= 3e-05 < summary["control_min"]


def test_a_check_kind_is_found_before_the_window(monkeypatch, tmp_path):
    """A limits file naming a kind with no module stops the run at set-up,
    before the route is built."""
    root = tiny_root(tmp_path)
    name = "wave_kershaw64.gmres_gridmg"
    (root / "portbench" / "limits" / f"{name}.json").write_text(
        json.dumps({"check": "no_such_kind", "limit": 3e-05, "samples": 4}))
    cell = spec.load_cell(name, root)
    module = __import__(f"portbench.routes.{cell.mix['route']}", fromlist=["build"])
    monkeypatch.setattr(module, "build", lambda *a: pytest.fail("the route was built"))
    with pytest.raises(ModuleNotFoundError, match="no_such_kind"):
        run.run(cell, 2**32 + 19, 0.2, False, CPU)


def test_a_forbidden_module_loaded_by_the_reference_refuses_the_run(monkeypatch, tmp_path):
    """A check kind that loads a module the benchmark may not load, after the
    window has closed, still ends the run without a result."""
    root, name = max_error_root(monkeypatch, tmp_path)
    kind = sys.modules["portbench.reference.kinds.max_error"]
    answers = kind.answers

    def loading_flax(*args):
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
        return answers(*args)

    monkeypatch.setattr(kind, "answers", loading_flax)
    with pytest.raises(SystemExit, match="flax"):
        broken_run(monkeypatch, spec.load_cell(name, root), None, CPU)
