"""`routes.capture_gmres_finishes` runs the finish of every final inner
index of the GMRES solver inside a route's stepper, and a request after it
gives the same answer to the bit as before it: the finishes run on leftover
buffers that every solve sets afresh. On the card those finishes are
captured in set-up, so that no graph is captured inside the window."""

from __future__ import annotations

import importlib

import pytest
import torch

from portbench import spec, traffic
from portbench.reference import family
from portbench.routes import capture_gmres_finishes, dtype_of
from portbench.tests.conftest import tiny_root

CPU = torch.device("cpu")


@pytest.mark.parametrize("workload", ["wave_kershaw64.gmres_gridmg",
                                      "wave_kershaw64.gmres_dct2lm"])
def test_capture_gmres_finishes_runs_every_finish_and_changes_no_answer(
        tmp_path, monkeypatch, workload):
    from circulantpreconditioner_tpu_torch.solvers.gmres import GMRES

    cell = spec.load_cell(workload, tiny_root(tmp_path))
    route = importlib.import_module(f"portbench.routes.{cell.mix['route']}").build(
        cell.config, cell.mix, CPU)
    mesh = cell.config["mesh"]
    make = traffic.StateMaker(cell.config, family(mesh).cell_centres(mesh), CPU,
                              dtype_of(cell.config))
    U0 = make(*traffic.Requests(cell.mix, cell.config, 2**33 + 5, traffic.WINDOW).next())
    before, iters, ok = route(U0)
    assert ok and sum(iters) > 0

    finished = []
    finish = GMRES._finish

    def recorded(self, j):
        finished.append(j)
        return finish(self, j)

    monkeypatch.setattr(GMRES, "_finish", recorded)
    capture_gmres_finishes(route.stepper)
    restart = cell.config["gmres"]["restart"]
    assert finished == list(range(1, restart + 1))

    after, iters_after, ok_after = route(U0)
    assert ok_after and iters_after == iters
    assert torch.equal(after, before)


def test_capture_gmres_finishes_leaves_a_direct_route_alone(tmp_path):
    cell = spec.load_cell("transport100.direct_fft", tiny_root(tmp_path))
    route = importlib.import_module(f"portbench.routes.{cell.mix['route']}").build(
        cell.config, cell.mix, CPU)
    capture_gmres_finishes(route.stepper)  # no GMRES inside: nothing to run, nothing raised
