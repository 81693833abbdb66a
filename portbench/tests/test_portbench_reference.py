"""The plain reference against the port at small sizes on the CPU: the same
operator A = I + D (transport on the wall and periodic cube, the wave system
on a Kershaw mesh, both on a Kershaw-tetra mesh), the same dt, the same cell
centres; and the reference's own solves. The test imports the port; the
reference does not."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench.reference import checks, family
from portbench.reference.operators import implicit_operator

CPU = torch.device("cpu")
MESH = {"cartesian": {"family": "cartesian", "n": [8, 7, 6]},
        "kershaw": {"family": "kershaw", "n": [8, 8, 8], "eps": 0.3},
        "kershawtet": {"family": "kershawtet", "n": [3, 4, 5], "eps": 0.3},
        "kershawtet4": {"family": "kershawtet", "n": [4, 4, 4], "eps": 0.3}}
WAVE = {"model": "wave", "c0": 700.0, "cfl": 1e3 / 3}


def port_model(config, periodic):
    from circulantpreconditioner_tpu_torch.models import TransportEquation, WaveSystem
    from portbench.routes import port_mesh

    mesh = port_mesh(config, periodic)
    if config["model"] == "transport":
        return mesh, TransportEquation(mesh, config["velocity"], cfl=config["cfl"],
                                       device=CPU, dtype=torch.float64)
    return mesh, WaveSystem(mesh, c0=config["c0"], cfl=config["cfl"], device=CPU,
                            dtype=torch.float64)


@pytest.mark.parametrize("config,boundary", [
    ({"model": "transport", "mesh": MESH["cartesian"], "velocity": [1.0, 0.0, 0.0],
      "cfl": 1e3 / 3}, "wall"),
    ({"model": "transport", "mesh": MESH["cartesian"], "velocity": [1.0, 0.0, 0.0],
      "cfl": 1e3 / 3}, "periodic"),
    ({"model": "transport", "mesh": MESH["kershaw"], "velocity": [1.0, 0.5, 0.25],
      "cfl": 0.3}, "wall"),
    ({"model": "wave", "mesh": MESH["kershaw"], "c0": 700.0, "cfl": 1e3 / 3}, "wall"),
    ({"model": "wave", "mesh": MESH["cartesian"], "c0": 700.0, "cfl": 1e3 / 3}, "wall"),
    ({**WAVE, "mesh": MESH["kershawtet"]}, "wall"),
    ({"model": "transport", "mesh": MESH["kershawtet4"], "velocity": [1.0, 0.5, 0.25],
      "cfl": 0.3}, "wall"),
])
def test_operator_equals_the_ports(config, boundary):
    A, dt = implicit_operator(config, boundary)
    mesh, model = port_model(config, boundary == "periodic")
    D = model.divergence.to_scipy()
    Ap = sp.eye(D.shape[0]) + D
    assert dt == pytest.approx(model.dt, rel=1e-13)
    assert abs(A - Ap).max() <= 1e-13 * abs(Ap).max()
    centres = family(config["mesh"]).cell_centres(config["mesh"])
    assert np.abs(centres - mesh.cell_center).max() < 1e-14


@pytest.mark.parametrize("mesh", ["kershaw", "kershawtet"])
def test_implicit_solution_solves_the_system(mesh):
    A, _ = implicit_operator({**WAVE, "mesh": MESH[mesh]}, "wall")
    b = np.random.default_rng(0).standard_normal((A.shape[0], 2))
    x = checks.implicit_solutions(A, b, CPU)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10


def test_direct_chain_is_the_exact_solve():
    config = {"model": "transport", "mesh": MESH["cartesian"], "velocity": [1.0, 0.0, 0.0],
              "cfl": 1e3 / 3}
    A, _ = implicit_operator(config, "periodic")
    b = np.random.default_rng(1).standard_normal((A.shape[0], 2))
    x = checks.direct_chain(A, config["mesh"]["n"], b, 3)
    assert np.linalg.norm(A @ (A @ (A @ x)) - b) / np.linalg.norm(b) < 1e-10


def test_direct_chain_refuses_an_operator_that_is_not_circulant():
    config = {"model": "transport", "mesh": MESH["cartesian"], "velocity": [1.0, 0.0, 0.0],
              "cfl": 1e3 / 3}
    A, _ = implicit_operator(config, "wall")
    with pytest.raises(RuntimeError, match="not circulant"):
        checks.direct_chain(A, config["mesh"]["n"], np.ones((A.shape[0], 1)), 1)


def test_errors_are_relative_norms():
    ref = np.array([[3.0], [4.0]])
    assert checks.errors(np.array([[3.0], [4.5]]), ref) == [pytest.approx(0.1)]


def test_a_family_is_found_by_name():
    assert family(MESH["cartesian"]) is family(MESH["kershaw"])
    assert family(MESH["kershaw"]).__name__ == "portbench.reference.mesh"
    assert family(MESH["kershawtet"]).__name__ == "portbench.reference.families.kershawtet"
    geo = family(MESH["kershawtet"]).geometry(MESH["kershawtet"])
    assert geo.S.shape == (6 * 60, 4, 3) and geo.neighbour.shape == (6 * 60, 4)
    with pytest.raises(ValueError, match="no periodic form"):
        family(MESH["kershawtet"]).geometry(MESH["kershawtet"], periodic=True)
    with pytest.raises(ModuleNotFoundError):
        family({"family": "no_such_family", "n": [2, 2, 2]})
