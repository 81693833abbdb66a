"""Routes through the port: `portbench.routes.<route>.build(config, mix,
device)` builds a route from the port's public API as the port's driver
builds it, and returns a `Route`. Calling the route runs one request: the
port's time loop (`models/runner.run_time_loop`) over the route's stepper
from the given flat cell-major state, with stationarity and tmax off and
`ntmax` the request's steps. It returns the flat cell-major state, the
Krylov iterations of each step (empty for a direct solve) and whether every
solve converged.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

# tmax off: run_time_loop's chunked loop takes int((tmax − t)/dt), so a
# finite number that no simulation reaches
NO_TMAX = 1e30


class Route:
    """`route(U0)` runs one request of `steps` time steps."""

    def __init__(self, request: Callable, steps: int, stepper):
        self._request = request
        self.steps = int(steps)
        self.stepper = stepper

    def __call__(self, U0: torch.Tensor) -> tuple[torch.Tensor, list[int], bool]:
        return self._request(U0)

    def release(self) -> None:
        """Drop a captured stepper's graphs, and the references that keep the
        model, the solver and their buffers alive."""
        if hasattr(self.stepper, "release"):
            self.stepper.release()
        self._request = self.stepper = None


def capture_gmres_finishes(stepper) -> None:
    """Capture the finish graph of every final inner index 1 … restart of
    each GMRES solver that the stepper (a model's implicit stepper, which
    closes over its solver) has already run. A request's last restart cycle
    ends at an index that the warm-up requests may not have reached, and that
    index's graph would otherwise be captured, and its memory taken, inside
    the window. The finishes run on the solver's leftover buffers, which
    every solve sets afresh."""
    from circulantpreconditioner_tpu_torch.solvers.gmres import GMRES

    for cell in getattr(stepper, "__closure__", None) or ():
        try:
            solver = cell.cell_contents
        except ValueError:  # an empty cell
            continue
        if not isinstance(solver, GMRES) or solver._key is None:
            continue
        for j in range(1, solver.m + 1):
            solver.graphs.run(("finish", j), functools.partial(solver._finish, j))


def port_mesh(config: dict, periodic: bool):
    """The port's mesh of the configuration, from its public generators."""
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.mesh.unstructured import (
        kershaw_mesh,
        kershaw_tet_mesh,
    )

    mesh = config["mesh"]
    bounds = tuple(tuple(b) for b in mesh.get("bounds", ((-0.5, 0.5),) * 3))
    n = tuple(int(v) for v in mesh["n"])
    if mesh["family"] == "cartesian":
        return cartesian_mesh(bounds, n, periodic=periodic)
    if periodic:
        raise ValueError("only a cartesian mesh is periodic")
    if mesh["family"] == "kershaw":
        return kershaw_mesh(bounds, n, eps=float(mesh["eps"]))
    if mesh["family"] == "kershawtet":
        return kershaw_tet_mesh(bounds, n, eps=float(mesh["eps"]))
    raise ValueError(f"unknown mesh family {mesh['family']!r}")


def dtype_of(config: dict) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[config["dtype"]]


def implicit_request(step, dt: float, steps: int, pack=None, unpack=None):
    """A request of `steps` implicit steps, one host synchronisation each (the
    drivers' default chunk of 1)."""
    from circulantpreconditioner_tpu_torch.models import run_time_loop

    def request(U0):
        res = run_time_loop(step, pack(U0) if pack else U0, dt, tmax=NO_TMAX, ntmax=steps,
                            precision=0.0, output_freq=1, log=None, chunk=1)
        extras = [d["extras"] for d in res.diagnostics]
        state = unpack(res.state) if unpack else res.state
        return state, [int(e[0]) for e in extras], all(bool(e[2]) for e in extras)

    return request
