"""drivers/transport_implicit.py on a cartesian grid: GMRES right with the
dense circulant solve as preconditioner (--pc circulant), restart 30, at the
precision tier `precision` ("high": K4 in bf16×3)."""

from __future__ import annotations

from portbench.routes import Route, dtype_of, implicit_request, port_mesh


def build(config: dict, mix: dict, device) -> Route:
    from circulantpreconditioner_tpu_torch.models import TransportEquation
    from circulantpreconditioner_tpu_torch.ops.spectral_collapse import make_circulant_solver

    if mix["pc"] != "circulant":
        raise ValueError(f"transport_gmres takes pc 'circulant', got {mix['pc']!r}")
    dtype = dtype_of(config)
    mesh = port_mesh(config, periodic=mix["boundary"] == "periodic")
    model = TransportEquation(mesh, config["velocity"], cfl=config["cfl"], device=device,
                              dtype=dtype)
    op = model.fft_operator
    M = make_circulant_solver(op.shape_zyx, op.lambdas_zyx, device=device, dtype=dtype,
                              precision=mix["precision"]).as_preconditioner()
    g = config["gmres"]
    step = model.implicit_stepper(M=M, rtol=g["rtol"], atol=g["atol"], maxiter=g["maxits"],
                                  restart=g["restart"], side="right")
    return Route(implicit_request(step, model.dt, mix["steps_per_request"]),
                 mix["steps_per_request"], step)
