"""drivers/transport_fft.py: the periodic grid's direct circulant solve
(`fft_stepper(method)`, a captured step), `steps_per_request` steps per host
synchronisation (--output-freq), one graph replay per request."""

from __future__ import annotations

from portbench.routes import NO_TMAX, Route, dtype_of, port_mesh


def build(config: dict, mix: dict, device) -> Route:
    from circulantpreconditioner_tpu_torch.models import TransportEquation, run_time_loop

    if mix["boundary"] != "periodic":
        raise ValueError("the direct circulant solve is periodic")
    mesh = port_mesh(config, periodic=True)
    model = TransportEquation(mesh, config["velocity"], cfl=config["cfl"], device=device,
                              dtype=dtype_of(config))
    step = model.fft_stepper(method=mix["method"])
    n = int(mix["steps_per_request"])

    def request(U0):
        res = run_time_loop(step, U0, model.dt, tmax=NO_TMAX, ntmax=n, precision=0.0,
                            output_freq=n, log=None, chunk=n)
        return res.state, [], True

    return Route(request, n, step)
