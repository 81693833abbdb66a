"""TransportEquationFFT_SphericalExplosion driver analog (PyTorch port).

Implicit transport on a cartesian grid, each step solved DIRECTLY by the
circulant FFT solver; a=(1,0,...), cfl=1e3/dim, tmax=0.05, stationarity 1e-5.

    python -m circulantpreconditioner_tpu_torch.drivers.transport_fft 100 100 100
"""

from __future__ import annotations

import numpy as np

from circulantpreconditioner_tpu_torch.drivers.common import (
    base_parser,
    build_mesh,
    chunk_of,
    make_output_cb,
    setup_dtype,
)
from circulantpreconditioner_tpu_torch.models import TransportEquation, run_time_loop


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--method", choices=["auto", "fft", "matmul"], default="auto")
    p.add_argument("--shard", choices=["none", "slab", "pencil"], default="none",
                   help="distributed solve (only 'none' is ported)")
    args = p.parse_args(argv)
    if args.shard != "none":
        raise NotImplementedError(f"--shard {args.shard} needs the distributed FFT solvers, "
                                  "not ported yet: see ROADMAP.md, slice 3, item 24")
    device, dtype = setup_dtype(args)
    args.periodic = True  # the FFT direct solve is inherently periodic
    mesh = build_mesh(args)
    if not mesh.is_structured:
        raise SystemExit("transport_fft requires a cartesian mesh (use transport_implicit)")
    dim = mesh.dim
    velocity = [0.0] * dim
    velocity[0] = 1.0  # reference: vitesseTransport=(1,0,0)
    model = TransportEquation(mesh, velocity, cfl=args.cfl or 1e3 / dim, device=device,
                              dtype=dtype)
    print(f"-- FFT transport: mesh {mesh.name}, dt={model.dt:.4g}, "
          f"lambdas={model.fft_operator.lambdas_zyx}")
    step = model.fft_stepper(method=args.method)
    res = run_time_loop(
        step, model.initial_state(), model.dt, tmax=args.tmax, ntmax=args.ntmax,
        precision=args.precision, output_freq=args.output_freq,
        chunk=chunk_of(args),
        on_output=make_output_cb(args, mesh, prefix="temperature"),
    )
    u = res.state.cpu().numpy()
    print(f"\nEnd at it={res.iterations} t={res.time:.6g} stationary={res.stationary}")
    print(f"temperature range [{u.min():.4f}, {u.max():.4f}], mean {u.mean():.4f}")
    if res.step_seconds:
        print(f"median solve wall: {np.median(res.step_seconds)*1e3:.3f} ms")
    return res


if __name__ == "__main__":
    main()
