"""Diffusion (heat equation) driver (PyTorch port): the spherical-explosion
temperature initial condition, stepped by implicit Euler with CG (I + D is
SPD), GMRES, GMRES with the diffusion projection preconditioner, or the FFT
direct solve on a periodic cartesian grid (`--method fft` forces
--periodic).

    python -m circulantpreconditioner_tpu_torch.drivers.diffusion_implicit 64 64 64
    python -m circulantpreconditioner_tpu_torch.drivers.diffusion_implicit 50 50 --method fft
    python -m circulantpreconditioner_tpu_torch.drivers.diffusion_implicit 8 8 8 --mesh-family kershaw --method pc
"""

from __future__ import annotations

from circulantpreconditioner_tpu_torch.drivers.common import (
    base_parser,
    build_mesh,
    chunk_of,
    make_output_cb,
    setup_dtype,
)
from circulantpreconditioner_tpu_torch.models import DiffusionEquation, run_time_loop


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--nu", type=float, default=1.0, help="diffusivity")
    p.add_argument("--method", choices=["cg", "gmres", "pc", "fft"], default="cg")
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--atol", type=float, default=1e-5)
    p.add_argument("--maxits", type=int, default=1000)
    args = p.parse_args(argv)
    device, dtype = setup_dtype(args)
    if args.method == "fft":
        args.periodic = True
    mesh = build_mesh(args)
    model = DiffusionEquation(mesh, nu=args.nu, cfl=args.cfl or 1e3 / mesh.dim, device=device,
                              dtype=dtype)
    print(f"-- implicit diffusion: mesh {mesh.name} ({mesh.n_cells} cells), "
          f"nu={args.nu}, dt={model.dt:.4g}, method={args.method}")

    if args.method == "fft":
        step = model.fft_stepper()
    elif args.method == "pc":
        from circulantpreconditioner_tpu_torch.solvers.circulant_pc import DiffusionProjectionPC

        pc = DiffusionProjectionPC(mesh, model.dt, model.nu, device=device, dtype=dtype)
        step = model.implicit_stepper(M=pc.apply, rtol=args.rtol, atol=args.atol,
                                      maxiter=args.maxits, method="gmres")
    else:
        step = model.implicit_stepper(rtol=args.rtol, atol=args.atol, maxiter=args.maxits,
                                      method=args.method)

    res = run_time_loop(step, model.initial_state(), model.dt, tmax=args.tmax, ntmax=args.ntmax,
                        precision=args.precision, output_freq=args.output_freq,
                        chunk=chunk_of(args),
                        on_output=make_output_cb(args, mesh, prefix="temperature"))
    u = res.state.detach().cpu().numpy()
    print(f"\nEnd at it={res.iterations} t={res.time:.6g} stationary={res.stationary}")
    print(f"temperature range [{u.min():.4f}, {u.max():.4f}], mean {u.mean():.4f}")
    return res


if __name__ == "__main__":
    main()
