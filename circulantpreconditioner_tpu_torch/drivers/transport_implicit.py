"""TransportEquation_SphericalExplosion implicit GMRES driver analog (PyTorch
port): implicit transport solved with GMRES, per-solve wall time printed;
--pc none|jacobi|circulant. On a structured mesh --pc circulant is the
circulant solve of the grid; on another mesh (hexa, Kershaw) it is the
additive two-level PC: the circulant projection PC
(solvers/circulant_pc.py) plus Jacobi, right-preconditioned.

    python -m circulantpreconditioner_tpu_torch.drivers.transport_implicit 100 100 100 --pc circulant
    python -m circulantpreconditioner_tpu_torch.drivers.transport_implicit --mesh-family kershaw 32 32 32 --pc circulant
"""

from __future__ import annotations

import functools

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
    p.add_argument("--pc", choices=["none", "jacobi", "circulant"], default="none")
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--atol", type=float, default=1e-5)
    p.add_argument("--maxits", type=int, default=1000)
    args = p.parse_args(argv)
    device, dtype = setup_dtype(args)
    mesh = build_mesh(args)
    dim = mesh.dim
    velocity = [0.0] * dim
    velocity[0] = 1.0
    model = TransportEquation(mesh, velocity, cfl=args.cfl or 1e3 / dim, device=device,
                              dtype=dtype)

    M = None
    side = "left"
    if args.pc == "jacobi":
        from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs

        dinv = 1.0 / (model.divergence.diagonal() + 1.0)
        M = functools.partial(pcs._diag_apply, dinv)
    elif args.pc == "circulant" and not mesh.is_structured:
        from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
        from circulantpreconditioner_tpu_torch.solvers.circulant_pc import CirculantProjectionPC

        # additive two-level: the projected circulant (rank-deficient alone)
        # plus Jacobi, converging on the true residual
        coarse = CirculantProjectionPC(mesh, model.velocity, model.dt, device=device,
                                       dtype=dtype)
        dinv = 1.0 / (model.divergence.diagonal() + 1.0)
        M = pcs.additive(coarse.apply, functools.partial(pcs._diag_apply, dinv))
        side = "right"
    elif args.pc == "circulant":
        # periodic grid: the exact inverse (1 GMRES iteration); wall/Neumann
        # grid: it differs from the operator only on the boundary-face layer
        # (3 GMRES iterations meet rtol on the estimate; in float32 at "high"
        # the true residual forces one more cycle: 6 iterations at 100³ on an
        # H100). make_circulant_solver picks the exact formulation for the λ
        # pattern (one dense matmul for a = (1,0,0)).
        from circulantpreconditioner_tpu_torch.ops.spectral_collapse import (
            make_circulant_solver,
        )

        op = model.fft_operator
        M = make_circulant_solver(op.shape_zyx, op.lambdas_zyx, device=device, dtype=dtype,
                                  precision="high").as_preconditioner()
        side = "right"  # true-residual convergence (PC is approximate)

    step = model.implicit_stepper(M=M, rtol=args.rtol, atol=args.atol, maxiter=args.maxits,
                                  side=side)
    print(f"-- implicit transport: mesh {mesh.name} ({mesh.n_cells} cells), "
          f"dt={model.dt:.4g}, pc={args.pc}")
    res = run_time_loop(
        step, model.initial_state(), model.dt, tmax=args.tmax, ntmax=args.ntmax,
        precision=args.precision, output_freq=args.output_freq,
        chunk=chunk_of(args),
        on_output=make_output_cb(args, mesh, prefix="temperature"),
    )
    u = res.state.cpu().numpy()
    its = [d["extras"][0] for d in res.diagnostics if d["extras"]]
    print(f"\nEnd at it={res.iterations} t={res.time:.6g} stationary={res.stationary}")
    print(f"temperature range [{u.min():.4f}, {u.max():.4f}]")
    if its:
        print(f"GMRES iterations per step: median {np.median(its):.0f}, max {np.max(its):.0f}")
    return res


if __name__ == "__main__":
    main()
