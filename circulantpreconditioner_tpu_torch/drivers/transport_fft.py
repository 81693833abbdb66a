"""TransportEquationFFT_SphericalExplosion driver analog (PyTorch port).

Implicit transport on a cartesian grid, each step solved DIRECTLY by the
circulant FFT solver; a=(1,0,...), cfl=1e3/dim, tmax=0.05, stationarity 1e-5.
`--shard slab|pencil` is the _mpi driver: the solve split over ranks, one
process per device (parallel/fft_dist.py). Every step is a captured step:
CUDA graphs on the card, the all-to-alls inside.

    python -m circulantpreconditioner_tpu_torch.drivers.transport_fft 100 100 100
    torchrun --nproc-per-node 4 -m circulantpreconditioner_tpu_torch.drivers.transport_fft \
        64 64 64 --shard pencil --pq 2 2
"""

from __future__ import annotations

import numpy as np

import torch

from circulantpreconditioner_tpu_torch.drivers.common import (
    base_parser,
    build_mesh,
    chunk_of,
    make_output_cb,
    make_sharded_output_cb,
    rank0_print,
    setup_dtype,
)
from circulantpreconditioner_tpu_torch.models import TransportEquation, run_time_loop
from circulantpreconditioner_tpu_torch.utils.graphs import CapturedStep


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--method", choices=["auto", "fft", "matmul"], default="auto")
    p.add_argument("--shard", choices=["none", "slab", "pencil"], default="none",
                   help="distributed solve over the ranks (the _mpi analog)")
    args = p.parse_args(argv)
    if args.shard != "none":
        return _main_sharded(args)
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


def _main_sharded(args):
    """The slab (--shard slab) or pencil (--shard pencil, --pq p q) solve,
    one rank per device: each rank steps its block, ‖ΔU‖₂ is reduced over
    the ranks, and res.state is the gathered (nz, ny, nx) field."""
    import torch.distributed as dist

    from circulantpreconditioner_tpu_torch.parallel import (
        PencilCirculantSolver,
        SlabCirculantSolver,
        device_mesh,
        device_mesh_2d,
        rank_world,
    )

    args.periodic = True
    mesh = build_mesh(args)
    if not mesh.is_structured:
        raise SystemExit("transport_fft requires a cartesian mesh (use transport_implicit)")
    if mesh.dim != 3:
        raise SystemExit("--shard needs a 3D grid")
    if args.shard == "pencil" and args.pq:
        # before any rank starts: the grid must tile over the pencil mesh
        PencilCirculantSolver.check_shape(tuple(reversed(mesh.structured_shape)), *args.pq)
    with rank_world(args.devices, args.device):
        log = rank0_print()
        say = log or (lambda *a, **k: None)
        device, dtype = setup_dtype(args)
        model = TransportEquation(mesh, [1.0, 0.0, 0.0], cfl=args.cfl or 1e3 / 3,
                                  device=device, dtype=dtype)
        op = model.fft_operator
        say(f"-- FFT transport: mesh {mesh.name}, dt={model.dt:.4g}, "
            f"lambdas={op.lambdas_zyx}")
        if args.shard == "slab":
            dm = device_mesh(args.devices)
            solver = SlabCirculantSolver.from_operator(op, dm)
        else:
            n = args.devices or dist.get_world_size()
            pq = tuple(args.pq) if args.pq else (max(n // 2, 1), 2 if n >= 2 else 1)
            dm = device_mesh_2d(pq)
            solver = PencilCirculantSolver.from_operator(op, dm)
        say(f"-- sharded over {dm.shape} devices ({args.shard})")

        def local_step(u):
            u1 = solver.solve(u)
            return u1, torch.linalg.norm(u1 - u)  # this rank's part of ‖ΔU‖₂

        # the JAX package's jitted shard_map solve: the all-to-alls and the
        # global norms inside the step's graphs
        step = CapturedStep(local_step)
        res = run_time_loop(
            step, solver.shard(model.initial_state()), model.dt, tmax=args.tmax,
            ntmax=args.ntmax, precision=args.precision, output_freq=args.output_freq,
            chunk=chunk_of(args), log=log, global_norms=dm.global_norms,
            on_output=make_sharded_output_cb(args, mesh, solver.unshard, dm.device,
                                             prefix="temperature"),
        )
        step.release()  # NCCL destroys no communicator that a live graph holds
        res.state = solver.unshard(res.state)
        u = res.state.cpu().numpy()
        say(f"\nEnd at it={res.iterations} t={res.time:.6g} stationary={res.stationary}")
        say(f"temperature range [{u.min():.4f}, {u.max():.4f}], mean {u.mean():.4f}")
        if res.step_seconds:
            say(f"median solve wall: {np.median(res.step_seconds)*1e3:.3f} ms")
    return res


if __name__ == "__main__":
    main()
