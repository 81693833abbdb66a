"""WaveSystem_SphericalExplosion explicit driver analog (PyTorch port).

Explicit upwind stepping Uⁿ⁺¹ = Uⁿ − D Uⁿ on the 50×50 square or any ported
mesh, cfl = 1/dim, stationarity ‖dUⁿ‖₂ < 1e-5. On meshes with a gather-free
stencil form the loop runs field-major (state (fm_block, nSites)); on the GPU
its D is kernel K2 on the Kershaw hexahedra and K7, the supercell normal
form, on the tet meshes. `--shard` runs the expl_mpi workload, one process
per device: the distributed MatMult loop (:90-135) with a z-slab stencil and
plane halos (slab, topologically structured meshes) or a row-sharded ELL
SpMV (rows, any mesh), ‖ΔU‖₂ reduced over the ranks, and the output gathered
to rank 0 (VecScatterCreateToZero, :51,134-135). Every step, sharded or not,
is a captured step: CUDA graphs on the card, the collectives inside.

    python -m circulantpreconditioner_tpu_torch.drivers.wave_explicit 50 50
    python -m circulantpreconditioner_tpu_torch.drivers.wave_explicit --mesh-family kershaw 64 64 64
    python -m circulantpreconditioner_tpu_torch.drivers.wave_explicit --mesh-family tetra 16 16 16
    torchrun --nproc-per-node 4 -m circulantpreconditioner_tpu_torch.drivers.wave_explicit \
        --mesh-family kershaw 64 64 64 --shard slab
"""

from __future__ import annotations

import torch

from circulantpreconditioner_tpu_torch.drivers.common import (
    base_parser,
    build_mesh,
    chunk_of,
    make_output_cb,
    make_sharded_output_cb,
    rank0_print,
    setup_dtype,
    sharded_rows,
)
from circulantpreconditioner_tpu_torch.models import WaveSystem, run_time_loop
from circulantpreconditioner_tpu_torch.utils.graphs import CapturedStep


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--shard", choices=["none", "slab", "rows"], default="none",
                   help="distribute the explicit MatMult loop over the ranks: 'slab' = "
                        "z-slab stencil with plane halos (topologically structured "
                        "meshes), 'rows' = row-sharded ELL SpMV (any mesh)")
    args = p.parse_args(argv)
    if args.shard != "none":
        return _main_sharded(args)
    device, dtype = setup_dtype(args)
    mesh = build_mesh(args)
    model = WaveSystem(mesh, cfl=args.cfl or 1.0 / mesh.dim, device=device, dtype=dtype)
    print(f"-- explicit wave: mesh {mesh.name} ({mesh.n_cells} cells), dt={model.dt:.4g}")

    # field-major loop when the mesh has a gather-free stencil form: the
    # (N,m)↔(m,N) relayouts are paid at the I/O boundaries only
    step_fm = model.explicit_stepper_fm()
    cb = make_output_cb(args, mesh, split=model.split_fields, prefix="wave")
    if step_fm is not None:
        print("-- field-major stencil loop")
        res = run_time_loop(
            step_fm, model.pack_fm(model.initial_state()), model.dt,
            tmax=args.tmax, ntmax=args.ntmax, precision=args.precision,
            output_freq=args.output_freq, chunk=chunk_of(args),
            on_output=lambda it, t, G, ex: cb(it, t, model.unpack_fm(G), ex),
        )
        res.state = model.unpack_fm(res.state)
    else:
        res = run_time_loop(
            model.explicit_stepper(), model.initial_state(), model.dt, tmax=args.tmax,
            ntmax=args.ntmax, precision=args.precision, output_freq=args.output_freq,
            chunk=chunk_of(args), on_output=cb,
        )
    pfin, _ = model.split_fields(res.state)
    print(f"\nEnd at it={res.iterations} t={res.time:.6g} stationary={res.stationary}")
    print(f"pressure range [{pfin.min():.6g}, {pfin.max():.6g}]")
    return res


def _make_sharded_operator(args, mesh, model, dm, dtype, say):
    """The distributed D: the slab stencil (plane halos) on a topologically
    structured mesh, else the row-sharded ELL (drivers/common.sharded_rows)."""
    from circulantpreconditioner_tpu_torch.ops.stencil import VaryingStencilOperator
    from circulantpreconditioner_tpu_torch.parallel import SlabStencilOperator

    if args.shard == "slab":
        V = VaryingStencilOperator.from_bsr(model.divergence, mesh.topology_shape)
        S = SlabStencilOperator(V, dm)
        say(f"-- z-slab sharded over {dm.shape} devices (plane halos, layout {V.layout})")
        return S
    As, kind = sharded_rows(model.divergence, dm, dtype)
    say(f"-- row-sharded over {dm.shape} devices: {kind} SpMV "
        f"(n={As.n}, padded {As.n_padded})")
    return As


def _main_sharded(args):
    """The WaveSystem_..._expl_mpi.cxx analog: every step is one distributed
    MatMult and AXPY (:90-91), the stationarity norm a global reduction
    (:96-97); res.state is the gathered flat cell-major state."""
    from circulantpreconditioner_tpu_torch.parallel import device_mesh, rank_world

    mesh = build_mesh(args)
    if args.shard == "slab" and getattr(mesh, "topology_shape", None) is None:
        raise SystemExit("--shard slab needs a topologically structured mesh")
    with rank_world(args.devices, args.device):
        log = rank0_print()
        say = log or (lambda *a, **k: None)
        device, dtype = setup_dtype(args)
        model = WaveSystem(mesh, cfl=args.cfl or 1.0 / mesh.dim, device=device, dtype=dtype)
        say(f"-- explicit wave: mesh {mesh.name} ({mesh.n_cells} cells), dt={model.dt:.4g}")
        dm = device_mesh(args.devices)
        Aop = _make_sharded_operator(args, mesh, model, dm, dtype, say)

        def local_step(u):
            du = Aop.matvec(u)
            return u - du, torch.linalg.norm(du.reshape(-1))  # this rank's part of ‖ΔU‖₂

        # the JAX driver's jitted step: its halo exchange and the global norms
        # inside the step's graphs
        step = CapturedStep(local_step)
        res = run_time_loop(
            step, Aop.shard_vector(model.initial_state()), model.dt, tmax=args.tmax,
            ntmax=args.ntmax, precision=args.precision, output_freq=args.output_freq,
            chunk=chunk_of(args), log=log, global_norms=dm.global_norms,
            on_output=make_sharded_output_cb(args, mesh, Aop.unshard_vector, dm.device,
                                             split=model.split_fields, prefix="wave"),
        )
        step.release()  # NCCL destroys no communicator that a live graph holds
        res.state = Aop.unshard_vector(res.state)
        pfin, _ = model.split_fields(res.state)
        say(f"\nEnd at it={res.iterations} t={res.time:.6g} stationary={res.stationary}")
        say(f"pressure range [{pfin.min():.6g}, {pfin.max():.6g}]")
    return res


if __name__ == "__main__":
    main()
