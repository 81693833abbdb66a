"""WaveSystem_SphericalExplosion explicit driver analog (PyTorch port).

Explicit upwind stepping Uⁿ⁺¹ = Uⁿ − D Uⁿ on the 50×50 square or any ported
mesh, cfl = 1/dim, stationarity ‖dUⁿ‖₂ < 1e-5. On meshes with a gather-free
stencil form the loop runs field-major (state (fm_block, nSites)); on the GPU
its D is kernel K2 on the Kershaw hexahedra and the block-sparse supercell
stencil on the tet meshes. `--shard` (the expl_mpi workload) is not ported.

    python -m circulantpreconditioner_tpu_torch.drivers.wave_explicit 50 50
    python -m circulantpreconditioner_tpu_torch.drivers.wave_explicit --mesh-family kershaw 64 64 64
    python -m circulantpreconditioner_tpu_torch.drivers.wave_explicit --mesh-family tetra 16 16 16
"""

from __future__ import annotations

from circulantpreconditioner_tpu_torch.drivers.common import (
    base_parser,
    build_mesh,
    chunk_of,
    make_output_cb,
    setup_dtype,
)
from circulantpreconditioner_tpu_torch.models import WaveSystem, run_time_loop


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--shard", choices=["none", "slab", "rows"], default="none",
                   help="distributed explicit loop (only 'none' is ported)")
    args = p.parse_args(argv)
    if args.shard != "none":
        raise NotImplementedError(f"--shard {args.shard} needs the distributed SpMV, "
                                  "not ported yet: see ROADMAP.md, slice 3, item 24")
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


if __name__ == "__main__":
    main()
