"""WaveSystem_SphericalExplosion implicit driver analog (PyTorch port).

Implicit (I + D)Uⁿ⁺¹ = Uⁿ by GMRES, cfl = 1e3/dim, tol 1e-5, maxits 1000.
Preconditioners:

- ilu0 (the default, the reference's sequential solver): ILU(0) of I + D;
  bjacobi (the reference's MPI solver): ILU(0) of --n-blocks contiguous
  diagonal blocks;
- none, pbjacobi;
- gridmg: the geometric-Galerkin grid V-cycle (meshes whose topology is a
  grid; on the tet meshes its first level aggregates each hex's 6 tets);
- aggvcycle: the algebraic aggregation V-cycle (any mesh);
- circulant2l, dct2l: the additive two-level projection PCs, the periodic
  block-circulant or the wall DCT/DST cartesian solve plus point-block
  Jacobi; dct2lm: the multiplicative DCT two-level cycle;
- blockfft, dctfft: the direct block-circulant (periodic cartesian grid) or
  DCT/DST (wall cartesian grid) solve in place of GMRES.

The two-level and V-cycle PCs precondition from the right, the others from
the left. For none, pbjacobi, gridmg and the projection PCs, where the mesh
has a gather-free stencil form, the loop runs field-major, and on the GPU its
matvec (and the grid V-cycle's fine level, and dct2lm's second operator
apply) is kernel K2. ilu0, bjacobi and aggvcycle run the cell-major loop, as
in the JAX driver: they have no field-major form. On the tet meshes
(--mesh-family tetra|kershawtet) the field view groups the 6 cells of a site,
(24, nSites): GMRES's matvec is the supercell normal form (kernel K7 on the
GPU), gridmg's V-cycle runs its field-major apply from the site level down,
pbjacobi takes the site's 6 blocks, and the projection PCs' cell-major
coarse solve is wrapped by one relayout of that view. The JAX driver runs cell-major over
the dense supercell stencil (M = 24) there.

`--shard rows` is the impl_mpi workload, one process per device: GMRES over
row-sharded vectors (its norms and projections all-reduced over the ranks)
with the halo ELL SpMV, or the halo window SpMV on RCM-ordered meshes, and
--pc none, pbjacobi or circulant2l (the distributed projection PC,
parallel/pc_dist.py).

    python -m circulantpreconditioner_tpu_torch.drivers.wave_implicit 32 32 32
    python -m circulantpreconditioner_tpu_torch.drivers.wave_implicit --mesh-family kershaw 64 64 64 --pc dct2lm
    python -m circulantpreconditioner_tpu_torch.drivers.wave_implicit --mesh-family kershawtet 16 16 16 --pc gridmg
    torchrun --nproc-per-node 4 -m circulantpreconditioner_tpu_torch.drivers.wave_implicit \
        --mesh-family kershaw 64 64 64 --shard rows --pc circulant2l
"""

from __future__ import annotations

import numpy as np

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
from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs

# preconditioners with no field-major form: the cell-major loop only
CELL_MAJOR_ONLY = ("ilu0", "bjacobi", "aggvcycle")


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--pc", choices=["none", "pbjacobi", "ilu0", "bjacobi", "blockfft",
                                    "dctfft", "circulant2l", "dct2l", "dct2lm",
                                    "gridmg", "aggvcycle"],
                   default="ilu0")
    p.add_argument("--n-blocks", type=int, default=4, help="bjacobi partition count")
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--atol", type=float, default=1e-5)
    p.add_argument("--maxits", type=int, default=1000)
    p.add_argument("--shard", choices=["none", "rows"], default="none",
                   help="row-sharded SpMV and GMRES over the ranks (the impl_mpi "
                        "analog; --pc none|pbjacobi|circulant2l)")
    args = p.parse_args(argv)
    if args.shard == "rows":
        return _main_sharded(args)
    device, dtype = setup_dtype(args)
    mesh = build_mesh(args)
    model = WaveSystem(mesh, cfl=args.cfl or 1e3 / mesh.dim, device=device, dtype=dtype)
    print(f"-- implicit wave: mesh {mesh.name} ({mesh.n_cells} cells), "
          f"dt={model.dt:.4g}, pc={args.pc}")

    side = ("right" if args.pc in ("circulant2l", "dct2l", "dct2lm", "gridmg", "aggvcycle")
            else "left")
    gmres_kw = dict(rtol=args.rtol, atol=args.atol, maxiter=args.maxits, side=side)
    fm = False
    if args.pc == "blockfft":
        step = model.block_fft_stepper()  # direct solve, no GMRES
    elif args.pc == "dctfft":
        step, fm = model.dct_fft_stepper_fm(), True  # direct solve, no GMRES
    elif args.pc in CELL_MAJOR_ONLY:
        # implicit_stepper_fm(M_cm=None, M_fm=None) would run GMRES with no
        # preconditioner: these never try the field-major loop
        step = model.implicit_stepper(M=_cell_major_pc(args, model, dtype), **gmres_kw)
    else:
        M_cm, M_fm, make_M_cm = _preconditioners(args, mesh, model, device, dtype)
        # the field-major loop where the mesh has a gather-free stencil form;
        # the cell-major preconditioner is built only in the fallback
        step = model.implicit_stepper_fm(M_cm=M_cm, M_fm=M_fm, **gmres_kw)
        fm = step is not None
        if not fm:
            step = model.implicit_stepper(M=make_M_cm(), **gmres_kw)

    U0 = model.initial_state()
    cb = make_output_cb(args, mesh, split=model.split_fields, prefix="wave")
    on_out = cb
    if fm:
        print("-- field-major GMRES loop")
        U0 = model.pack_fm(U0).reshape(-1)
        on_out = lambda it, t, U, extras: cb(it, t, model.unpack_fm(U), extras)  # noqa: E731
    res = run_time_loop(step, U0, model.dt, tmax=args.tmax, ntmax=args.ntmax,
                        precision=args.precision, output_freq=args.output_freq,
                        chunk=chunk_of(args), on_output=on_out)
    if fm:
        res.state = model.unpack_fm(res.state)
    pfin, _ = model.split_fields(res.state)
    its = [d["extras"][0] for d in res.diagnostics if d["extras"]]
    print(f"\nEnd at it={res.iterations} t={res.time:.6g} stationary={res.stationary}")
    print(f"pressure range [{pfin.min():.6g}, {pfin.max():.6g}]")
    if its:
        print(f"GMRES iterations per step: median {np.median(its):.0f}, max {np.max(its):.0f}")
    return res


def identity_plus_csr(model, dtype):
    """A = I + D as a CSRMatrix on the model's device, assembled as the JAX
    driver assembles it for ILU(0): D's entries in the working dtype, the
    sum in float64 (SciPy drops the entries that cancel to zero)."""
    import scipy.sparse as sp

    from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix

    D = model.divergence.to_csr(dtype).to_scipy()
    return CSRMatrix.from_scipy((sp.eye(D.shape[0]) + D).tocsr(), device=model.device,
                                dtype=dtype)


def _cell_major_pc(args, model, dtype):
    """The cell-major ilu0, bjacobi or aggvcycle preconditioner."""
    if args.pc == "aggvcycle":
        from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import AggregationVCyclePC

        return AggregationVCyclePC.from_bsr(model.divergence, A0_apply=model.implicit_matvec(),
                                            shift=1.0, dtype=dtype).apply
    A_I = identity_plus_csr(model, dtype)
    if args.pc == "ilu0":
        return pcs.ilu0(A_I).apply
    return pcs.block_jacobi_ilu0(A_I, args.n_blocks)


def _preconditioners(args, mesh, model, device, dtype):
    """(M_cm, M_fm, make_M) for --pc: the cell-major and field-major terms
    that implicit_stepper_fm adds up (either may be None), and a function that
    makes the cell-major preconditioner for meshes without a field-major form."""
    if args.pc == "none":
        return None, None, lambda: None
    if args.pc == "gridmg":
        if getattr(mesh, "topology_shape", None) is None:
            raise ValueError("--pc gridmg needs a mesh whose topology is a grid")
        from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC

        # the model's operators as the fine level's (on a supercell mesh its
        # supercell operator: no dense (24×24) form is built)
        pc_obj = GridVCyclePC.from_grid_model(
            model.divergence, mesh.topology_shape, cells_per_site=model.cells_per_site,
            A0_apply=model.implicit_matvec(), A0_apply_fm=model.implicit_matvec_fm(),
            shift=1.0, dtype=dtype)
        return None, pc_obj.apply_fm, lambda: pc_obj.apply
    pj_fm = pcs.pbjacobi_fm(model.divergence, shift=1.0, cells_per_site=model.cells_per_site)
    make_pj = lambda: pcs.pbjacobi(model.divergence, shift=1.0)  # noqa: E731
    if args.pc == "pbjacobi":
        return None, pj_fm, make_pj
    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import (
        BlockCirculantProjectionPC,
        DCTBlockProjectionPC,
    )

    cls = BlockCirculantProjectionPC if args.pc == "circulant2l" else DCTBlockProjectionPC
    coarse = cls(mesh, model.dt, model.c0, device=device, dtype=dtype)
    if args.pc == "dct2lm":
        A_fm = model.implicit_matvec_fm()
        M_fm = (pcs.multiplicative(A_fm, pcs.cell_major_adapter(coarse.apply, model.fm_block),
                                   pj_fm)
                if A_fm is not None else None)
        return None, M_fm, lambda: pcs.multiplicative(model.implicit_matvec(), coarse.apply,
                                                      make_pj())
    return coarse.apply, pj_fm, lambda: pcs.additive(coarse.apply, make_pj())


def _sharded_operator(mesh, model, dm, dtype):
    """(row-sharded D, its description): the halo window SpMV on an
    RCM-ordered mesh where its unit halo fits, else the row-sharded ELL
    (drivers/common.sharded_rows)."""
    from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator
    from circulantpreconditioner_tpu_torch.parallel import HaloWindowOperator

    D = model.divergence
    if getattr(mesh, "bandwidth_ordered", False):
        try:
            As = HaloWindowOperator(WindowedBlockOperator.from_bsr(D, dtype=dtype), dm)
            return As, f"halo windowed (wu={As.halo_units} units)"
        except ValueError:
            pass
    return sharded_rows(D, dm, dtype)


def _main_sharded(args):
    """Row-sharded implicit wave solve, one rank per device: the
    WaveSystem_..._impl_mpi.cxx analog (GMRES + BJACOBI distributed, :32-34,
    :139-189), with the distributed circulant projection PC the reference
    was building toward (ToDo.md:1). res.state is the gathered flat
    cell-major state; the iterations of each step are in res.diagnostics."""
    from circulantpreconditioner_tpu_torch.parallel import (
        DistributedBlockCirculantPC,
        device_mesh,
        rank_world,
        sharded_pbjacobi,
    )
    from circulantpreconditioner_tpu_torch.solvers import make_gmres

    if args.pc not in ("none", "pbjacobi", "circulant2l"):
        raise SystemExit("--shard rows supports --pc none|pbjacobi|circulant2l")
    mesh = build_mesh(args)
    with rank_world(args.devices, args.device):
        log = rank0_print()
        say = log or (lambda *a, **k: None)
        device, dtype = setup_dtype(args)
        model = WaveSystem(mesh, cfl=args.cfl or 1e3 / mesh.dim, device=device, dtype=dtype)
        say(f"-- implicit wave: mesh {mesh.name} ({mesh.n_cells} cells), "
            f"dt={model.dt:.4g}, pc={args.pc}")
        dm = device_mesh(args.devices)
        D = model.divergence
        b = D.block_size
        As, kind = _sharded_operator(mesh, model, dm, dtype)
        say(f"-- row-sharded over {dm.shape} devices: {kind} SpMV "
            f"(n={As.n}, padded {As.n_padded})")
        M = None
        side = "left"
        if args.pc != "none":
            Dinv = np.linalg.inv(D.block_diagonal().cpu().numpy() + np.eye(b)[None, :, :])
            M = sharded_pbjacobi(Dinv, As.n_padded, dm, dtype=dtype)
        if args.pc == "circulant2l":
            coarse = DistributedBlockCirculantPC(mesh, model.dt, model.c0, dm, As.n_padded,
                                                 dtype=dtype)
            M = pcs.additive(coarse.apply, M)
            side = "right"
            say(f"-- distributed circulant PC grid {coarse.n_xyz}")
        solver = make_gmres(lambda v: v + As.matvec(v), M, rtol=args.rtol, atol=args.atol,
                            maxiter=args.maxits, side=side, allreduce=dm.all_reduce)

        def step(u):
            res = solver(u, u)
            # this rank's part of ‖ΔU‖₂; run_time_loop reduces it over the ranks
            return res.x, (res.x - u).norm(), res.iters, res.resnorm, res.converged

        res = run_time_loop(
            step, As.shard_vector(model.initial_state()), model.dt, tmax=args.tmax,
            ntmax=args.ntmax, precision=args.precision, output_freq=args.output_freq,
            chunk=chunk_of(args), log=log, global_norms=dm.global_norms,
            on_output=make_sharded_output_cb(args, mesh, As.unshard_vector, dm.device,
                                             split=model.split_fields, prefix="wave"),
        )
        solver.release()  # NCCL destroys no communicator that a live graph holds
        res.state = As.unshard_vector(res.state)
        pfin, _ = model.split_fields(res.state)
        its = [d["extras"][0] for d in res.diagnostics if d["extras"]]
        say(f"\nEnd at it={res.iterations} t={res.time:.6g} stationary={res.stationary}")
        say(f"pressure range [{pfin.min():.6g}, {pfin.max():.6g}]")
        if its:
            say(f"GMRES iterations per step: median {np.median(its):.0f}, "
                f"max {np.max(its):.0f}")
    return res


if __name__ == "__main__":
    main()
