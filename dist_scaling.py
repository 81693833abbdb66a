"""The distributed layer (circulantpreconditioner_tpu_torch/parallel/) over P
GPUs of one host, one process per GPU, through NCCL:

    torchrun --nproc-per-node P dist_scaling.py

Each rank builds the same models from a seed and keeps its blocks. Rank 0
prints, for this P: the slab and pencil circulant solves at 128³ (checked
against the one-device cuFFT solve on every rank, 1e-5 relative), the halo
ELL, all-gather ELL and slab-stencil SpMVs of the Kershaw 64³ wave operator
and the distributed projection PC's apply (each checked against its
one-device counterpart, 1e-5 and 1e-4), each in ms per apply by CUDA events
over chains of applies begun together on every rank; then the sharded
drivers, `wave_explicit --shard slab` (20 steps) and `wave_implicit --shard
rows --pc circulant2l` (2 steps) at Kershaw 64³ and `transport_fft --shard
slab` at 128³ (5 steps), each captured (CUDA graphs, the collectives inside)
and with capture off: ms per step and GMRES iterations side by side (the
same iterations, states within 1e-6); and the grid V-cycle on z-slabs
(parallel/vcycle_dist.py, the counterpart of the JAX package's GSPMD-sharded
GridVCyclePC, its __graft_entry__.py stage (e)) at Kershaw 64³: its apply
by CUDA events beside the one-device GridVCyclePC.apply_fm (checked, 1e-5
relative), and two implicit steps of field-major GMRES right-preconditioned
by it (K2 on each rank's slab), captured and with capture off, beside the
same two steps on one card (path D's 38 and 28 iterations; within one). The
last line is one JSON object of these figures with the card's name and
power limit. Run it at P = 1 and at P = 4 on the same host to compare them.
Exits non-zero when a check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

N, NW, CALLS, REPEATS = 128, 64, 20, 7


def chain_ms(fn) -> float:
    """ms per call: the median of REPEATS chains of CALLS calls, each begun
    after a barrier, timed by CUDA events on this rank."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPEATS):
        dist.barrier()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(CALLS):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / CALLS)
    return float(np.median(times))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"dist_scaling: {what}")


def main() -> int:
    from circulantpreconditioner_tpu_torch.drivers import (
        transport_fft,
        wave_explicit,
        wave_implicit,
    )
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.ops.circulant import CirculantTransportOperator
    from circulantpreconditioner_tpu_torch.parallel import (
        DistributedBlockCirculantPC,
        HaloELLMatrix,
        PencilCirculantSolver,
        ShardedELLMatrix,
        SlabCirculantSolver,
        SlabGridVCyclePC,
        SlabStencilOperator,
        device_mesh,
        device_mesh_2d,
        rank_world,
    )
    from circulantpreconditioner_tpu_torch.solvers import make_gmres
    from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC
    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import BlockCirculantProjectionPC
    from circulantpreconditioner_tpu_torch.utils import graphs

    out = {}
    with rank_world(None, "cuda"):
        P = dist.get_world_size()
        rank0 = dist.get_rank() == 0
        say = print if rank0 else (lambda *a, **k: None)
        dm = device_mesh()
        dev = dm.device
        f32 = dict(device=dev, dtype=torch.float32)
        rng = np.random.default_rng(0)
        out["P"] = P

        # the circulant solves at N^3 (the flagship λ: cfl 1e3/3, a = (1,0,0))
        h = 1.0 / N
        op = CirculantTransportOperator.create((N, N, N), (0.0, 0.0, (1e3 / 3) * (h / 6) / h),
                                               **f32)
        b = torch.as_tensor(rng.random((N, N, N)), **f32)
        x_ref = op.solve(b)
        pq = (max(P // 2, 1), 2 if P >= 2 else 1)
        for name, s in (("slab", SlabCirculantSolver.from_operator(op, dm)),
                        (f"pencil {pq[0]}x{pq[1]}",
                         PencilCirculantSolver.from_operator(op, device_mesh_2d(pq)))):
            bs = s.shard(b)
            rel = ((s.unshard(s.solve(bs)) - x_ref).abs().max() / x_ref.abs().max()).item()
            check(rel <= 1e-5, f"{name} solve off cuFFT: {rel:.3e}")
            out[f"{name} solve {N}^3 ms"] = chain_ms(lambda: s.solve(bs))
            say(f"[P={P}] {name} solve {N}^3: {out[f'{name} solve {N}^3 ms']:.4f} ms/apply, "
                f"max|x - x_cuFFT|/max|x_cuFFT| {rel:.2e}", flush=True)
        out[f"one-device cuFFT solve {N}^3 ms"] = chain_ms(lambda: op.solve(b))
        del op, b, x_ref

        # the Kershaw NW^3 wave operator, its SpMVs and the projection PC
        mesh = kershaw_mesh(((-0.5, 0.5),) * 3, (NW,) * 3)
        model = WaveSystem(mesh, cfl=1e3 / 3, **f32)
        D = model.divergence
        x = torch.as_tensor(rng.random(D.shape[0]), **f32)
        y_ref = D.matvec(x)
        A = D.to_csr(torch.float32)
        for name, S in (("HaloELLMatrix", HaloELLMatrix(A, dm, row_multiple=4)),
                        ("ShardedELLMatrix", ShardedELLMatrix(A, dm, row_multiple=4)),
                        ("SlabStencilOperator", SlabStencilOperator(model.varying_operator, dm))):
            xs = S.shard_vector(x)
            y = S.unshard_vector(S.matvec(xs)).reshape(-1)
            rel = ((y - y_ref).abs().max() / y_ref.abs().max()).item()
            check(rel <= 1e-5, f"{name} off the BSR matvec: {rel:.3e}")
            out[f"{name} {NW}^3 ms"] = chain_ms(lambda: S.matvec(xs))
            say(f"[P={P}] {name} {NW}^3: {out[f'{name} {NW}^3 ms']:.4f} ms/apply, "
                f"max|dy|/max|y| {rel:.2e}", flush=True)
        out[f"one-device BSR matvec {NW}^3 ms"] = chain_ms(lambda: D.matvec(x))
        Ah = HaloELLMatrix(A, dm, row_multiple=4)
        pc = DistributedBlockCirculantPC(mesh, model.dt, model.c0, dm, Ah.n_padded,
                                         dtype=torch.float32)
        rs = Ah.shard_vector(x)
        z_ref = BlockCirculantProjectionPC(mesh, model.dt, model.c0, **f32).apply(x)
        rel = ((Ah.unshard_vector(pc.apply(rs)) - z_ref).abs().max() / z_ref.abs().max()).item()
        check(rel <= 1e-4, f"the distributed PC off the one-device PC: {rel:.3e}")
        out[f"DistributedBlockCirculantPC {NW}^3 ms"] = chain_ms(lambda: pc.apply(rs))
        say(f"[P={P}] DistributedBlockCirculantPC {NW}^3 (grid {pc.n_xyz}, halos {pc.halo_fwd}, "
            f"{pc.halo_bak} rows): {out[f'DistributedBlockCirculantPC {NW}^3 ms']:.4f} ms/apply, "
            f"max|dz|/max|z| {rel:.2e}", flush=True)
        del model, D, A, Ah, pc, x, y_ref, z_ref

        # the sharded drivers, captured (the default: their steps, or their
        # GMRES, as CUDA-graph replays with the collectives inside) and with
        # capture off, in turns
        kershaw = ["--mesh-family", "kershaw", str(NW), str(NW), str(NW), "--tmax", "1e9"]
        runs = {
            f"wave_explicit --shard slab {NW}^3": (
                wave_explicit, kershaw + ["--shard", "slab", "--ntmax", "20"]),
            f"transport_fft --shard slab {N}^3": (
                transport_fft, [str(N)] * 3 + ["--shard", "slab", "--ntmax", "5", "--tmax", "1e9"]),
            f"wave_implicit --shard rows --pc circulant2l {NW}^3": (
                wave_implicit,
                kershaw + ["--shard", "rows", "--pc", "circulant2l", "--ntmax", "2"]),
        }
        for name, (driver, argv) in runs.items():
            res = {}
            for capture in (True, False):
                graphs.CAPTURE = capture
                graphs.STATS.reset()
                try:
                    res[capture] = driver.main(argv)
                finally:
                    graphs.CAPTURE = True
                replays = graphs.STATS.replays
                check((replays > 0) == capture,
                      f"{name}: {replays} graph replays, capture {capture}")
            its = {c: [d["extras"][0] for d in r.diagnostics if d["extras"]]
                   for c, r in res.items()}
            rel = ((res[True].state - res[False].state).abs().max()
                   / res[False].state.abs().max()).item()
            check(its[True] == its[False] and rel <= 1e-6,
                  f"{name}: captured {its[True]} against {its[False]}, states {rel:.3e} apart")
            check(all(d["extras"][2] for d in res[True].diagnostics if d["extras"]),
                  f"{name} did not converge")
            out[name] = {"ms/step captured": [t * 1e3 for t in res[True].step_seconds],
                         "ms/step capture off": [t * 1e3 for t in res[False].step_seconds],
                         "iterations": its[True], "iterations capture off": its[False],
                         "max|dU|/max|U|": rel}
            c, e = out[name]["ms/step captured"], out[name]["ms/step capture off"]
            say(f"[P={P}] {name}: ms/step captured first {c[0]:.3f} (its captures), then "
                f"median {np.median(c[1:]):.4f}; capture off first {e[0]:.3f}, then median "
                f"{np.median(e[1:]):.4f}; iterations {its[True]} (capture off {its[False]}); "
                f"states {rel:.2e} apart", flush=True)

        # the grid V-cycle on z-slabs at NW^3, and two implicit steps of
        # field-major GMRES with it (path D's solve), against one card
        model = WaveSystem(mesh, cfl=1e3 / 3, **f32)
        pc = GridVCyclePC.from_grid_model(model.divergence, mesh.topology_shape,
                                          A0_apply=model.implicit_matvec(),
                                          A0_apply_fm=model.implicit_matvec_fm(), shift=1.0,
                                          dtype=torch.float32)
        spc = SlabGridVCyclePC.from_wave_model(model, dm, pc=pc)
        r = torch.as_tensor(np.random.default_rng(1).random(model.divergence.shape[0]), **f32)
        rs = spc.shard(r)
        z1 = pc.apply_fm(r)
        rel = ((spc.unshard(spc.apply(rs)) - z1).abs().max() / z1.abs().max()).item()
        check(rel <= 1e-5, f"the sharded V-cycle off the one-device apply: {rel:.3e}")
        name = f"SlabGridVCyclePC {NW}^3"
        out[f"{name} ms"] = chain_ms(lambda: spc.apply(rs))
        out[f"one-device GridVCyclePC.apply_fm {NW}^3 ms"] = chain_ms(lambda: pc.apply_fm(r))
        say(f"[P={P}] {name} ({spc.describe()}): {out[f'{name} ms']:.4f} ms/apply (one device "
            f"{out[f'one-device GridVCyclePC.apply_fm {NW}^3 ms']:.4f}), max|dz|/max|z| "
            f"{rel:.2e}", flush=True)
        kw = dict(rtol=1e-5, atol=1e-5, maxiter=1000, side="right")
        G0 = model.pack_fm(model.initial_state()).reshape(-1)
        one = make_gmres(model.implicit_matvec_fm(), pc.apply_fm, **kw)
        its1, g = [], G0
        for _ in range(2):
            res1 = one(g, g)
            its1.append(res1.iters)
            g = res1.x
        one.release()
        runs = {}
        for capture in (True, False):
            graphs.CAPTURE = capture  # read when the solver's graphs are made, at its first solve
            graphs.STATS.reset()
            try:
                solver = make_gmres(spc.fine, spc.apply, allreduce=dm.all_reduce, **kw)
                u, its, ms = spc.shard(G0), [], []
                for _ in range(2):
                    dist.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = solver(u, u)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    its.append(res.iters)
                    check(res.converged, f"sharded gridmg did not converge (capture {capture})")
                    u = res.x
            finally:
                graphs.CAPTURE = True
            solver.release()  # a group outlives the graphs that hold its collectives
            check((graphs.STATS.replays > 0) == capture,
                  f"sharded gridmg: {graphs.STATS.replays} graph replays, capture {capture}")
            runs[capture] = (its, ms, u)
        rel = ((runs[True][2] - runs[False][2]).abs().max() / runs[False][2].abs().max()).item()
        check(runs[True][0] == runs[False][0] and rel <= 1e-6,
              f"sharded gridmg: captured {runs[True][0]} against {runs[False][0]}, states "
              f"{rel:.3e} apart")
        check(all(abs(a - c) <= 1 for a, c in zip(runs[True][0], its1)),
              f"sharded gridmg iterations {runs[True][0]}, one card {its1}")
        name = f"GMRES + SlabGridVCyclePC {NW}^3, 2 steps"
        out[name] = {"ms/step captured": runs[True][1], "ms/step capture off": runs[False][1],
                     "iterations": runs[True][0], "iterations one card": its1,
                     "max|dU|/max|U|": rel, "levels": spc.describe()}
        say(f"[P={P}] {name}: ms/step captured {[round(t, 3) for t in runs[True][1]]} (the "
            f"first captures), capture off {[round(t, 3) for t in runs[False][1]]}; "
            f"iterations {runs[True][0]} (one card {its1}, path D 38 and 28); states "
            f"{rel:.2e} apart", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    if rank0:
        out["cards"] = smi
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
