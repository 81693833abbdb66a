"""GPU smoke run of the PyTorch port's main paths, with kernels K1 and K2
checked and timed.

    python3 chip_smoke.py

Needs one CUDA GPU (exits 1 without one) and the repository beside this file.
Phases, one stdout line each (more for the drivers' own logs):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build K1 and K2 (csrc/*.cu) from the sources, one nvcc per source, timed;
3. K1 against its plain PyTorch version in float32 at (6,5,8), at the 100³
   flagship λ = (0, 0, dt/h) and at 64³ with velocity (1, 0.5, 0.25):
   max|x_kernel − x_plain| ≤ 1e-5 · max|x_plain| and ‖C x − b‖/‖b‖ < 1e-4;
4. main path A: the FFT transport driver at 100³, 5 steps;
5. main path B: periodic 100³ transport, GMRES right-preconditioned by the
   full-3D fused circulant solve (K1), 3 steps through run_time_loop; every
   step must converge in ≤ 3 iterations, K1 must have been launched, and the
   states must agree with the direct cuFFT solve. Then the implicit driver at
   100³ with --pc circulant;
6. times at 100³ of K1, its plain version, the dense, staged and cuFFT
   solvers: CUDA events (warm-up, median of repeats) and the kernel time
   from torch.profiler; each solve is held to bench.py's residual gate 1e-4.
7. K2 (csrc/plane_stencil.cu) against its plain version on Kershaw wave
   operators at (16,8,5), (5,4,6) and 64³, in float32 (max|y_K2 − y_plain|
   ≤ 1e-5 · max|y_plain|) and float64 (≤ 1e-12); the host build of the 64³
   models (mesh, BSR, varying stencil, normal form, V-cycle hierarchy) is
   timed on a line of its own;
8. main path C: the explicit wave driver at Kershaw 64³, 20 steps, through
   K2 (one launch per step), finite, and equal to the same 20 steps through
   the plain operator to 1e-5 relative;
9. main path D: the implicit wave driver at Kershaw 64³ --pc gridmg, 2 steps:
   every step converges, K2 runs in the GMRES matvec and in the V-cycle's
   fine level (the launch count is checked against the iterations), and
   the state equals a plain-operator run to 1e-4 relative. Then --pc
   pbjacobi at Kershaw 16³;
10. times at 64³: K2 and its plain version per apply (CUDA events and
   torch.profiler kernel time, GB/s from the bytes an apply must move; K2
   also with the L2 flushed before each apply), the device busy share of an
   explicit and of an implicit step, and the median wall time of the
   drivers' explicit and implicit steps.

Then one JSON line on the kernels, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, and the script exits non-zero without that line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile

import numpy as np
import torch

N = 100  # the reference's largest registered grid ("gros calcul")
TOL_KERNEL = 1e-5  # max|x_kernel − x_plain| / max|x_plain|
TOL_RESIDUAL = 1e-4  # bench.py's residual gate
NW = 64  # the Kershaw grid bench_suite.py measures the wave system at
TOL_K2 = {torch.float32: 1e-5, torch.float64: 1e-12}  # max|y_K2 − y_plain| / max|y_plain|


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def flagship_lambdas(n: int = N) -> tuple[float, float, float]:
    h = 1.0 / n
    dt = (1e3 / 3) * (h / 6)  # cfl 1e3/3 times min vol/surf = h/6, a = (1,0,0)
    return (0.0, 0.0, dt / h)


def rel_residual(op, x, b) -> float:
    return (torch.linalg.norm(op.matvec(x) - b) / torch.linalg.norm(b)).item()


def device_profile(fn, calls: int = 20) -> dict[str, float]:
    """Device ms per call by kernel name, from torch.profiler: kernels and
    copies only (an `aten::` op would count its kernels a second time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if not e.key.startswith("aten::") and e.self_device_time_total > 0}


def device_ms(fn, calls: int = 20) -> float:
    """Kernel time per call from torch.profiler (see device_profile)."""
    return sum(device_profile(fn, calls).values())


def time_ms(fn, calls: int = 20) -> float:
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / calls


def k2_expected_launches(its: list[int], pc_fine_applies: int, restart: int = 30) -> int:
    """K2 launches of the field-major GMRES steps that took `its` iterations:
    per solve one initial residual, one residual per restart cycle and one
    matvec per iteration, plus `pc_fine_applies` fine-level applies (the
    V(1,1) cycle's two residuals) per preconditioner apply, which come once
    per iteration and once per cycle (right preconditioning)."""
    total = 0
    for i in its:
        cycles = -(-i // restart)
        total += 1 + cycles + i + pc_fine_applies * (i + cycles)
    return total


def wave_phases(dev: torch.device, smi: str) -> dict:
    """Phases 7 to 10: kernel K2 and the wave system's main paths C and D at
    Kershaw 64³. Returns K2's entry of the kernels line."""
    import dataclasses
    import functools
    import time

    from circulantpreconditioner_tpu_torch.drivers import wave_explicit, wave_implicit
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.models.transport import _identity_plus
    from circulantpreconditioner_tpu_torch.ops.fused_circulant import FusedCirculantSolver
    from circulantpreconditioner_tpu_torch.ops.plane_stencil import (
        PlaneStencilMatvec,
        make_plane_stencil_matvec,
        plane_stencil_cuda,
    )
    from circulantpreconditioner_tpu_torch.ops.stencil import WaveNormalStencilOperator
    from circulantpreconditioner_tpu_torch.solvers import make_gmres
    from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC

    bounds = ((-0.5, 0.5),) * 3
    shape = (NW, NW, NW)
    rng = np.random.default_rng(3)

    def check_k2(Wn, label: str) -> float:
        check(make_plane_stencil_matvec(Wn) is not None, f"K2 refused the operator at {label}")
        g = torch.as_tensor(rng.random((Wn.m, Wn.arrays[1].shape[-1])), device=dev,
                            dtype=Wn.arrays[0].dtype)
        y_k = plane_stencil_cuda(Wn, g)
        torch.cuda.synchronize()
        y_p = Wn.matvec_fm(g)
        err = (y_k - y_p).abs().max().item()
        rel = err / y_p.abs().max().item()
        tol = TOL_K2[g.dtype]
        print(f"[7 K2 vs plain] {label} {str(g.dtype)[6:]}: max|dy|/max|y| {rel:.3e} "
              f"(tol {tol:g})", flush=True)
        check(bool(torch.isfinite(y_k).all()) and rel <= tol,
              f"K2 disagrees with its plain version at {label} {g.dtype}: {rel:.3e}")
        return err

    # --- 7: K2 against its plain version, and the host build at NW^3 -------
    k2_err = 0.0
    for n in ((16, 8, 5), (5, 4, 6)):
        for dtype in (torch.float32, torch.float64):
            Wn = WaveSystem(kershaw_mesh(bounds, n), cfl=1e3 / 3, device=dev,
                            dtype=dtype).normal_operator
            err = check_k2(Wn, "x".join(map(str, n)))
            if dtype == torch.float32:
                k2_err = max(k2_err, err)
    host = {}
    t0 = time.perf_counter()
    mesh = kershaw_mesh(bounds, shape)
    host["mesh"] = time.perf_counter() - t0
    models = {}
    for kind, cfl in (("explicit", 1.0 / 3), ("implicit", 1e3 / 3)):
        model = WaveSystem(mesh, cfl=cfl, device=dev, dtype=torch.float32)
        t0 = time.perf_counter()
        model.divergence
        torch.cuda.synchronize()
        host[f"{kind} BSR"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.varying_operator
        torch.cuda.synchronize()
        host[f"{kind} varying stencil"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(model.normal_operator is not None, f"no normal form at Kershaw {NW}^3 ({kind})")
        torch.cuda.synchronize()
        host[f"{kind} normal form"] = time.perf_counter() - t0
        models[kind] = model
    mi = models["implicit"]
    Wi = mi.normal_operator
    A_plain = functools.partial(_identity_plus, Wi.matvec_fm_flat)
    t0 = time.perf_counter()
    pc_plain = GridVCyclePC.from_grid_model(mi.divergence, shape, A0_apply=mi.implicit_matvec(),
                                            A0_apply_fm=A_plain)
    torch.cuda.synchronize()
    host["V-cycle hierarchy"] = time.perf_counter() - t0
    print(f"[host build] Kershaw {NW}^3, seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items()), flush=True)
    for kind, model in models.items():
        W32 = model.normal_operator
        k2_err = max(k2_err, check_k2(W32, f"{NW}^3 {kind} dt"))
        W64 = WaveNormalStencilOperator(W32.shape_zyx, W32.c0, W32.offsets, W32.layout,
                                        tuple(a.double() for a in W32.arrays))
        check_k2(W64, f"{NW}^3 {kind} dt")

    with tempfile.TemporaryDirectory() as out_dir:
        common = ["--mesh-family", "kershaw", str(NW), str(NW), str(NW), "--tmax", "1e9",
                  "--device", "cuda", "--result-dir", out_dir]
        # --- 8: main path C, the explicit wave driver ----------------------
        PlaneStencilMatvec.launches = FusedCirculantSolver.launches = 0
        t0 = time.perf_counter()
        res_e = wave_explicit.main(common + ["--ntmax", "20"])
        torch.cuda.synchronize()
        wall_e = time.perf_counter() - t0
        k2_e = PlaneStencilMatvec.launches
        U_e = res_e.state
        check(res_e.iterations == 20 and U_e.shape == (4 * NW**3,)
              and bool(torch.isfinite(U_e).all()), "wave_explicit: wrong steps, shape or "
              "non-finite state")
        check(k2_e == 20, f"wave_explicit: {k2_e} K2 launches for 20 steps")
        me = models["explicit"]
        G = me.pack_fm(me.initial_state())
        for _ in range(20):
            G = G - me.normal_operator.matvec_fm(G)
        U_ref = me.unpack_fm(G)
        dev_e = (U_e - U_ref).abs().max().item() / U_ref.abs().max().item()
        print(f"[8 main path C] wave_explicit Kershaw {NW}^3: 20 steps, K2 launches {k2_e}, "
              f"median {np.median(res_e.step_seconds) * 1e3:.4f} ms/step, driver wall "
              f"{wall_e:.2f} s, max|U - U_plain|/max|U_plain| {dev_e:.3e} (tol 1e-5)",
              flush=True)
        check(dev_e <= 1e-5, f"wave_explicit disagrees with the plain operator: {dev_e:.3e}")

        # --- 9: main path D, the implicit wave driver with the grid V-cycle -
        PlaneStencilMatvec.launches = FusedCirculantSolver.launches = 0
        t0 = time.perf_counter()
        res_i = wave_implicit.main(common + ["--ntmax", "2", "--pc", "gridmg"])
        torch.cuda.synchronize()
        wall_i = time.perf_counter() - t0
        k2_i = PlaneStencilMatvec.launches
        its = [d["extras"][0] for d in res_i.diagnostics]
        conv = [d["extras"][2] for d in res_i.diagnostics]
        expected = k2_expected_launches(its, pc_fine_applies=2)
        print(f"[9 main path D] wave_implicit Kershaw {NW}^3 --pc gridmg: iterations {its}, "
              f"converged {conv}, K2 launches {k2_i} (GMRES matvecs "
              f"{k2_expected_launches(its, 0)} + V-cycle fine level "
              f"{expected - k2_expected_launches(its, 0)}), ms/step "
              f"{[round(s * 1e3, 3) for s in res_i.step_seconds]}, driver wall {wall_i:.2f} s",
              flush=True)
        check(len(its) == 2 and all(conv), f"wave_implicit gridmg: iterations {its}, "
              f"converged {conv}")
        check(k2_i == expected, f"wave_implicit gridmg: {k2_i} K2 launches, expected "
              f"{expected} from the iterations {its}")
        check(bool(torch.isfinite(res_i.state).all()), "wave_implicit: non-finite state")
        solver = make_gmres(A_plain, pc_plain.apply_fm, side="right")
        G = mi.pack_fm(mi.initial_state()).reshape(-1)
        its_plain = []
        for _ in range(2):
            r = solver(G, G)
            check(r.converged, "the plain-operator gridmg step did not converge")
            G = r.x
            its_plain.append(r.iters)
        U_ref = mi.unpack_fm(G)
        dev_i = (res_i.state - U_ref).abs().max().item() / U_ref.abs().max().item()
        print(f"[9 main path D] plain-operator run: iterations {its_plain}; "
              f"max|U - U_plain|/max|U_plain| {dev_i:.3e} (tol 1e-4)", flush=True)
        check(dev_i <= 1e-4, f"wave_implicit disagrees with the plain operator: {dev_i:.3e}")

        PlaneStencilMatvec.launches = FusedCirculantSolver.launches = 0
        res_p = wave_implicit.main(common[:2] + ["16", "16", "16"] + common[5:]
                                   + ["--ntmax", "2", "--pc", "pbjacobi"])
        k2_p = PlaneStencilMatvec.launches
        its_p = [d["extras"][0] for d in res_p.diagnostics]
        conv_p = [d["extras"][2] for d in res_p.diagnostics]
        print(f"[9 driver] wave_implicit Kershaw 16^3 --pc pbjacobi: iterations {its_p}, "
              f"converged {conv_p}, K2 launches {k2_p}", flush=True)
        check(len(its_p) == 2 and all(conv_p) and bool(torch.isfinite(res_p.state).all()),
              f"wave_implicit pbjacobi: iterations {its_p}, converged {conv_p}")
        check(k2_p == k2_expected_launches(its_p, 0),
              f"wave_implicit pbjacobi: {k2_p} K2 launches for iterations {its_p}")

    # --- 10: times at NW^3 -------------------------------------------------
    Wn = mi.normal_operator
    g = torch.as_tensor(rng.random((4, NW**3)), device=dev, dtype=torch.float32)
    runs = {"K2": lambda: plane_stencil_cuda(Wn, g), "K2 plain": lambda: Wn.matvec_fm(g)}
    for fn in runs.values():  # warm-up
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    samples: dict[str, list[float]] = {name: [] for name in runs}
    for _ in range(7):  # interleaved repeats
        for name, fn in runs.items():
            samples[name].append(time_ms(fn, calls=50))
    ms = {name: float(np.median(v)) for name, v in samples.items()}
    kernel_ms = {name: device_ms(fn, calls=50) for name, fn in runs.items()}
    nbytes = (4 + 16 + 6 + 18 + 4) * 4 * NW**3  # x, diag, s, n̂, y in float32
    print(f"[10 times] Kershaw {NW}^3 float32, one apply of D moves {nbytes / 1e6:.1f} MB; "
          f"CUDA events: median of 7 x 50 back-to-back applies (the L2 stays warm); "
          f"kernel time: torch.profiler over 50 applies; on {smi}:", flush=True)
    for name in runs:
        print(f"[10 times]   {name}: {ms[name]:.4f} ms/apply, kernel time "
              f"{kernel_ms[name]:.4f} ms/apply = {nbytes / kernel_ms[name] / 1e6:.1f} GB/s",
              flush=True)
    # the same with the L2 flushed before each apply (a 256 MB write): the
    # 50 MB working set fits the 50 MB L2 when K2 runs back to back, but the
    # main path's other work evicts it between applies
    flush = torch.empty(64 * 2**20, device=dev, dtype=torch.float32)
    cold = device_profile(lambda: (flush.zero_(), plane_stencil_cuda(Wn, g)), calls=50)
    k2_cold = sum(v for k, v in cold.items() if "plane_stencil" in k)
    print(f"[10 times]   K2 with the L2 flushed before each apply: kernel time "
          f"{k2_cold:.4f} ms/apply = {nbytes / k2_cold / 1e6:.1f} GB/s", flush=True)
    # device busy share of an explicit and an implicit (gridmg) step, K2
    # inside; the explicit step is a few kernels, so it is profiled over 20
    # steps (a one-step profiling window recorded no kernel of it)
    levels = list(pc_plain.levels)
    levels[0] = dataclasses.replace(levels[0], A_fm=mi.implicit_matvec_fm())
    pc_k2 = GridVCyclePC(levels, pc_plain.bot_inv, pc_plain.n_smooth, pc_plain.omega,
                         pc_plain.b)
    steps = {
        "explicit": (models["explicit"].explicit_stepper_fm(),
                     models["explicit"].pack_fm(models["explicit"].initial_state()), 20),
        "implicit gridmg": (mi.implicit_stepper_fm(M_fm=pc_k2.apply_fm, side="right"),
                            mi.pack_fm(mi.initial_state()).reshape(-1), 3),
    }
    for name, (step, U0, reps) in steps.items():
        step(U0)  # warm-up
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(U0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        prof = device_profile(lambda: step(U0), calls=reps)
        busy = sum(prof.values())
        wall = float(np.median(walls))
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:5]
        print(f"[10 busy] {name} step at {NW}^3: wall {wall:.3f} ms (median of {reps}), "
              f"device {busy:.3f} ms/step (profiled over {reps} steps), busy "
              f"{100 * busy / wall:.1f} %; largest: "
              + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top), flush=True)
    print(f"[10 times]   explicit step (wave_explicit, 20 steps): median "
          f"{np.median(res_e.step_seconds) * 1e3:.4f} ms; implicit step (wave_implicit "
          f"--pc gridmg, 2 steps): median {np.median(res_i.step_seconds) * 1e3:.3f} ms",
          flush=True)
    # "launches" counts the two main paths at NW^3; each count was reset
    # before its own driver run and checked after it
    return {"launches": k2_e + k2_i,
            "launches_by_path": {f"C wave_explicit {NW}^3": k2_e,
                                 f"D wave_implicit gridmg {NW}^3": k2_i,
                                 "wave_implicit pbjacobi 16^3": k2_p},
            "max_abs_err": k2_err, "ms": ms["K2"], "plain_ms": ms["K2 plain"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 1

    from circulantpreconditioner_tpu_torch.drivers import transport_fft, transport_implicit
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.models import TransportEquation, run_time_loop
    from circulantpreconditioner_tpu_torch.native import build
    from circulantpreconditioner_tpu_torch.ops.circulant import CirculantTransportOperator
    from circulantpreconditioner_tpu_torch.ops.dft_matmul import MatmulCirculantSolver
    from circulantpreconditioner_tpu_torch.ops.fused_circulant import (
        FusedCirculantSolver,
        fused_circulant_reference,
        fused_circulant_solve_cuda,
    )
    from circulantpreconditioner_tpu_torch.ops.spectral_collapse import (
        DenseCirculantSolver,
        make_circulant_solver,
    )

    dev = torch.device("cuda")
    f32 = dict(device=dev, dtype=torch.float32)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[1 device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    _, build_s = build.build(force=True)
    build.load_library()
    print(f"[2 build] K1 and K2 built from csrc/ in {build_s:.2f} s", flush=True)

    # --- 3: K1 against its plain version ---------------------------------
    rng = np.random.default_rng(1)
    h64 = 1.0 / 64
    dt64 = (1e3 / 3) * (h64 / 6) / np.linalg.norm([1.0, 0.5, 0.25])
    configs = [
        ("6x5x8", (6, 5, 8), (0.3, 0.2, 0.9)),
        ("100^3 flagship", (N, N, N), flagship_lambdas()),
        ("64^3 a=(1,0.5,0.25)", (64, 64, 64), tuple(a * dt64 / h64 for a in (0.25, 0.5, 1.0))),
    ]
    max_abs_err = 0.0
    for name, shape, lams in configs:
        solver = FusedCirculantSolver.create(shape, lams, precision="high", **f32)
        op = CirculantTransportOperator.create(shape, lams, **f32)
        b = torch.as_tensor((rng.random(shape) * 50 + 600).astype(np.float32), device=dev)
        x_k = fused_circulant_solve_cuda(b, solver.arrays, "high")
        torch.cuda.synchronize()
        x_p = fused_circulant_reference(b, solver.arrays, "high")
        err = (x_k - x_p).abs().max().item()
        rel = err / x_p.abs().max().item()
        res = rel_residual(op, x_k, b)
        max_abs_err = max(max_abs_err, err)
        print(f"[3 K1 vs plain] {name}: max|dx|/max|x| {rel:.3e} (tol {TOL_KERNEL:g}), "
              f"||Cx-b||/||b|| {res:.3e} (tol {TOL_RESIDUAL:g})", flush=True)
        check(rel <= TOL_KERNEL, f"K1 disagrees with its plain version at {name}: {rel:.3e}")
        check(res < TOL_RESIDUAL, f"K1 residual {res:.3e} at {name}")

    with tempfile.TemporaryDirectory() as out_dir:
        # --- 4: main path A ---------------------------------------------------
        res_a = transport_fft.main([str(N)] * 3 + ["--ntmax", "5", "--tmax", "1e9", "--device",
                                                   "cuda", "--result-dir", out_dir])
        u_a = res_a.state
        check(res_a.iterations == 5 and u_a.shape == (N**3,) and bool(torch.isfinite(u_a).all()),
              "transport_fft driver: wrong step count, shape or non-finite state")
        # implicit upwind is monotone: values stay within the initial range
        check(599.99 < u_a.min().item() and u_a.max().item() < 650.01,
              "transport_fft driver left the initial value range")
        print(f"[4 main path A] transport_fft 100^3: {res_a.iterations} steps, "
              f"median {np.median(res_a.step_seconds) * 1e3:.3f} ms/step", flush=True)

        # --- 5: main path B ---------------------------------------------------
        mesh = cartesian_mesh(((-0.5, 0.5),) * 3, (N, N, N), periodic=True)
        model = TransportEquation(mesh, (1.0, 0.0, 0.0), cfl=1e3 / 3, **f32)
        op = model.fft_operator
        M = make_circulant_solver(op.shape_zyx, op.lambdas_zyx, precision="high",
                                  elide_zero_axes=False, fused=True, **f32)
        check(isinstance(M, FusedCirculantSolver), "fused=True did not give the K1 solver")
        step = model.implicit_stepper(M=M.as_preconditioner(), side="right")
        u0 = model.initial_state()
        step(u0)  # warm-up (allocator, cuBLAS handles); not part of the run
        torch.cuda.synchronize()
        FusedCirculantSolver.launches = 0
        res_b = run_time_loop(step, u0, model.dt, tmax=1e9, ntmax=3, log=None)
        launches = FusedCirculantSolver.launches
        its = [d["extras"][0] for d in res_b.diagnostics]
        conv = [d["extras"][2] for d in res_b.diagnostics]
        print(f"[5 main path B] GMRES + K1 preconditioner, periodic 100^3: iterations {its}, "
              f"converged {conv}, ms/step {[round(s * 1e3, 3) for s in res_b.step_seconds]}, "
              f"K1 launches {launches}", flush=True)
        check(launches > 0, "main path B never launched K1")
        check(len(its) == 3 and all(conv) and max(its) <= 3,
              f"main path B: iterations {its}, converged {conv}")
        # the same 3 steps by the direct cuFFT solve
        u_ref = u0
        fft_step = model.fft_stepper("fft")
        for _ in range(3):
            u_ref, _ = fft_step(u_ref)
        dev_b = (res_b.state - u_ref).abs().max().item() / u_ref.abs().max().item()
        print(f"[5 main path B] max|u_gmres - u_fft|/max|u| after 3 steps: {dev_b:.3e}",
              flush=True)
        check(bool(torch.isfinite(res_b.state).all()) and dev_b < 1e-4,
              f"main path B disagrees with the direct solve: {dev_b:.3e}")

        res_i = transport_implicit.main([str(N)] * 3 + ["--pc", "circulant", "--ntmax", "3",
                                                        "--device", "cuda", "--result-dir",
                                                        out_dir])
        its_i = [d["extras"][0] for d in res_i.diagnostics]
        # dt = 0.556 > the default tmax 0.05, so the driver stops after one step
        check(res_i.iterations == 1 and all(d["extras"][2] for d in res_i.diagnostics)
              and bool(torch.isfinite(res_i.state).all()),
              f"transport_implicit driver: iterations {its_i}")
        print(f"[5 driver] transport_implicit 100^3 --pc circulant: GMRES iterations {its_i}",
              flush=True)

    # --- 6: times at 100^3 ------------------------------------------------
    lams = flagship_lambdas()
    op = CirculantTransportOperator.create((N, N, N), lams, **f32)
    fused = FusedCirculantSolver.from_operator(op, precision="high")
    b = torch.as_tensor((np.random.default_rng(1).random((N, N, N)) * 50 + 600)
                        .astype(np.float32), device=dev)
    dense = DenseCirculantSolver.create((N, N, N), lams, precision="high", **f32)
    staged = MatmulCirculantSolver.from_operator(op, precision="high")
    runs = {
        "K1 (fused CUDA)": lambda: fused_circulant_solve_cuda(b, fused.arrays, "high"),
        "K1 plain (torch.matmul)": lambda: fused_circulant_reference(b, fused.arrays, "high"),
        "DenseCirculantSolver": lambda: dense.solve(b),
        "MatmulCirculantSolver": lambda: staged.solve(b),
        "cuFFT CirculantTransportOperator": lambda: op.solve(b),
    }
    residuals = {name: rel_residual(op, fn(), b) for name, fn in runs.items()}
    for fn in runs.values():  # warm-up
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    samples: dict[str, list[float]] = {name: [] for name in runs}
    for _ in range(7):  # interleaved repeats, so drift falls on every solver alike
        for name, fn in runs.items():
            samples[name].append(time_ms(fn))
    ms = {name: float(np.median(v)) for name, v in samples.items()}
    kernel_ms = {name: device_ms(fn) for name, fn in runs.items()}
    # CUDA-event time covers the stream including gaps, so it reads the
    # host's enqueue rate when a solver launches many small kernels
    print(f"[6 times] 100^3 float32, CUDA events: median of 7 x 20 solves; kernel time: "
          f"torch.profiler over 20 solves; on {smi}:", flush=True)
    for name in runs:
        print(f"[6 times]   {name}: {ms[name]:.4f} ms/solve ({1e3 / ms[name]:.1f} solves/s), "
              f"kernel time {kernel_ms[name]:.4f} ms/solve, residual {residuals[name]:.3e}",
              flush=True)
        check(residuals[name] < TOL_RESIDUAL, f"{name}: residual {residuals[name]:.3e}")

    k2 = wave_phases(dev, smi)

    print(json.dumps({"kernels": [{
        "name": "fused_circulant_solve (K1)",
        "route": "cuda",
        "source": "circulantpreconditioner_tpu_torch/csrc/fused_circulant.cu",
        "replaces": "circulantpreconditioner_tpu/ops/fused_circulant.py:117",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms["K1 (fused CUDA)"],
        "plain_ms": ms["K1 plain (torch.matmul)"],
    }, {
        "name": "plane_stencil_matvec (K2)",
        "route": "cuda",
        "source": "circulantpreconditioner_tpu_torch/csrc/plane_stencil.cu",
        "replaces": "circulantpreconditioner_tpu/ops/pallas_stencil.py:69",
        **k2,
    }]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
