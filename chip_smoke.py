"""GPU smoke run of the PyTorch port's main paths, with kernels K1 to K7
checked and timed.

    python3 chip_smoke.py

Needs one CUDA GPU (exits 1 without one) and the repository beside this file.
Phases, one stdout line each (more for the drivers' own logs):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build K1 to K7 (csrc/*.cu) from the sources, one nvcc per source,
   timed; ptxas's report of K1 and K3; the count of tensor-core instructions
   (HMMA, HGMMA) in the SASS of each of K3's float32 kernels (cuobjdump),
   which must not be 0;
3. K1 against its plain PyTorch version in float32 at (6,5,8), at the 100³
   flagship λ = (0, 0, dt/h), at 64³ with velocity (1, 0.5, 0.25), at the
   prime and odd (7,11,13) and (101,100,100), at nz = 400 (400,16,16), at
   one plane (1,5,8) and at (4,200,300), whose planes run unfused (100³,
   64³, 101×100×100 and 400×16×16 run x and y fused per plane):
   max|x_kernel − x_plain| ≤ 1e-5 · max|x_plain| and
   ‖C x − b‖/‖b‖ < 1e-4; at (2,3,9000), whose rows are too long for a
   block's shared memory, against the plain version in float64 (float32
   dense sums of 9000 terms err by ~1e-5 themselves). Then each of K1's five
   passes alone at 100³ and (7,11,13), fed the plain executor's previous
   output, against k1_passes_reference (≤ 1e-5 · max|reference|);
4. main path A: the FFT transport driver at 100³, 5 steps; its step
   against the same step with capture off (phase 22), one step and a chunk
   of 10 steps per graph replay;
5. main path B: periodic 100³ transport, GMRES right-preconditioned by the
   full-3D fused circulant solve (K1), 3 steps through run_time_loop; every
   step must converge in ≤ 3 iterations, K1 must have been launched, and the
   states must agree with the direct cuFFT solve; a step's wall and device
   time (torch.profiler over 5 steps). Then the implicit driver at 100³ with
   --pc circulant;
6. times at 100³ of K1, its plain version, the dense, staged and cuFFT
   solvers: CUDA events (warm-up, median of repeats), CUDA-graph replay for
   K1, its plain version and the cuFFT solve (rfftn, × 1/Λ, irfftn: three
   calls, K1's library yardstick), and the kernel time from torch.profiler;
   each solve is held to bench.py's residual gate 1e-4. K1's five passes
   one by one, and its two per-plane launches, by CUDA-graph replay.
7. K2 (csrc/plane_stencil.cu) against its plain version on Kershaw wave
   operators at (16,8,5), (5,4,6) and 64³, in float32 (max|y_K2 − y_plain|
   ≤ 1e-5 · max|y_plain|) and float64 (≤ 1e-12); the host build of the 64³
   models (mesh, BSR, varying stencil, normal form, V-cycle hierarchy) is
   timed on a line of its own;
8. main path C: the explicit wave driver at Kershaw 64³, 20 steps, through
   K2 (one launch per step), finite, and equal to the same 20 steps through
   the plain operator to 1e-5 relative; its step against capture off (phase
   22), one step and a chunk of 20 per replay, one K2 launch per step;
9. main path D: the implicit wave driver at Kershaw 64³ --pc gridmg, 2 steps:
   every step converges, K2 runs in the GMRES matvec and in the V-cycle's
   fine level (the launch count is checked against the iterations), and
   the state equals a plain-operator run to 1e-4 relative. Then --pc
   pbjacobi at Kershaw 16³;
10. times at 64³: K2 and its plain version per apply (CUDA events, CUDA-graph
   replay and torch.profiler kernel time, GB/s from the bytes an apply must move; K2
   also with the L2 flushed before each apply), the device busy share of an
   explicit and of an implicit step, and the median wall time of the
   drivers' explicit and implicit steps; the same field-major operator as one
   torch.sparse_csr_tensor product, the library yardstick of K2.
11. K3 (csrc/complex_matmul.cu; float32 in 3×TF32 on the tensor cores)
   against its plain version at (8320,128)·(128,128), (5100,100)·(100,100),
   a ragged (37,45)·(45,29) and (2113,129)·(129,136), the edges of its
   float32 tiling (16·132 + 1 rows, a second chunk of K, a second column
   tile): max|o_K3 − o_plain| ≤ 1e-5 · max|o_plain| in float32, 1e-12 in
   float64; then K3 and the plain version against float64 at the two stage
   shapes with B the DFT matrix (K3 ≤ 2e-6 · max|o|);
12. main path E: the staged DFT solve through K3, MatmulCirculantSolver(
   use_kernel=True) at 128³ with velocity (1, 0.5, 0.25) and at the 100³
   flagship λ: 4 K3 launches per solve, agreement with the einsum form to
   1e-5 relative, ‖C x − b‖/‖b‖ < 1e-4; then 5 transport steps at 100³ through
   run_time_loop with that solver as a captured step, equal to the cuFFT
   solve's to 1e-5, and that step against capture off (phase 22), 4 K3
   launches per step;
13. main path F, the FFT projection preconditioners: wave_implicit --pc
   dct2lm at Kershaw 64³, 2 steps (every step converges, K2's launches match
   the iterations, the state equals a plain-operator run to 1e-4); --pc
   circulant2l and dct2l at Kershaw 16³; --pc dctfft at wall 64³ and --pc
   blockfft --periodic at 64³, 20 steps each, with the residual of one
   direct step (the DCT solve at "highest": the driver's "high" is held in
   phase 25), and each step against capture off (phase 22);
   transport_implicit --mesh-family kershaw 32³ --pc circulant,
   2 steps. The host build of the 64³ projection is timed on its own line;
14. times: K3 per call against its plain version and one complex64
   torch.matmul (cuBLAS), by CUDA events, CUDA-graph replay and
   torch.profiler (with the launches it recorded), with its bound (bytes,
   or 3 × 6·M·K·N flops over the TF32 peak) and the TFLOP/s of its 12
   tensor-core products; the staged solve per call, through K3 and by
   einsums, beside K3's share of it (4 K3 calls); the dct2lm step's wall
   and device busy share at 64³; one preconditioner apply split into P, the
   DCT solve, P_back and the smoother; the periodic coarse solves of the
   projection PCs (block 64³, scalar 32³) by torch.fft, their default, and
   by the staged DFT (use_matmul_dft=True, the JAX package's default);
15. main path G, GMRES + ILU(0) on the wave system at cartesian 32³ (cfl
   1e3/3, float32; bench_suite.py's bench_wave_ilu): the host factor and
   level schedule, timed, with 98 levels per triangle; the card's ILU apply
   against the port's float64 CPU apply of the same factor (max|dz|/max|z| ≤
   1e-5); one GMRES + ILU(0) step with maxiter 100 (the bench's cap; at this
   cfl it does not converge, in the JAX package either: the step must be
   finite and its iterations are printed), the same step with block-Jacobi
   ILU(0) over 4 blocks, and wave_implicit with no --pc (ILU(0), the
   default) for 2 steps; the launches of one apply (torch.profiler), its
   time by CUDA events and by CUDA-graph replay, and a step's wall;
16. main path H, diffusion at 64³: a CG step on the wall cartesian mesh at cfl
   10 (‖(I+D)x − b‖/‖b‖ < 1e-4), the FFT step on the periodic mesh against
   one CG solve of the same right-hand side (max|dx|/max|x| ≤ 1e-4), a
   Fourier mode's amplitude after 3 FFT steps against exact_mode_decay (1e-5
   relative), the FFT step against capture off (phase 22), and
   diffusion_implicit --method pc on Kershaw 64³, 2 steps
   (every step converges); the wall per step of each;
17. main path I, wave_implicit --pc aggvcycle on Kershaw 24³, 2 steps (every
   step converges): iterations, the hierarchy's levels and host build, and
   one V-cycle apply by CUDA events and by CUDA-graph replay;
18. main path J, the tet meshes, as bench_suite.py builds its Kershaw-tet
   50³ rung (750,000 tets, 3,000,000 unknowns): the host build (mesh, BSR,
   block-sparse supercell operator) and its device memory; the supercell
   SpMV against the BSR matvec (1e-5 relative), one apply's launches and
   times beside its bound; 20 explicit field-major steps against 20 BSR
   steps (1e-5); field-major GMRES + the grid V-cycle (right, rtol and atol
   1e-5, cfl 1e3/3) for 2 steps: 40 to 42 iterations in the first (the TPU
   took 41), converged, ‖(I + D)x − b‖/‖b‖ ≤ 1e-4 against the assembled
   operator, the wall per step; the first step again, warm (the solve
   bench_suite.py times), its wall and, over one more, its device time and
   launches (torch.profiler); one V-cycle apply's launches, CUDA-event and
   graph times. Then the drivers at 16³: wave_implicit --mesh-family kershawtet
   --pc gridmg (field-major GMRES over the block-sparse supercell stencil,
   the cycle's field-major apply) and wave_explicit --mesh-family tetra, 2
   steps each.
19. mesh files: (a) path D from a Gmsh file of Kershaw 64³ with shared
   vertices: the host seconds of read, weld and topology recovery; the
   recovered mesh equal to kershaw_mesh's bit for bit; wave_implicit <file>
   --pc gridmg for 2 steps: phase 9's iterations and K2 launches, the state
   within 1e-6 of phase 9's; (d) one such step under utils.profiling.trace
   (the Chrome trace must name K2's kernel and the host span port.flag_wait;
   the device span port.op must count K2's launches), timed, and two
   untraced steps that add nothing to the spans; (b) a
   Kershaw-tet 16³ file with each cell's own vertices: read_mesh welds it,
   finds no non-conforming pair and no grid, and RCM-orders it; its cell
   centres and volumes equal kershaw_tet_mesh's (1e-12); the window SpMV
   within 1e-5 of the BSR matvec; wave_implicit <file> --pc circulant2l
   --vtk for 2 steps, each converged, ‖(I+D)U_k − U_k−1‖/‖U_k−1‖ ≤ 1e-4 from
   the states the VTK files hold; (c) wave_explicit <Kershaw 16³ file> --vtk,
   3 steps: 3 files, each with the mesh's cell count in its headers. No MED
   file: the GPU host has no h5py, and the phase checks that h5py was not
   imported.
20. the distributed layer (parallel/) on a world of one rank, opened as the
   drivers open it (parallel.rank_world: NCCL on the card): (a) the slab and
   pencil (1×1) solves at the 100³ flagship λ against the cuFFT solve (1e-5
   relative) and bench.py's residual gate, and transport_fft --shard slab
   and --shard pencil, 3 steps, against three one-device solves (1e-5);
   (b) wave_explicit --shard slab and --shard rows at Kershaw 64³, 20 steps,
   within 1e-5 of path C's state; gather_to_host0 of the slab state;
   (c) wave_implicit --shard rows --pc pbjacobi and circulant2l at Kershaw
   64³ in float32, 2 steps, their GMRES iterations beside one device's, and
   the same at 16³ in float64, where the iterations must agree within one;
   the distributed projection PC's apply at 32³ against the one-device PC's
   (1e-4);
   (d) wave_implicit --shard rows --pc circulant2l on phase 19b's welded
   Kershaw-tet 16³ file, 2 steps: the halo window route, converged. Every
   sharded driver runs captured (its steps, or its GMRES, as CUDA-graph
   replays with the NCCL collectives inside) and again with capture off:
   graph replays in the first, the same iterations, states within 1e-6;
   circulant2l's float32 GMRES iterations at 64³ equal the uncaptured
   runs' recorded in PERF.md (107 and 62 at the slab solve's "high" tier;
   106 and 62 when every tier ran fp32; pbjacobi's recorded 744 and 816
   are printed beside its own, which move between calls). A chunk of 20
   slab steps as one graph, its global norms inside against one eager
   all-reduce after it: the wall per step of each. Every
   sharded operator's ms per apply (the distributed FFT and the all-matmul
   slab block solve too) by CUDA events and CUDA-graph replay, beside its
   one-device counterpart, with the NCCL records torch.profiler
   shows per apply (one rank: no scaling figure); an all-reduce's cost per
   call. The group is closed before the last line.
21. the device-resident solves: for paths B, D, F, G, H, I and J as the
   phases above ran them (no new run), the iterations per step, the wall of
   a warm step, the first step's wall and the seconds of its warm-ups and
   captures, the device time per step and busy share (torch.profiler), the
   graph replays and host waits per iteration, the masked iterations and
   their kernel launches, beside the host loops' figures from before the
   capture (copied from PERF.md, not measured by this script). Every one of them must have run
   its solves as graph replays. (Phase 5 also runs 2 path-B steps captured
   against 2 uncaptured (utils.graphs.CAPTURE false): equal iterations,
   states within 1e-6; phase 10 the same for path D, and one captured
   path-D solve under torch.cuda.set_sync_debug_mode("error"), which raises
   on any synchronising call; phases 5 and 10 time paths B and D at
   lookahead 0 too; phase 18 prints the device memory with the solver's
   graphs and after it released them.)
22. the captured steps (utils.graphs.CapturedStep, the JAX package's jitted
   steps and lax.scan chunks): for paths A, C, E, the dctfft and blockfft
   steps and the diffusion FFT step as the phases above measured them, the
   wall per step (the time loop's own, each step or chunk ended by its
   synchronisation) and the device time per step (torch.profiler), with
   capture off and captured. Phases 1 to 20 print their seconds.
23. the port's measurement programs (circulantpreconditioner_tpu_torch/
   bench.py and bench_suite.py, paired differenced chains on the card): the
   flagship in full, as `python -m circulantpreconditioner_tpu_torch.bench`
   runs it (the dense collapse at 100³ under the 1e-4 residual gate and its
   bound, the staged solve with and without K3 and the fused solve, K1), and
   a quick mode of the suite's rows wave_explicit, spmv and wave_implicit
   (gridmg, its iteration gate kept) at Kershaw 16³ with short chains; their
   JSON lines, and their K1 to K4 launches in the kernels line (the
   flagship at "high": one K4 launch per solve).
24. the grid V-cycle on z-slabs (parallel/vcycle_dist.py), run last in phase
   20's world of one NCCL rank (its seconds printed apart) at Kershaw 32³ in
   float32: K2 at the path's shape (the rank's slab and its two halo planes)
   against its plain version (1e-5); the V-cycle's apply against
   GridVCyclePC.apply_fm (1e-5 relative); the row-sharded field-major GMRES
   step with it (K2 on the rank's slab and halo planes): 33 iterations,
   equal to the one-device step's, the same K2 launches per warm step, and
   captured against capture off (the same iterations, states within 1e-6,
   no replay with capture off); then bench_suite.py's distributed row
   (`dist_worker`) at world size 1 with chains of 1 and 3: its gates held
   with the PC's slab solve at "highest" (r05's circulant2l count came from
   fp32 arithmetic on virtual CPU devices); at the JAX row's "high" its
   count is printed beside and its other gates held. Its K2 launches on the
   sharded step go into the kernels line.
25. the precision tiers (kernel K4, csrc/tier_matmul.cu: "high" as bf16×3,
   "default" as one bf16 pass): K4 against its plain version at the main
   paths' shapes (the flagship collapse, the staged solve's x, y and z
   stages at 100³, the DCT sweeps at 64³ with one matrix per component and
   on the cell-major state's view, the block solve's x stage, a ragged
   product, a second K chunk and column tile) in one and three passes,
   max|o_K4 − o_plain| ≤ 1e-5 · max|o_plain|; at the flagship shape each
   form (K4 in both, fp32) against float64; its time at each shape by
   CUDA-graph replay beside fp32's, and at the flagship shape beside its
   plain version, fp32 torch.matmul (cuBLAS, the library yardstick) and its
   bound (the bytes); the flagship at each tier (time, ‖Cx − b‖/‖b‖ < 1e-4
   at "highest" and "high", one K4 launch per solve at "high" and
   "default", none at "highest"); main path B at "high": periodic 100³
   transport, GMRES right-preconditioned by the dense collapse, 3 steps
   through run_time_loop, ≤ 3 iterations each, K4 launched once per
   iteration and cycle, the state within 1e-4 of the cuFFT solve's; the
   wall 64³ DCT direct step at "high" under its tier's gate 1e-3; and the
   Kershaw 16³ dct2l, dct2lm and circulant2l (use_matmul_dft, the JAX
   default) GMRES counts at "high" and in fp32 beside the JAX suite's r05.
26. kernel K5 (csrc/vcycle_sweep.cu, the grid V-cycle's levels below the
   fine one) on path D's hierarchy at Kershaw 64³ (its 32³ and 16³ Galerkin
   levels, float32): each stage (smoothing, residual and restriction,
   prolongation and post-smoothing; the restriction and the sweep in both
   layouts of the coarse vector, and the sweep without prolongation)
   against its plain version in aggregation_pc.py, max|y_K5 − y_plain| ≤
   1e-5 · max|y_plain|; a whole apply_fm against the same hierarchy on the
   V-cycle's generic stages (1e-4), with three K5 launches a level; each
   stage, and the coarse part of an apply (six K5 launches and the bottom
   gemv), timed by CUDA-graph replay beside its plain version and its bound
   by bytes. Phase 9 checks K5's launches on path D (three a level visit,
   two fused visits and none plain a V-cycle apply), phase 18 on path J
   (three a fused visit, none plain).
27. kernel K6 (csrc/block_jacobi.cu, point-block Jacobi on field-major
   vectors, float32, b = 4) at the benchmark cells' shapes and layouts:
   Kershaw 64³'s fine level (Dinv cell-major, the V-cycle's) and its
   pbjacobi_fm (field-major), Kershaw-tet 50³'s site level (cell-major, 6
   cells a site) and its pbjacobi_fm ((6, 4, 4, S)); each as the
   pre-smoothing ω·Dinv·r and the fused post-sweep zn + ω·Dinv·(r − y),
   against its plain version (the einsum), max|y_K6 − y_plain| ≤ 1e-5 ·
   max|y_plain| (float64 at 64³: 1e-12); each timed by CUDA-graph replay
   beside its plain version and its bound by bytes, with its inputs rotated
   through copies that overflow the 50 MB L2 (as in a step, where K2 and
   GMRES evict them) and again warm. Phase 9 checks K6's launches on path D
   (two an apply: the fine level's pre- and post-smoothing, none plain),
   phase 18 on path J (two an apply at the site level).
28. kernel K7 (csrc/supercell_stencil.cu, the tet meshes' supercell SpMV in
   the wave normal form): against its plain version (SupercellNormalOperator.
   plain_fm on the card) in float32 and float64 at Kershaw-tet 12³ and in
   float32 at 50³, max|y_K7 − y_plain| ≤ 1e-5 · max|y_plain| (float64:
   1e-12), each also against the block-sparse SupercellStencilOperator and,
   cell-major, against the assembled BSR matvec; timed at 50³ by CUDA-graph
   replay with its inputs rotated past the L2, and warm, beside the plain
   version, the block-sparse stencil and its least bytes (the bound
   supercell_spmv_roofline reads, 35.7 µs). Phase 18 checks K7's launches on
   path J (one an apply, none plain).
Paths G to J launch none of K1 to K4 (path J's grid V-cycle runs its levels
below the site level in K5), phase 20's sharded drivers none of K1 to K3
(circulant2l's slab solve runs K4 at "high"); their launch counts are
printed and checked. K1 to K7 count their launches per graph replay
(utils/graphs.py). The iterations a
solve queued past its stop (utils.graphs.STATS.masked) run masked and
launch their kernels all the same: the counts hold them, each check adds
the masked iterations' launches (per iteration, as a kept one) to what the
kept iterations need, and the masked launches are printed apart.

Then one JSON line on the kernels (`ms`, `plain_ms` and `library_ms` are device
time per call by CUDA-graph replay, `events_ms` the CUDA-event time of calls
enqueued one by one, K1's `pass_ms` its passes one by one, K3's `stages` its
numbers at the 128³ and 100³ stage shapes (the top-level ones are the 128³
stage's); `bound_ms` is the least time of the function each kernel computes,
by its cheapest known algorithm, and `algorithm_bound_ms` that of the kernel's
own algorithm; `masked_launches` is the part of `launches` made by iterations
queued past a stop; K5's `ms`, `plain_ms` and `bound_ms` are those of the
coarse part of one 64³ V-cycle apply, its `stages` each stage's at 32³ and
16³, and it has no library counterpart; K6's those of Kershaw 64³'s fused
post-sweep with its inputs out of L2, its `forms` every shape's and form's,
and its plain version, the einsum, is the library call; K7's those of the
50³ apply with its inputs out of L2, the block-sparse stencil its library
call), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, and the script exits non-zero without that line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()

import numpy as np
import torch

N = 100  # the reference's largest registered grid ("gros calcul")
TOL_KERNEL = 1e-5  # max|x_kernel − x_plain| / max|x_plain|
TOL_RESIDUAL = 1e-4  # bench.py's residual gate
NW = 64  # the Kershaw grid bench_suite.py measures the wave system at
NJ = 50  # the Kershaw-tet rung of bench_suite.py: 6·50³ = 750,000 tets
TOL_K2 = {torch.float32: 1e-5, torch.float64: 1e-12}  # max|y_K2 − y_plain| / max|y_plain|
TOL_K3 = TOL_K2  # max|o_K3 − o_plain| / max|o_plain|
PEAK_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
PEAK_TF32 = 495e12  # H100 SXM dense TF32 on the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


_LAP = [T_START]


def lap(phases: str) -> None:
    """Print the seconds since the previous lap (or the start)."""
    now = time.perf_counter()
    print(f"[seconds] phases {phases}: {now - _LAP[0]:.1f} s", flush=True)
    _LAP[0] = now


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate of their type (fp32 unless given) and the
    bytes over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def graph_ms(fn, calls: int = 20, repeats: int = 7) -> float:
    """Device ms per call with no launch gaps: `calls` calls captured in one
    CUDA graph, replayed under CUDA events, median of `repeats` replays. For
    kernels of tens of µs, where the host's enqueue time hides the kernel
    from CUDA events and a short profiler window can drop or add records."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture requires
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return float(np.median([time_ms(graph.replay, 1) / calls for _ in range(repeats)]))


def median_ms(runs: dict, calls: int = 20, repeats: int = 7) -> dict[str, float]:
    """CUDA-event ms per call of each run: the median of `repeats` timings of
    `calls` calls, interleaved so that drift falls on every run alike."""
    for fn in runs.values():  # warm-up
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    samples: dict[str, list[float]] = {name: [] for name in runs}
    for _ in range(repeats):
        for name, fn in runs.items():
            samples[name].append(time_ms(fn, calls))
    return {name: float(np.median(v)) for name, v in samples.items()}


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


class Profile(dict):
    """Device ms per call by kernel name; `counts` holds the launches the
    profiler recorded for each name."""

    counts: dict[str, int]


def device_profile(fn, calls: int = 20) -> Profile:
    """Device ms per call by kernel name, from torch.profiler: kernels and
    copies only (an `aten::` op would count its kernels a second time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if not e.key.startswith("aten::") and e.self_device_time_total > 0]
    out = Profile({e.key: e.self_device_time_total / 1e3 / calls for e in events})
    out.counts = {e.key: e.count for e in events}
    return out


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


def tensor_core_instructions(lib_path, nvcc: str, kernel: str) -> dict[str, int]:
    """HMMA and HGMMA instructions in the SASS of each function of the built
    library whose name holds `kernel` (cuobjdump beside nvcc), by function:
    the mangled template arguments shortened to <...>."""
    import re
    from pathlib import Path

    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            name = None
            if kernel in fn:  # template arguments: bools, mangled as Lb0E / Lb1E
                m = re.match(r"I((?:Lb[01]E)+)E", fn[fn.index(kernel) + len(kernel):])
                args = re.findall(r"Lb([01])E", m.group(1)) if m else []
                name = f"{kernel}<{', '.join('true' if b == '1' else 'false' for b in args)}>"
                counts[name] = 0
        elif name is not None and re.search(r"\bHG?MMA\.", line):
            counts[name] += 1
    return counts


def k1_pass_errors(b: torch.Tensor, plan) -> list[float]:
    """Each of K1's five passes launched alone on the plain executor's output
    of the pass before (k1_passes_reference): max|kernel − plain| over
    max|plain| per pass."""
    from circulantpreconditioner_tpu_torch.ops.fused_circulant import (
        k1_launch,
        k1_passes_reference,
        k1_scratch,
    )

    nz, ny, nx = plan.shape_zyx
    spec = nz * ny * (nx // 2 + 1)
    ref = k1_passes_reference(b, plan)
    out, scratch = torch.empty_like(b), k1_scratch(b, plan)
    s1, s2 = (torch.view_as_complex(scratch[i * 2 * spec:(i + 1) * 2 * spec].view(-1, 2))
              .view(ref[0].shape) for i in range(2))
    buffers = [s1, s2, s1, s2, out]
    rels = []
    for i, buf in enumerate(buffers):
        if i > 0:
            buffers[i - 1].copy_(ref[i - 1])
        k1_launch(b, plan, out, scratch, 1 << i)
        torch.cuda.synchronize()
        rels.append(((buf - ref[i]).abs().max() / ref[i].abs().max()).item())
    return rels


def k1_flops(plan, row_pairs: bool) -> float:
    """Flops of K1's FFT stages on its plan: per radix-R stage, n/R butterflies
    per line of (R − 1) twiddle products (6 flops each, none when Ns = 1)
    and the butterfly's adds and constant products; 8·p flops per output of
    a leftover length-p DFT; × 1/Λ at 6 flops per spectral point. row_pairs:
    the plane form, which runs two real rows as one complex x line."""
    butterfly = {2: 4, 3: 16, 4: 16, 5: 40}
    nz, ny, nx = plan.shape_zyx
    nxr = nx // 2 + 1

    def line(p) -> float:
        total = 0.0
        for R, ns, _ in p.stages():
            total += (p.n / R) * (6 * (R - 1) * (ns > 1) + butterfly[R]) if R in butterfly \
                else 8.0 * R * p.n
        return total

    px, py, pz = plan.axes
    x_lines = nz * (ny + 1) // 2 if row_pairs else nz * ny
    return (2 * x_lines * line(px) + 2 * nz * nxr * line(py) + 2 * ny * nxr * line(pz)
            + 6.0 * nz * ny * nxr)


def k2_expected_launches(its: list[int], pc_fine_applies: int, restart: int = 30,
                         masked: int = 0) -> int:
    """K2 launches of the field-major GMRES steps that took `its` iterations:
    per solve one initial residual, one residual per restart cycle and one
    matvec per iteration, plus `pc_fine_applies` fine-level applies (the
    V(1,1) cycle's two residuals) per preconditioner apply, which come once
    per iteration and once per cycle (right preconditioning); and a matvec
    and a preconditioner apply for each of the `masked` iterations queued
    past a stop."""
    total = masked * (1 + pc_fine_applies)
    for i in its:
        cycles = -(-i // restart)
        total += 1 + cycles + i + pc_fine_applies * (i + cycles)
    return total


def k1_expected_launches(its: list[int], masked: int, forced: int = 0,
                         restart: int = 30) -> int:
    """K1 launches of right-preconditioned GMRES steps with K1 as M: one M
    per iteration, masked ones included, and one per cycle (the correction),
    the `forced` cycles that the true-residual check ran included."""
    return masked + forced + sum(i + -(-i // restart) for i in its)


def uncaptured_steps(make_solver, U0, steps: int = 2):
    """`steps` solves U ← solve(U, U) from U0 by a solver made and run with
    capture off (utils.graphs.CAPTURE false: every step function eager);
    returns the last U and the iterations per step."""
    from circulantpreconditioner_tpu_torch.utils import graphs

    graphs.CAPTURE = False
    try:
        solver, U, its = make_solver(), U0, []
        for _ in range(steps):
            r = solver(U, U)
            U = r.x
            its.append(r.iters)
    finally:
        graphs.CAPTURE = True
    return U, its


def wave_phases(dev: torch.device, smi: str) -> dict:
    """Phases 7 to 10: kernel K2 and the wave system's main paths C and D at
    Kershaw 64³. Returns K2's entry of the kernels line, the 64³ mesh, the
    implicit model and path D's iterations, K2 launches and final state."""
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
    from circulantpreconditioner_tpu_torch.ops.block_jacobi import BlockJacobiKernel
    from circulantpreconditioner_tpu_torch.ops.vcycle_sweep import VCycleSweepKernel
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
        # the driver's step (K2 inside), one graph replay per step and one per
        # chunk of 20, against capture off
        for chunk in (None, 20):
            captured_against_eager(f"C wave_explicit Kershaw {NW}^3", me.explicit_stepper_fm,
                                   me.pack_fm(me.initial_state()), me.dt, smi, steps=20,
                                   chunk=chunk, per_step={"K2": 1})

        # --- 9: main path D, the implicit wave driver with the grid V-cycle -
        PlaneStencilMatvec.launches = FusedCirculantSolver.launches = 0
        VCycleSweepKernel.launches = BlockJacobiKernel.launches = 0
        t0 = time.perf_counter()
        res_i, snap = solve_run(lambda: wave_implicit.main(common + ["--ntmax", "2", "--pc",
                                                                     "gridmg"]))
        wall_i = time.perf_counter() - t0
        k2_i, k5_i = PlaneStencilMatvec.launches, VCycleSweepKernel.launches
        k6_i = BlockJacobiKernel.launches
        its = [d["extras"][0] for d in res_i.diagnostics]
        conv = [d["extras"][2] for d in res_i.diagnostics]
        expected = k2_expected_launches(its, pc_fine_applies=2, masked=snap["masked"])
        print(f"[9 main path D] wave_implicit Kershaw {NW}^3 --pc gridmg: iterations {its}, "
              f"converged {conv}, K2 launches {k2_i} (GMRES matvecs "
              f"{k2_expected_launches(its, 0)} + V-cycle fine level "
              f"{k2_expected_launches(its, 2) - k2_expected_launches(its, 0)} + the "
              f"{snap['masked']} masked iterations' {snap['masked_launches'][1]}), ms/step "
              f"{[round(s * 1e3, 3) for s in res_i.step_seconds]}, driver wall {wall_i:.2f} s",
              flush=True)
        check(len(its) == 2 and all(conv), f"wave_implicit gridmg: iterations {its}, "
              f"converged {conv}")
        check(k2_i == expected, f"wave_implicit gridmg: {k2_i} K2 launches, expected "
              f"{expected} from the iterations {its} and {snap['masked']} masked")
        # K5: the 32^3 and 16^3 levels of every V-cycle apply, three launches each
        pc_applies = (k2_expected_launches(its, 1, masked=snap["masked"])
                      - k2_expected_launches(its, 0, masked=snap["masked"]))
        fused, plain = snap["vcycle_levels_fused"], snap["vcycle_levels_plain"]
        print(f"[9 main path D] K5 launches {k5_i} for {pc_applies} V-cycle applies: coarse "
              f"level visits fused {fused}, plain {plain} (2 fused an apply, 3 launches a "
              f"visit expected)", flush=True)
        check(fused == 2 * pc_applies and plain == 0 and k5_i == 3 * fused,
              f"wave_implicit gridmg: {k5_i} K5 launches, level visits fused {fused} and plain "
              f"{plain}, for {pc_applies} V-cycle applies")
        # K6: the fine level's pre- and post-smoothing of every apply
        bj_f, bj_p = snap["block_jacobi_fused"], snap["block_jacobi_plain"]
        print(f"[9 main path D] K6 launches {k6_i} for {pc_applies} V-cycle applies: "
              f"block-Jacobi applies fused {bj_f}, plain {bj_p} (2 fused an apply)", flush=True)
        check(bj_f == 2 * pc_applies and bj_p == 0 and k6_i == bj_f,
              f"wave_implicit gridmg: {k6_i} K6 launches, block-Jacobi applies fused {bj_f} and "
              f"plain {bj_p}, for {pc_applies} V-cycle applies")
        record_loop("D", snap, its=its, first_ms=res_i.step_seconds[0] * 1e3,
                    capture_s=snap["capture_seconds"])
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
        res_p, snap_p = solve_run(lambda: wave_implicit.main(
            common[:2] + ["16", "16", "16"] + common[5:] + ["--ntmax", "2", "--pc", "pbjacobi"]))
        k2_p = PlaneStencilMatvec.launches
        its_p = [d["extras"][0] for d in res_p.diagnostics]
        conv_p = [d["extras"][2] for d in res_p.diagnostics]
        print(f"[9 driver] wave_implicit Kershaw 16^3 --pc pbjacobi: iterations {its_p}, "
              f"converged {conv_p}, K2 launches {k2_p} ({snap_p['masked_launches'][1]} of them "
              f"by {snap_p['masked']} masked iterations)", flush=True)
        check(len(its_p) == 2 and all(conv_p) and bool(torch.isfinite(res_p.state).all()),
              f"wave_implicit pbjacobi: iterations {its_p}, converged {conv_p}")
        check(k2_p == k2_expected_launches(its_p, 0, masked=snap_p["masked"]),
              f"wave_implicit pbjacobi: {k2_p} K2 launches for iterations {its_p}")

    # --- 10: times at NW^3 -------------------------------------------------
    Wn = mi.normal_operator
    g = torch.as_tensor(rng.random((4, NW**3)), device=dev, dtype=torch.float32)
    runs = {"K2": lambda: plane_stencil_cuda(Wn, g), "K2 plain": lambda: Wn.matvec_fm(g)}
    ms = median_ms(runs, calls=50)
    gms = {name: graph_ms(fn, calls=50) for name, fn in runs.items()}
    kernel_ms = {name: device_ms(fn, calls=50) for name, fn in runs.items()}
    nbytes = (4 + 16 + 6 + 18 + 4) * 4 * NW**3  # x, diag, s, n̂, y in float32
    print(f"[10 times] Kershaw {NW}^3 float32, one apply of D moves {nbytes / 1e6:.1f} MB; "
          f"CUDA events: median of 7 x 50 back-to-back applies (the L2 stays warm); "
          f"kernel time: torch.profiler over 50 applies; on {smi}:", flush=True)
    for name in runs:
        print(f"[10 times]   {name}: {ms[name]:.4f} ms/apply, kernel time "
              f"{kernel_ms[name]:.4f} ms/apply = {nbytes / kernel_ms[name] / 1e6:.1f} GB/s, "
              f"CUDA-graph replay {gms[name]:.4f} ms/apply", flush=True)
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
        if name == "implicit gridmg":
            record_loop("D", warm_ms=wall, device_ms=busy, busy=100 * busy / wall)
        print(f"[10 busy] {name} step at {NW}^3: wall {wall:.3f} ms (median of {reps}), "
              f"device {busy:.3f} ms/step (profiled over {reps} steps), busy "
              f"{100 * busy / wall:.1f} %; largest: "
              + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top), flush=True)
    # path D's step: the captured solve with every synchronising call an error
    # (set_sync_debug_mode), then 2 steps captured against 2 uncaptured
    step_d, G0_d, _ = steps["implicit gridmg"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        G_d, _, its_d, _, conv_d = step_d(G0_d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(conv_d, "path D's step under set_sync_debug_mode('error') did not converge")
    G_c, its_c = G0_d, []
    for _ in range(2):
        G_c, _, it_c, _, _ = step_d(G_c)
        its_c.append(it_c)
    G_e, its_e = uncaptured_steps(
        lambda: make_gmres(mi.implicit_matvec_fm(), pc_k2.apply_fm, side="right"), G0_d)
    rel = ((G_c - G_e).abs().max() / G_e.abs().max()).item()
    print(f"[10 device loop] path D: one captured solve under "
          f"torch.cuda.set_sync_debug_mode('error'): {its_d} iterations, no synchronising call; "
          f"2 steps captured against uncaptured: iterations {its_c} and {its_e}, "
          f"max|dG|/max|G| {rel:.3e} (tol 1e-6)", flush=True)
    check(its_c == its_e and rel <= 1e-6, f"path D captured {its_c} against uncaptured "
          f"{its_e}, states {rel:.3e} apart")
    d0 = make_gmres(mi.implicit_matvec_fm(), pc_k2.apply_fm, side="right")
    d0._lookahead = 0
    l0 = warm_profile(lambda G: d0(G, G), G0_d, reps=2)
    record_loop("D", lookahead0=l0)
    print(f"[10 device loop] path D at lookahead 0: wall {l0['warm_ms']:.3f} ms, device "
          f"{l0['device_ms']:.3f} ms, busy {l0['busy']:.1f} % (lookahead 1 above)", flush=True)
    print(f"[10 times]   explicit step (wave_explicit, 20 steps): median "
          f"{np.median(res_e.step_seconds) * 1e3:.4f} ms; implicit step (wave_implicit "
          f"--pc gridmg, 2 steps): median {np.median(res_i.step_seconds) * 1e3:.3f} ms",
          flush=True)
    # K2's library yardstick: the same field-major operator as one CSR
    # product (cuSPARSE), the cell-major BSR permuted to field-major order
    import scipy.sparse as sp

    N = NW**3
    perm = (np.arange(N)[None, :] * 4 + np.arange(4)[:, None]).reshape(-1)  # fm → cm index
    A = sp.csr_matrix(mi.divergence.to_scipy()[perm][:, perm])
    A_t = torch.sparse_csr_tensor(torch.as_tensor(A.indptr), torch.as_tensor(A.indices),
                                  torch.as_tensor(A.data, dtype=torch.float32),
                                  size=A.shape, device=dev)
    x = g.reshape(-1)
    y_lib = A_t @ x
    lib_rel = ((y_lib - Wn.matvec_fm_flat(x)).abs().max() / y_lib.abs().max()).item()
    check(lib_rel <= 1e-5, f"the CSR yardstick disagrees with K2's plain version: {lib_rel:.3e}")
    lib = median_ms({"csr": lambda: A_t @ x}, calls=50)["csr"]
    lib_graph = graph_ms(lambda: A_t @ x, calls=50)
    lib_kernel = device_ms(lambda: A_t @ x, calls=50)
    k2_bound, k2_by = bound(N * (2 * 4 * 4 + 6 * 20), nbytes)
    print(f"[10 times]   library yardstick, torch.sparse_csr_tensor @ x ({A.nnz} stored "
          f"entries): {lib:.4f} ms/apply, kernel time {lib_kernel:.4f} ms/apply, "
          f"CUDA-graph replay {lib_graph:.4f} ms/apply "
          f"(agrees with the plain version to {lib_rel:.1e}); K2's bound {k2_bound:.4f} ms "
          f"({k2_by})", flush=True)
    # "launches" counts the two main paths at NW^3; each count was reset
    # before its own driver run and checked after it
    return {"launches": k2_e + k2_i, "masked_launches": snap["masked_launches"][1],
            "launches_by_path": {f"C wave_explicit {NW}^3": k2_e,
                                 f"D wave_implicit gridmg {NW}^3": k2_i,
                                 "wave_implicit pbjacobi 16^3": k2_p},
            "max_abs_err": k2_err, "ms": gms["K2"], "plain_ms": gms["K2 plain"],
            "events_ms": ms["K2"], "bound_ms": k2_bound, "bound_by": k2_by,
            "algorithm_bound_ms": k2_bound, "library_ms": lib_graph}, mesh, mi, {
                "its": its, "k2": k2_i, "k5": k5_i, "k6": k6_i, "state": res_i.state,
                "state_c": U_e}


def fft_pc_phases(dev: torch.device, smi: str, mesh64, mi) -> dict:
    """Phases 11 to 14: kernel K3, main path E (the staged DFT solve through
    K3) and main path F (the FFT projection preconditioners). mesh64 and mi
    are the Kershaw NW^3 mesh and implicit wave model of phases 7 to 10.
    Returns K3's entry of the kernels line."""
    import functools
    import time

    from circulantpreconditioner_tpu_torch.drivers import transport_implicit, wave_implicit
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.models import (
        TransportEquation,
        WaveSystem,
        run_time_loop,
    )
    from circulantpreconditioner_tpu_torch.models.transport import _direct_step, _identity_plus
    from circulantpreconditioner_tpu_torch.ops.assembly import wave_block_stencil
    from circulantpreconditioner_tpu_torch.ops.dct_wave import DCTBlockWaveSolver
    from circulantpreconditioner_tpu_torch.utils.graphs import CapturedStep
    from circulantpreconditioner_tpu_torch.ops.circulant import (
        BlockCirculantOperator,
        CirculantTransportOperator,
    )
    from circulantpreconditioner_tpu_torch.ops.complex_matmul import (
        ComplexMatmulKernel,
        complex_matmul_cuda,
        complex_matmul_reference,
    )
    from circulantpreconditioner_tpu_torch.ops.dft_matmul import (
        MatmulBlockCirculantSolver,
        MatmulCirculantSolver,
    )
    from circulantpreconditioner_tpu_torch.ops.plane_stencil import PlaneStencilMatvec
    from circulantpreconditioner_tpu_torch.solvers import make_gmres
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import (
        DCTBlockProjectionPC,
        _try_window,
        build_projection_matrices,
        derive_grid_context,
    )

    f32 = dict(device=dev, dtype=torch.float32)
    rng = np.random.default_rng(11)

    def planes(shape, dtype):
        return [torch.as_tensor(rng.standard_normal(shape), device=dev, dtype=dtype)
                for _ in range(2)]

    # --- 11: K3 against its plain version ----------------------------------
    k3_shapes = {"128^3 stage": (8320, 128, 128), "100^3 stage": (5100, 100, 100),
                 "ragged": (37, 45, 29), "tiling edges": (2113, 129, 136)}
    k3_err = 0.0
    for dtype in (torch.float32, torch.float64):
        for label, (M, K, Nn) in k3_shapes.items():
            a, b = planes((M, K), dtype), planes((K, Nn), dtype)
            o = complex_matmul_cuda(*a, *b)
            torch.cuda.synchronize()
            p = complex_matmul_reference(*a, *b)
            err = max((o[i] - p[i]).abs().max().item() for i in range(2))
            rel = err / max(p[i].abs().max().item() for i in range(2))
            print(f"[11 K3 vs plain] {label} ({M},{K})·({K},{Nn}) {str(dtype)[6:]}: "
                  f"max|do|/max|o| {rel:.3e} (tol {TOL_K3[dtype]:g})", flush=True)
            check(bool(torch.isfinite(o[0]).all() and torch.isfinite(o[1]).all())
                  and rel <= TOL_K3[dtype], f"K3 disagrees with its plain version at "
                  f"{label} {dtype}: {rel:.3e}")
            if dtype == torch.float32:
                k3_err = max(k3_err, err)

    # K3 and its plain version against float64, with B the forward DFT matrix
    # (the staged solver's operand): 3×TF32 is to be as accurate as fp32
    for label in ("128^3 stage", "100^3 stage"):
        M, n, _ = k3_shapes[label]
        k = np.arange(n)
        W = np.exp(-2j * np.pi * np.outer(k, k) / n)
        a64 = planes((M, n), torch.float64)
        b64 = [torch.as_tensor(x, device=dev) for x in (W.real, W.imag)]
        want = complex_matmul_reference(*a64, *b64)
        scale = max(w.abs().max().item() for w in want)
        a32, b32 = [x.float() for x in a64], [x.float() for x in b64]
        errs = {name: max((o[i].double() - want[i]).abs().max().item() for i in range(2)) / scale
                for name, o in (("K3", complex_matmul_cuda(*a32, *b32)),
                                ("plain fp32", complex_matmul_reference(*a32, *b32)))}
        print(f"[11 K3 vs float64] {label}, B the DFT matrix: max|do|/max|o| K3 "
              f"{errs['K3']:.3e}, plain fp32 {errs['plain fp32']:.3e} (K3's tol 2e-6)", flush=True)
        check(errs["K3"] <= 2e-6, f"K3 is off float64 at {label}: {errs['K3']:.3e}")

    # --- 12: main path E, the staged DFT solve through K3 --------------------
    h = 1.0 / 128
    a_xyz = np.array([1.0, 0.5, 0.25])
    dt128 = (1e3 / 3) * (h / 6) / np.linalg.norm(a_xyz)
    configs = {"128^3 a=(1,0.5,0.25)": ((128,) * 3, tuple(a_xyz[::-1] * dt128 / h)),
               "100^3 flagship": ((N,) * 3, flagship_lambdas())}
    solvers, k3_solves = {}, 0
    for label, (shape, lams) in configs.items():
        sk = MatmulCirculantSolver.create(shape, lams, use_kernel=True, **f32)
        se = MatmulCirculantSolver.create(shape, lams, **f32)
        op = CirculantTransportOperator.create(shape, lams, **f32)
        b = torch.as_tensor((rng.random(shape) * 50 + 600).astype(np.float32), device=dev)
        before = ComplexMatmulKernel.launches
        xk = sk.solve(b)
        torch.cuda.synchronize()
        per_solve = ComplexMatmulKernel.launches - before
        k3_solves += per_solve
        xe = se.solve(b)
        rel = ((xk - xe).abs().max() / xe.abs().max()).item()
        res = rel_residual(op, xk, b)
        print(f"[12 main path E] {label}: K3 launches per solve {per_solve}, "
              f"max|x_K3 - x_einsum|/max|x| {rel:.3e} (tol 1e-5), ||Cx-b||/||b|| {res:.3e} "
              f"(tol {TOL_RESIDUAL:g})", flush=True)
        check(per_solve == 4, f"path E at {label}: {per_solve} K3 launches per solve")
        check(rel <= 1e-5 and res < TOL_RESIDUAL, f"path E at {label}: {rel:.3e}, {res:.3e}")
        solvers[label] = (sk, se, b)
    mesh = cartesian_mesh(((-0.5, 0.5),) * 3, (N, N, N), periodic=True)
    model = TransportEquation(mesh, (1.0, 0.0, 0.0), cfl=1e3 / 3, **f32)
    op = model.fft_operator
    sk = MatmulCirculantSolver.create(op.shape_zyx, op.lambdas_zyx, use_kernel=True, **f32)
    u0 = model.initial_state()
    ComplexMatmulKernel.launches = 0
    res_e = run_time_loop(CapturedStep(functools.partial(_direct_step, sk)), u0, model.dt,
                          tmax=1e9, ntmax=5, log=None)
    k3_steps = ComplexMatmulKernel.launches
    u_ref = u0
    fft_step = model.fft_stepper("fft")
    for _ in range(5):
        u_ref, _ = fft_step(u_ref)
    dev_e = ((res_e.state - u_ref).abs().max() / u_ref.abs().max()).item()
    print(f"[12 main path E] 5 transport steps at 100^3 through run_time_loop: K3 launches "
          f"{k3_steps}, ms/step {[round(t * 1e3, 3) for t in res_e.step_seconds]}, "
          f"max|u_K3 - u_cuFFT|/max|u| {dev_e:.3e} (tol 1e-5)", flush=True)
    check(res_e.iterations == 5 and k3_steps == 20, f"path E steps: {res_e.iterations} steps, "
          f"{k3_steps} K3 launches")
    check(bool(torch.isfinite(res_e.state).all()) and dev_e <= 1e-5,
          f"path E disagrees with the cuFFT solve: {dev_e:.3e}")
    # the same step, one graph replay per step (K3's four launches inside),
    # against capture off
    captured_against_eager(f"E staged DFT through K3 {N}^3",
                           lambda: CapturedStep(functools.partial(_direct_step, sk)), u0,
                           model.dt, smi, per_step={"K3": 4})

    # --- 13: main path F, the FFT projection preconditioners ---------------
    host = {}
    n_xyz, _, _, bbox = derive_grid_context(mesh64, [0.0] * 3, mi.dt)
    t0 = time.perf_counter()
    P, P_back = build_projection_matrices(mesh64, n_xyz, bbox, **f32)
    host["cKDTree sampling, P and P_back"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    windows = _try_window(P), _try_window(P_back)
    host["their windows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    coarse = DCTBlockProjectionPC(mesh64, mi.dt, mi.c0, **f32)
    torch.cuda.synchronize()
    host["the whole DCT projection PC"] = time.perf_counter() - t0
    print(f"[host build] Kershaw {NW}^3 projection, seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
          + f"; projection {coarse.projection}, grid {coarse.n_xyz}, P {tuple(P.shape)} with "
          f"{P.indices.numel()} entries, windows of "
          f"{[w.window_bytes / 2**20 if w is not None else None for w in windows]} MiB",
          flush=True)
    JAX_RECORDS = {"dct2lm 64^3": "108 (PROFILE.md:199)",
                   "circulant2l 16^3": "62 (results/bench_suite_r05.json:155)",
                   "dct2l 16^3": "43 (results/bench_suite_r05.json:153)"}
    k3_by_path = {"E transport 100^3, 5 steps": k3_steps,
                  "E single solves at 128^3 and 100^3": k3_solves}
    with tempfile.TemporaryDirectory() as out_dir:
        common = ["--tmax", "1e9", "--device", "cuda", "--result-dir", out_dir]
        kershaw = ["--mesh-family", "kershaw"]
        PlaneStencilMatvec.launches = 0
        t0 = time.perf_counter()
        res_f, snap = solve_run(lambda: wave_implicit.main(kershaw + [str(NW)] * 3 + common
                                                           + ["--ntmax", "2", "--pc", "dct2lm"]))
        wall_f = time.perf_counter() - t0
        k2_f = PlaneStencilMatvec.launches
        its = [d["extras"][0] for d in res_f.diagnostics]
        conv = [d["extras"][2] for d in res_f.diagnostics]
        expected = k2_expected_launches(its, pc_fine_applies=1, masked=snap["masked"])
        print(f"[13 main path F] wave_implicit Kershaw {NW}^3 --pc dct2lm: iterations {its} "
              f"(the JAX package's record on its TPU: {JAX_RECORDS['dct2lm 64^3']}), converged "
              f"{conv}, K2 launches {k2_f} (expected {expected}: a matvec per iteration and "
              f"per restart, one more in every multiplicative apply; "
              f"{snap['masked_launches'][1]} of them by {snap['masked']} masked iterations), "
              f"ms/step "
              f"{[round(t * 1e3, 3) for t in res_f.step_seconds]}, driver wall {wall_f:.2f} s",
              flush=True)
        check(len(its) == 2 and all(conv), f"dct2lm: iterations {its}, converged {conv}")
        check(k2_f == expected, f"dct2lm: {k2_f} K2 launches, expected {expected}")
        record_loop("F", snap, its=its, first_ms=res_f.step_seconds[0] * 1e3,
                    capture_s=snap["capture_seconds"])
        check(bool(torch.isfinite(res_f.state).all()), "dct2lm: non-finite state")
        Wi = mi.normal_operator
        A_plain = functools.partial(_identity_plus, Wi.matvec_fm_flat)
        pj_fm = pcs.pbjacobi_fm(mi.divergence, shift=1.0)
        adapter = pcs.cell_major_adapter(coarse.apply, mi.nb)
        solver = make_gmres(A_plain, pcs.multiplicative(A_plain, adapter, pj_fm), side="right")
        G = mi.pack_fm(mi.initial_state()).reshape(-1)
        its_plain = []
        for _ in range(2):
            r = solver(G, G)
            check(r.converged, "the plain-operator dct2lm step did not converge")
            G = r.x
            its_plain.append(r.iters)
        U_ref = mi.unpack_fm(G)
        dev_f = ((res_f.state - U_ref).abs().max() / U_ref.abs().max()).item()
        print(f"[13 main path F] plain-operator run: iterations {its_plain}; max|U - U_plain|/"
              f"max|U_plain| {dev_f:.3e} (tol 1e-4)", flush=True)
        check(dev_f <= 1e-4, f"dct2lm disagrees with the plain operator: {dev_f:.3e}")
        k2_by_path = {f"F wave_implicit dct2lm {NW}^3": k2_f}

        for pc in ("circulant2l", "dct2l"):
            PlaneStencilMatvec.launches = 0
            res, snap_pc = solve_run(lambda pc=pc: wave_implicit.main(
                kershaw + ["16"] * 3 + common + ["--ntmax", "2", "--pc", pc]))
            its_pc = [d["extras"][0] for d in res.diagnostics]
            conv_pc = [d["extras"][2] for d in res.diagnostics]
            k2_pc = PlaneStencilMatvec.launches
            print(f"[13 driver] wave_implicit Kershaw 16^3 --pc {pc}: iterations {its_pc} (the "
                  f"JAX package's record on its TPU: {JAX_RECORDS[pc + ' 16^3']}), converged "
                  f"{conv_pc}, K2 launches {k2_pc} ({snap_pc['masked_launches'][1]} of them by "
                  f"{snap_pc['masked']} masked iterations)", flush=True)
            check(len(its_pc) == 2 and all(conv_pc) and bool(torch.isfinite(res.state).all()),
                  f"{pc}: iterations {its_pc}, converged {conv_pc}")
            check(k2_pc == k2_expected_launches(its_pc, 0, masked=snap_pc["masked"]),
                  f"{pc}: {k2_pc} K2 launches")
            k2_by_path[f"wave_implicit {pc} 16^3"] = k2_pc

        for pc, extra in (("dctfft", []), ("blockfft", ["--periodic"])):
            t0 = time.perf_counter()
            res = wave_implicit.main([str(NW)] * 3 + extra + common
                                     + ["--ntmax", "20", "--pc", pc])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            wm = WaveSystem(cartesian_mesh(((-0.5, 0.5),) * 3, (NW,) * 3,
                                           periodic=bool(extra)), cfl=1e3 / 3, **f32)
            U0 = wm.initial_state()
            # the fp32 gate holds the DCT step at "highest"; phase 25 holds the
            # driver's tier, "high" (bf16×3 through K4), to its own gate
            U1 = (DCTBlockWaveSolver.create((NW,) * 3, 3, wm.dt, wm.c0, wm.mesh.spacing,
                                            precision="highest", **f32).solve(U0)
                  .reshape(U0.shape) if pc == "dctfft" else wm.block_fft_stepper()(U0)[0])
            res1 = (torch.linalg.norm(wm.implicit_matvec()(U1) - U0)
                    / torch.linalg.norm(U0)).item()
            print(f"[13 driver] wave_implicit {NW}^3 --pc {pc} {' '.join(extra)}: "
                  f"{res.iterations} steps (stationary {res.stationary}), median "
                  f"{np.median(res.step_seconds) * 1e3:.3f} "
                  f"ms/step, driver wall {wall:.2f} s; one direct step "
                  f"{'(the DCT solve at highest) ' if pc == 'dctfft' else ''}"
                  f"||(I+D)U1 - U0||/||U0|| {res1:.3e} (tol {TOL_RESIDUAL:g})", flush=True)
            # the loop stops early once the state is stationary (‖dU‖ < 1e-5)
            check((res.iterations == 20 or res.stationary) and bool(torch.isfinite(res.state).all())
                  and res1 < TOL_RESIDUAL, f"{pc}: {res.iterations} steps, residual {res1:.3e}")
            # the driver's step, one graph replay per step, against capture off
            if pc == "dctfft":
                captured_against_eager(f"dctfft {NW}^3", wm.dct_fft_stepper_fm,
                                       wm.pack_fm(U0), wm.dt, smi)
            else:
                captured_against_eager(f"blockfft {NW}^3", wm.block_fft_stepper, U0, wm.dt, smi)

        res = transport_implicit.main(kershaw + ["32"] * 3 + common
                                      + ["--ntmax", "2", "--pc", "circulant"])
        its_t = [d["extras"][0] for d in res.diagnostics]
        conv_t = [d["extras"][2] for d in res.diagnostics]
        print(f"[13 driver] transport_implicit Kershaw 32^3 --pc circulant: iterations {its_t}, "
              f"converged {conv_t}, ms/step {[round(t * 1e3, 3) for t in res.step_seconds]}",
              flush=True)
        check(len(its_t) == 2 and all(conv_t) and bool(torch.isfinite(res.state).all()),
              f"transport_implicit kershaw circulant: iterations {its_t}, converged {conv_t}")

    # --- 14: times ----------------------------------------------------------
    print(f"[14 times] CUDA events: median of 7 x 20 calls; kernel time: torch.profiler over "
          f"20 calls; on {smi}:", flush=True)
    stage = {}
    for label in ("128^3 stage", "100^3 stage"):
        M, K, Nn = k3_shapes[label]
        a, b = planes((M, K), torch.float32), planes((K, Nn), torch.float32)
        ac, bc = torch.complex(*a), torch.complex(*b)
        runs = {"K3": lambda: complex_matmul_cuda(*a, *b),
                "K3 plain (4 torch.matmul)": lambda: complex_matmul_reference(*a, *b),
                "library (complex64 torch.matmul)": lambda: ac @ bc}
        ms = median_ms(runs)
        gms = {name: graph_ms(fn) for name, fn in runs.items()}
        profs = {name: device_profile(fn) for name, fn in runs.items()}
        # the least time of the function at fp32 accuracy: its bytes, or the
        # 3 real products of Gauss's form (6·M·K·N flops), each as 3×TF32, over
        # the TF32 peak; K3 does the direct form's 4, 12 tensor-core products
        # (24·M·K·N flops); the plain version and cuBLAS do the 4 in fp32
        nbytes = 4.0 * 2 * (M * K + K * Nn + M * Nn)
        b_ms, b_by = bound(3 * 6.0 * M * K * Nn, nbytes, PEAK_TF32)
        k3_flops = 24.0 * M * K * Nn
        alg_ms, _ = bound(k3_flops, nbytes, PEAK_TF32)
        print(f"[14 times] K3 per call at {label} ({M},{K})·({K},{Nn}), float32: bound "
              f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB; 3 × 6·M·K·N = "
              f"{18.0 * M * K * Nn / 1e9:.3f} GFLOP at the TF32 peak take "
              f"{18.0 * M * K * Nn / PEAK_TF32 * 1e3:.4f} ms); K3's 12 tensor-core products "
              f"({k3_flops / 1e9:.3f} GFLOP): {alg_ms:.4f} ms; {smi}", flush=True)
        for name in runs:
            kms = sum(profs[name].values())
            rate = (f"{k3_flops / gms[name] / 1e9:.1f} TFLOP/s of its 12 tensor-core products"
                    if name == "K3" else f"{8.0 * M * K * Nn / gms[name] / 1e9:.1f} TFLOP/s of "
                    f"the direct form's 4 real products in fp32")
            print(f"[14 times]   {name}: {ms[name]:.4f} ms/call by CUDA events, "
                  f"{gms[name]:.4f} ms/call by CUDA-graph replay = {rate}; profiler "
                  f"{kms:.4f} ms/call over 20 calls "
                  f"({', '.join(f'{k[:24]} x{n}' for k, n in profs[name].counts.items())})"
                  f"; {smi}", flush=True)
        stage[label] = {"ms": gms["K3"], "plain_ms": gms["K3 plain (4 torch.matmul)"],
                        "library_ms": gms["library (complex64 torch.matmul)"],
                        "events_ms": ms["K3"], "bound_ms": b_ms, "bound_by": b_by,
                        "algorithm_bound_ms": alg_ms}
    k3_json = dict(stage["128^3 stage"], stages=stage)  # the 128³ stage's, and both stages
    solve_stage = {"128^3 a=(1,0.5,0.25)": "128^3 stage", "100^3 flagship": "100^3 stage"}
    for label, (sk, se, b) in solvers.items():
        runs = {"use_kernel=True (K3)": lambda: sk.solve(b), "einsum": lambda: se.solve(b)}
        ms = median_ms(runs)
        gms = {name: graph_ms(fn) for name, fn in runs.items()}
        kms = {name: device_ms(fn) for name, fn in runs.items()}
        k3_part = 4 * stage[solve_stage[label]]["ms"]
        print(f"[14 times] staged solve at {label}: "
              + "; ".join(f"{n} {ms[n]:.4f} ms/solve by events, {gms[n]:.4f} by graph replay, "
                          f"profiler {kms[n]:.4f}" for n in runs)
              + f"; K3's share: 4 calls x {k3_part / 4:.4f} = {k3_part:.4f} ms, "
              f"{100 * k3_part / gms['use_kernel=True (K3)']:.1f} % of the K3 solve's graph time"
              f"; {smi}", flush=True)

    # the dct2lm step at NW^3 in a tight loop, and one preconditioner apply
    A_k2 = mi.implicit_matvec_fm()
    M_k2 = pcs.multiplicative(A_k2, adapter, pj_fm)
    step = mi.implicit_stepper_fm(M_fm=M_k2, side="right")
    G0 = mi.pack_fm(mi.initial_state()).reshape(-1)
    step(G0)  # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(G0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = device_profile(lambda: step(G0), calls=2)
    busy, wall = sum(prof.values()), float(np.median(walls))
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:5]
    record_loop("F", warm_ms=wall, device_ms=busy, busy=100 * busy / wall)
    print(f"[14 busy] dct2lm step at {NW}^3 (first step): wall {wall:.3f} ms (median of 3), "
          f"device {busy:.3f} ms/step, busy {100 * busy / wall:.1f} %; largest: "
          + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top) + f"; {smi}", flush=True)
    r = torch.as_tensor(rng.standard_normal(4 * NW**3), device=dev, dtype=torch.float32)
    rc = r.reshape(4, -1).T.reshape(-1)
    Pw, Pbw = coarse.apply.args[0], coarse.apply.args[2]  # window or CSR forms
    project = lambda Pm, v: (Pm.matvec_multi(v) if hasattr(Pm, "matvec_multi")  # noqa: E731
                             else Pm.matvec(v))
    x_cart = project(Pw, rc.reshape(-1, 4)).reshape(-1)
    parts = {"P (4 components)": lambda: project(Pw, rc.reshape(-1, 4)),
             "DCT solve": lambda: coarse.op.solve(x_cart),
             "P_back": lambda: project(Pbw, x_cart.reshape(-1, 4)),
             "smoother (pbjacobi_fm)": lambda: pj_fm(r),
             "operator apply (K2)": lambda: A_k2(r),
             "whole apply (multiplicative)": lambda: M_k2(r)}
    ms = median_ms(parts)
    kms = {name: device_ms(fn) for name, fn in parts.items()}
    print(f"[14 times] one dct2lm preconditioner apply at {NW}^3 ({coarse.projection}), by part: "
          + "; ".join(f"{n} {ms[n]:.4f} ms (kernel {kms[n]:.4f})" for n in parts)
          + f"; {smi}", flush=True)

    # the periodic coarse solves of the projection PCs, in the two forms
    # their use_matmul_dft argument selects, on the grids derived from the
    # Kershaw meshes of path F (64^3 wave, 4 components; 32^3 transport at
    # cfl 1e3/3, a = (1,0,0): λ_x = cfl/6)
    n_xyz, spacing, _, _ = derive_grid_context(mesh64, [0.0] * 3, mi.dt)
    offsets, blocks = wave_block_stencil(3, mi.dt, mi.c0, spacing)
    g_zyx = tuple(reversed(n_xyz))
    op32 = CirculantTransportOperator.create((32,) * 3, (0.0, 0.0, 1e3 / 18), **f32)
    forms = {
        f"block {NW}^3": (BlockCirculantOperator.from_stencil(g_zyx, offsets, blocks, **f32),
                          MatmulBlockCirculantSolver.from_stencil(g_zyx, offsets, blocks,
                                                                  precision="high", **f32),
                          torch.randn(4 * NW**3, **f32)),
        "scalar 32^3": (op32, MatmulCirculantSolver.from_operator(op32),
                        torch.randn(32, 32, 32, **f32))}
    for label, (op_fft, op_dft, r) in forms.items():
        x_f, x_d = op_fft.solve(r), op_dft.solve(r)
        rel = ((x_f - x_d).abs().max() / x_f.abs().max()).item()
        check(rel <= 1e-4, f"the coarse solve forms disagree at {label}: {rel:.3e}")
        runs = {"torch.fft (default)": lambda: op_fft.solve(r),
                "staged DFT (use_matmul_dft=True)": lambda: op_dft.solve(r)}
        ms = median_ms(runs)
        gms = {name: graph_ms(fn) for name, fn in runs.items()}
        print(f"[14 times] projection PC coarse solve, {label}, float32 (forms agree to "
              f"{rel:.1e}): " + "; ".join(f"{n} {ms[n]:.4f} ms by events, {gms[n]:.4f} by graph "
                                          f"replay" for n in runs) + f"; {smi}", flush=True)
    return {"launches": k3_steps, "masked_launches": 0, "launches_by_path": k3_by_path, "max_abs_err": k3_err,
            **k3_json, "k2_launches_by_path": k2_by_path}


def kernel_launches() -> dict[str, int]:
    """The launch counters of K1 to K7."""
    from circulantpreconditioner_tpu_torch.utils import graphs

    return dict(zip(("K1", "K2", "K3", "K4", "K5", "K6", "K7"), graphs.kernel_launches()))


def reset_kernel_launches() -> None:
    from circulantpreconditioner_tpu_torch.utils import graphs

    graphs.credit(graphs.kernel_launches(), -1)


def step_walls(step, U0, reps: int = 3) -> list[float]:
    """Host ms of `reps` steps from U0, each ended by a synchronise (after one
    warm-up step)."""
    step(U0)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(U0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


# phase 21: the device-resident solves, recorded by the phases that run each path
DEVICE_LOOP: dict[str, dict] = {}
# the host loops' figures, before the solves were captured: copied from PERF.md
# (§5 and §6, NVIDIA H100 80GB HBM3, 700.00 W), not measured by this script
HOST_LOOP_FIGURES = {
    "B": "wall 1.162 ms, device 0.223 ms, busy 19.2 %, iterations <= 3",
    "D": "wall 828.5 ms, device 79.1 ms, busy 9.5 %, iterations 38 and 28",
    "F": "wall 166.5 ms, device 134.2 ms, busy 80.6 %, iterations 95 and 48",
    "G": "wall 1,706 to 2,140 ms, device not measured, iterations 100 (unconverged)",
    "H": "wall 3.366 ms, device not measured, iterations 3",
    "I": "wall 855 to 1,131 ms, device not measured, iterations 109 and 71",
    "J": "warm first step 903.4 ms (1,453.3 ms on a slower host), device 244.3 ms, "
         "busy 27 %, iterations 41 and 27",
}


def solve_run(fn):
    """fn() with the solvers' counters (utils.graphs.STATS) reset before it;
    returns (fn's result, the counters after it)."""
    from circulantpreconditioner_tpu_torch.utils.graphs import STATS

    STATS.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, STATS.snapshot()


def record_loop(path: str, snap: dict | None = None, **fields) -> None:
    """Phase 21's figures of `path`: `fields`, and the per-iteration rates of
    a STATS snapshot over its counted steps."""
    rec = DEVICE_LOOP.setdefault(path, {})
    rec.update(fields)
    if snap is not None:
        its = max(snap["iterations"], 1)
        rec.update(replays_per_it=snap["replays"] / its, waits_per_it=snap["waits"] / its,
                   masked=snap["masked"], masked_launches=snap["masked_launches"],
                   eager_calls=snap["eager_calls"],
                   captures=snap["captures"])


def warm_profile(step, U0, reps: int = 2) -> dict:
    """Wall (median of `reps`, after a warm-up step) and device time per step
    (torch.profiler over `reps` more) of `step` from U0."""
    walls = step_walls(step, U0, reps)
    prof = device_profile(lambda: step(U0), calls=reps)
    wall, device = float(np.median(walls)), sum(prof.values())
    return {"warm_ms": wall, "device_ms": device, "busy": 100 * device / wall}


# phase 22: the captured steps (utils.graphs.CapturedStep), recorded by the
# phases that run each path: captured against capture off in the same call
CAPTURED_STEPS: dict[str, dict] = {}


def loop_profile(step, U0, dt: float, steps: int, chunk: int | None = None,
                 norms=None) -> dict:
    """run_time_loop of `steps` steps from U0 (`chunk` steps per host
    synchronisation), after one warm-up run: the wall per step (the median of
    the loop's own step walls, each ended by its synchronisation), the device
    time per step and the part of it in device-to-device copies (the captured
    step's state copy among them; torch.profiler over one more run), and the
    final state."""
    from circulantpreconditioner_tpu_torch.models import run_time_loop

    kw = dict(tmax=1e9, ntmax=steps, precision=0.0, log=None, chunk=chunk, global_norms=norms)
    run_time_loop(step, U0, dt, **kw)
    res = run_time_loop(step, U0, dt, **kw)
    prof = device_profile(lambda: run_time_loop(step, U0, dt, **kw), calls=1)
    device = sum(prof.values()) / steps
    copies = sum(v for k, v in prof.items() if "DtoD" in k) / steps
    wall = float(np.median(res.step_seconds)) * 1e3
    return {"warm_ms": wall, "device_ms": device, "busy": 100 * device / wall,
            "copy_ms": copies, "state": res.state}


def captured_against_eager(path: str, make_step, U0, dt: float, smi: str, steps: int = 10,
                           chunk: int | None = None, norms=None,
                           per_step: dict[str, int] | None = None) -> dict:
    """loop_profile of the captured step `make_step()` and of the same step
    made with capture off (utils.graphs.CAPTURE false: its step functions run
    eagerly); checks that the captured runs replayed graphs, that both
    launched K1, K2 and K3 alike (`per_step`: the launches each step must
    make), and that the states agree within 1e-6 relative. Recorded for
    phase 22."""
    from circulantpreconditioner_tpu_torch.utils import graphs

    runs = {}
    for capture in (True, False):
        graphs.CAPTURE = capture
        try:
            step = make_step()
            graphs.STATS.reset()
            before = kernel_launches()
            runs[capture] = loop_profile(step, U0, dt, steps, chunk, norms)
            torch.cuda.synchronize()
        finally:
            graphs.CAPTURE = True
        runs[capture]["snap"] = graphs.STATS.snapshot()
        runs[capture]["launches"] = {k: v - before[k] for k, v in kernel_launches().items()}
    c, e = runs[True], runs[False]
    rel = ((c["state"] - e["state"]).abs().max() / e["state"].abs().max()).item()
    rec = {"chunk": chunk or 1, "replays": c["snap"]["replays"],
           "captures": c["snap"]["captures"], "rel": rel, "launches": c["launches"],
           **{f"{k}_{mode}": r[k] for mode, r in (("captured", c), ("eager", e))
              for k in ("warm_ms", "device_ms", "busy", "copy_ms")}}
    CAPTURED_STEPS[path if chunk is None else f"{path}, chunk {chunk}"] = rec
    print(f"[22 {path}] {steps} steps, chunk {rec['chunk']}: captured wall "
          f"{c['warm_ms']:.4f} ms/step, device {c['device_ms']:.4f} ms/step (busy "
          f"{c['busy']:.1f} %; device-to-device copies {c['copy_ms']:.4f} ms/step), "
          f"{rec['captures']} graphs, {rec['replays']} replays; capture off: "
          f"wall {e['warm_ms']:.4f}, device {e['device_ms']:.4f} (busy {e['busy']:.1f} %); "
          f"K1 to K4 launches {c['launches']} (capture off {e['launches']}); "
          f"max|dU|/max|U| {rel:.3e} (tol 1e-6); {smi}", flush=True)
    check(rec["replays"] > 0 and rec["captures"] > 0 and e["snap"]["replays"] == 0,
          f"path {path}: captured {c['snap']}, capture off {e['snap']}")
    check(c["launches"] == e["launches"], f"path {path}: launches {c['launches']} captured, "
          f"{e['launches']} with capture off")
    for k, n in (per_step or {}).items():
        check(c["launches"][k] == 3 * steps * n, f"path {path}: {c['launches'][k]} {k} "
              f"launches in 3 runs of {steps} steps, expected {n} per step")
    check(bool(torch.isfinite(c["state"]).all()) and rel <= 1e-6,
          f"path {path}: captured and eager states {rel:.3e} apart")
    return rec


def captured_steps_phase(smi: str) -> None:
    """Phase 22: every captured step's wall and device time per step,
    captured and with capture off, as the earlier phases measured them."""
    print(f"[22 captured steps] the explicit and direct steps as CUDA graphs (one per chunk "
          f"length; the state in one buffer) against the same step functions run eagerly, "
          f"measured in this run; {smi}", flush=True)
    for path, r in CAPTURED_STEPS.items():
        print(f"[22 {path}] wall {r['warm_ms_eager']:.4f} -> "
              f"{r['warm_ms_captured']:.4f} ms/step, device {r['device_ms_eager']:.4f} -> "
              f"{r['device_ms_captured']:.4f} ms/step (copies {r['copy_ms_captured']:.4f}), busy "
              f"{r['busy_eager']:.1f} -> {r['busy_captured']:.1f} %", flush=True)


def device_loop_phase(smi: str) -> None:
    """Phase 21: the device-resident solves of paths B, D, F, G, H, I and J,
    as the earlier phases ran them, beside the host loops' figures from
    before the capture (copied from PERF.md)."""
    print(f"[21 device-resident solves] every Krylov solve of the one-device paths as CUDA-graph "
          f"replays, the stopping tests on the device, flags read one iteration behind; "
          f"{smi}", flush=True)
    for path in "BDFGHIJ":
        r = DEVICE_LOOP[path]
        print(f"[21 {path}] iterations per step {r['its']}; wall per warm step "
              f"{r['warm_ms']:.3f} ms; first step {r['first_ms']:.1f} ms; eager warm-ups and "
              f"captures {r['capture_s']:.3f} s over the counted run ({r['captures']} graphs); device "
              f"{r['device_ms']:.3f} ms per step, busy {r['busy']:.1f} % (torch.profiler); graph "
              f"replays per iteration {r['replays_per_it']:.2f}, host waits per iteration "
              f"{r['waits_per_it']:.2f}, masked iterations {r['masked']} (their K1, K2, K3 "
              f"launches {r['masked_launches']}), eager step functions {r['eager_calls']}"
              + (f"; at lookahead 0: wall {r['lookahead0']['warm_ms']:.3f} ms, device "
                 f"{r['lookahead0']['device_ms']:.3f} ms" if "lookahead0" in r else "")
              + f" | the host loop before capture, copied from PERF.md (not measured by this run): "
              f"{HOST_LOOP_FIGURES[path]}", flush=True)
        check(r["replays_per_it"] > 0 and r["captures"] > 0,
              f"path {path}'s solves ran no graph: {r}")


def bench_phase(smi: str) -> dict[str, int]:
    """Phase 23: the flagship of bench.py in full and bench_suite.py's rows
    3, 4 and 6 in a quick mode at Kershaw 16³. Returns K1, K2 and K3's
    launches on it (counted from 0)."""
    from circulantpreconditioner_tpu_torch import bench, bench_suite

    t_phase = time.perf_counter()
    log = lambda msg: print(f"[23] {msg}", flush=True)  # noqa: E731
    reset_kernel_launches()
    rec = bench.flagship_record(log=log)
    sub = rec["submetrics"]
    print(f"[23 bench.py] {json.dumps(rec)}", flush=True)
    print(f"[23 bench.py] flagship {rec['value']:.1f} solves/s ({1e3 / rec['value']:.6f} ms per "
          f"solve; bound {rec['bound_ms']:.6f} ms, {rec['bound_by']}), residual "
          f"{sub['flagship_rel_residual']:.3e} (gate {TOL_RESIDUAL:g}); staged "
          f"{sub['staged_full3d_solves_per_s']:.1f}, through K3 "
          f"{sub['staged_full3d_k3_solves_per_s']:.1f} (K3 per solve "
          f"{sub['staged_full3d_k3_launches_per_solve']['K3']:g}), fused "
          f"{sub['fused_full3d_solves_per_s']:.1f} (K1 per solve "
          f"{sub['fused_full3d_launches_per_solve']['K1']:g}); at {rec['precision']!r}, K4 per "
          f"solve: flagship {sub['flagship_launches_per_solve']['K4']:g}, staged "
          f"{sub['staged_full3d_launches_per_solve']['K4']:g}, through K3 "
          f"{sub['staged_full3d_k3_launches_per_solve']['K4']:g}; {smi}", flush=True)
    flag = sub["flagship_launches_per_solve"]
    check(sub["staged_full3d_k3_launches_per_solve"]["K3"] == 4
          and sub["fused_full3d_launches_per_solve"]["K1"] == 1
          and flag["K4"] == 1 and not (flag["K1"] or flag["K2"] or flag["K3"]),
          f"bench.py's solvers launched {sub}")
    s = bench_suite.Suite(torch.device("cuda"), log=log)
    recs = [bench_suite.bench_wave_explicit(s, 16, K1=20, K2=100, block=10),
            bench_suite.bench_spmv(s, 16, K1=20, K2=100, block=10),
            bench_suite.bench_wave_implicit(s, 16, K1=2, K2=6)]
    for r in recs:
        print(f"[23 bench_suite.py, quick, 16^3] {json.dumps(r)}", flush=True)
        check(not r.get("gate_failures"), f"{r['metric']} at 16^3: {r.get('gate_failures')}")
        check(r["launches_per_step"]["K2"] >= 1, f"{r['metric']} at 16^3 launched no K2")
    launched = kernel_launches()
    print(f"[23] K1 to K4 launches in phase 23: {launched}; phase 23 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


# phase 25: the precision tiers. The 16^3 projection-PC counts of the JAX
# suite's TPU run at "high" (results/bench_suite_r05.json), printed beside
# this run's at "high" and in fp32
R05_PC16 = {"dct2l": 43, "dct2lm": 28, "circulant2l": 62}
TOL_K4 = 1e-5  # max|o_K4 − o_plain| / max|o_plain|
PEAK_BF16 = 989e12  # H100 SXM dense bf16 on the tensor cores (NVIDIA data sheet)
# the DCT direct step's gate at "high": bf16×3 keeps about 16 of fp32's 24
# mantissa bits (phase 25 prints a product's error against float64 in each
# form), and the step's fp32 residual already lies within a factor of five
# of the fp32 gate (phase 13), so the tier's gate is ten times fp32's
TOL_RESIDUAL_DCT_HIGH = 1e-3


def k4_shapes(dev: torch.device) -> dict:
    """K4's calls on the main paths, (a, b, axis), from a seed: the flagship
    collapse, the staged solve's x, y and z stages at 100^3, the DCT sweeps at
    64^3 (one matrix per field component, and the cell-major state's
    field-major view), the block solve's x stage at 16^3 (m = 4), and the
    edges of K4's tiling (ragged; a second K chunk and column tile)."""
    rng = np.random.default_rng(25)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

    return {
        "flagship (10^4,100)x(100,100)": (t(N, N, N), t(N, N).T, 2),
        "staged x forward (10^4,100)x(100,51)": (t(N, N, N), t(N, 51), 2),
        "staged x inverse (10^4,51)x(51,100)": (t(N, N, 51), t(51, N), 2),
        "staged y, per z (100,100)x(100,51)": (t(N, N, 51), t(N, N), 1),
        "staged z (100,100)x(100,5100)": (t(N, N, 51), t(N, N), 0),
        "DCT x 64^3, 4 components": (t(4, 64, 64, 64), t(4, 65, 64).transpose(1, 2), 3),
        "DCT z inverse 64^3, 4 components": (t(4, 65, 65, 65), t(4, 64, 65).transpose(1, 2), 1),
        "DCT x of the cell-major view": (torch.movedim(t(64, 64, 64, 4), -1, 0),
                                          t(4, 65, 64).transpose(1, 2), 3),
        "block x 16^3, m = 4": (t(16, 16, 16, 4), t(16, 9), 2),
        "ragged (37,19)x(19,45)": (t(37, 19), t(19, 45), 1),
        "2 K chunks, 2 column tiles (2113,129)x(129,136)": (t(2113, 129), t(129, 136), 1),
    }


def precision_tier_phase(dev: torch.device, smi: str) -> dict:
    """Phase 25: kernel K4 (csrc/tier_matmul.cu) and the precision tiers. K4
    against its plain version at the paths' shapes in one and three passes;
    its time, its plain version's and fp32 torch.matmul's at the flagship
    shape; the flagship at each tier; main path B at "high" (the dense
    collapse as GMRES's preconditioner, K4 once per apply); the DCT direct
    step at "high"; the 16^3 projection-PC counts at "high" and in fp32.
    Returns K4's entry of the kernels line."""
    from circulantpreconditioner_tpu_torch.bench_suite import first_step
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh, kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import (
        TransportEquation,
        WaveSystem,
        run_time_loop,
    )
    from circulantpreconditioner_tpu_torch.ops import tier_matmul as tm
    from circulantpreconditioner_tpu_torch.ops.circulant import CirculantTransportOperator
    from circulantpreconditioner_tpu_torch.ops.spectral_collapse import (
        DenseCirculantSolver,
        make_circulant_solver,
    )
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import (
        BlockCirculantProjectionPC,
        DCTBlockProjectionPC,
    )

    t_phase = time.perf_counter()
    f32 = dict(device=dev, dtype=torch.float32)
    # --- K4 against its plain version ---------------------------------------
    shapes = k4_shapes(dev)
    max_abs_err, worst = 0.0, 0.0
    for name, (a, b, axis) in shapes.items():
        errs = []
        for precision in ("high", "default"):
            before = tm.TierMatmulKernel.launches
            o = tm.tier_matmul_cuda(a, b, precision, axis)
            torch.cuda.synchronize()
            check(tm.TierMatmulKernel.launches == before + 1, f"K4 at {name}: no launch counted")
            p = tm.tier_matmul_reference(a, b, precision, axis)
            err = (o - p).abs().max().item()
            rel = err / p.abs().max().item()
            max_abs_err, worst = max(max_abs_err, err), max(worst, rel)
            errs.append(f"{precision} {rel:.3e}")
            check(rel <= TOL_K4, f"K4 disagrees with its plain version at {name}, {precision}: "
                                 f"{rel:.3e}")
        print(f"[25 K4 vs plain] {name}: max|o - o_plain|/max|o_plain| " + ", ".join(errs)
              + f" (tol {TOL_K4:g})", flush=True)
    a, b, axis = shapes["flagship (10^4,100)x(100,100)"]
    exact = tm.contract(a.double(), b.double(), axis)
    forms = {"K4 high": lambda: tm.tier_matmul_cuda(a, b, "high", axis),
             "K4 default": lambda: tm.tier_matmul_cuda(a, b, "default", axis),
             "fp32 einsum": lambda: tm.contract(a, b, axis)}
    err64 = {name: ((fn().double() - exact).abs().max() / exact.abs().max()).item()
             for name, fn in forms.items()}
    print("[25 K4 vs float64] the flagship shape, max|o - o_f64|/max|o_f64|: "
          + "; ".join(f"{k} {v:.3e}" for k, v in err64.items()), flush=True)
    # --- times at the paths' shapes -------------------------------------------
    times = {}
    for name, (sa, sb, sax) in shapes.items():
        if "ragged" in name or "chunks" in name:
            continue
        times[name] = {"K4 high": graph_ms(lambda: tm.tier_matmul_cuda(sa, sb, "high", sax)),
                       "K4 default": graph_ms(lambda: tm.tier_matmul_cuda(sa, sb, "default", sax)),
                       "fp32 einsum": graph_ms(lambda: tm.contract(sa, sb, sax))}
        print(f"[25 times] {name}: " + "; ".join(f"{k} {v:.4f} ms" for k, v in times[name].items())
              + f" (CUDA-graph replay of 20 calls); {smi}", flush=True)
    a2, m = a.reshape(-1, N), b.contiguous()
    k4_ms = times["flagship (10^4,100)x(100,100)"]["K4 high"]
    plain_ms = graph_ms(lambda: tm.tier_matmul_reference(a, b, "high", axis))
    library_ms = graph_ms(lambda: torch.matmul(a2, m))
    k4_bound, k4_by = bound(3 * 2.0 * N**3 * N, 4.0 * (2 * N**3 + N * N), PEAK_BF16)
    print(f"[25 times] K4 at the flagship shape, three passes: {k4_ms:.4f} ms; its plain version "
          f"{plain_ms:.4f} ms; fp32 torch.matmul (cuBLAS) {library_ms:.4f} ms; bound "
          f"{k4_bound:.4f} ms ({k4_by}: {4.0 * (2 * N**3 + N * N) / 1e6:.2f} MB; three bf16 "
          f"passes {6.0 * N**4 / 1e9:.1f} GFLOP at 989 TFLOP/s); {smi}", flush=True)
    # --- the flagship at each tier ------------------------------------------
    lams = flagship_lambdas()
    op = CirculantTransportOperator.create((N, N, N), lams, **f32)
    bvec = torch.as_tensor((np.random.default_rng(1).random((N, N, N)) * 50 + 600)
                           .astype(np.float32), device=dev)
    for precision in ("highest", "high", "default"):
        solver = DenseCirculantSolver.create((N, N, N), lams, precision=precision, **f32)
        before = tm.TierMatmulKernel.launches
        x = solver.solve(bvec)
        torch.cuda.synchronize()
        per_solve = tm.TierMatmulKernel.launches - before
        res = rel_residual(op, x, bvec)
        ms = graph_ms(lambda: solver.solve(bvec))
        print(f"[25 flagship] DenseCirculantSolver at {precision!r}: {ms:.4f} ms per solve "
              f"(CUDA-graph replay), residual {res:.3e}, K4 launches per solve {per_solve}; "
              f"{smi}", flush=True)
        check(per_solve == (0 if precision == "highest" else 1),
              f"the flagship at {precision!r} launched K4 {per_solve} times per solve")
        if precision != "default":  # one bf16 pass: "rough-preconditioner grade"
            check(res < TOL_RESIDUAL, f"the flagship at {precision!r}: residual {res:.3e}")
    # --- main path B at "high" ------------------------------------------------
    mesh = cartesian_mesh(((-0.5, 0.5),) * 3, (N, N, N), periodic=True)
    model = TransportEquation(mesh, (1.0, 0.0, 0.0), cfl=1e3 / 3, **f32)
    fop = model.fft_operator
    M = make_circulant_solver(fop.shape_zyx, fop.lambdas_zyx, precision="high", **f32)
    check(isinstance(M, DenseCirculantSolver), "path B at 'high' did not get the dense collapse")
    step = model.implicit_stepper(M=M.as_preconditioner(), side="right")
    u0 = model.initial_state()
    solve_run(lambda: step(u0))  # the warm-up and the capture of the solve's graphs
    reset_kernel_launches()
    res_b, snap = solve_run(lambda: run_time_loop(step, u0, model.dt, tmax=1e9, ntmax=3,
                                                  log=None))
    k4_b = kernel_launches()
    its = [d["extras"][0] for d in res_b.diagnostics]
    conv = [d["extras"][2] for d in res_b.diagnostics]
    expected = k1_expected_launches(its, snap["masked"], snap["true_restarts"])
    u_ref = u0
    fft_step = model.fft_stepper("fft")
    for _ in range(3):
        u_ref, _ = fft_step(u_ref)
    dev_b = (res_b.state - u_ref).abs().max().item() / u_ref.abs().max().item()
    print(f"[25 main path B] GMRES + the dense collapse at 'high', periodic 100^3: iterations "
          f"{its}, converged {conv}, K4 launches {k4_b['K4']} (expected {expected}: one per "
          f"iteration and cycle, {snap['masked_launches'][3]} of them by {snap['masked']} "
          f"masked iterations, {snap['true_restarts']} cycles forced by the true residual), "
          f"all launches {k4_b}; max|u - u_fft|/max|u| {dev_b:.3e}",
          flush=True)
    check(len(its) == 3 and all(conv) and max(its) <= 3, f"path B at 'high': iterations {its}, "
          f"converged {conv}")
    check(k4_b["K4"] == expected > 0, f"path B at 'high': {k4_b['K4']} K4 launches, expected "
          f"{expected}")
    check(dev_b < 1e-4, f"path B at 'high' disagrees with the direct solve: {dev_b:.3e}")
    # --- the DCT direct step at "high" (phase 13 holds fp32's) -----------------
    wm = WaveSystem(cartesian_mesh(((-0.5, 0.5),) * 3, (NW,) * 3), cfl=1e3 / 3, **f32)
    U0 = wm.initial_state()
    U1 = wm.unpack_fm(wm.dct_fft_stepper_fm()(wm.pack_fm(U0))[0])
    res_dct = (torch.linalg.norm(wm.implicit_matvec()(U1) - U0) / torch.linalg.norm(U0)).item()
    print(f"[25 DCT step] the wall {NW}^3 direct step (dct_fft_stepper_fm, 'high'): "
          f"||(I+D)U1 - U0||/||U0|| {res_dct:.3e} (the tier's gate {TOL_RESIDUAL_DCT_HIGH:g}; "
          f"fp32's in phase 13)", flush=True)
    check(res_dct < TOL_RESIDUAL_DCT_HIGH, f"the DCT step at 'high': residual {res_dct:.3e}")
    # --- the 16^3 projection-PC counts at "high" and in fp32 -------------------
    kmesh = kershaw_mesh(((0.0, 1.0),) * 3, (16,) * 3)
    wk = WaveSystem(kmesh, cfl=1e3 / 3, **f32)
    pj = pcs.pbjacobi(wk.divergence, shift=1.0)
    counts: dict[str, dict[str, int]] = {}
    for precision in ("high", "highest"):
        dct = DCTBlockProjectionPC(kmesh, wk.dt, wk.c0, precision=precision, **f32)
        circ = BlockCirculantProjectionPC(kmesh, wk.dt, wk.c0, use_matmul_dft=True, **f32)
        circ.op.precision = precision  # the JAX PC's tier is "high"; fp32 beside it
        makers = {"dct2l": pcs.additive(dct.apply, pj),
                  "dct2lm": pcs.multiplicative(wk.implicit_matvec(), dct.apply, pj),
                  "circulant2l": pcs.additive(circ.apply, pj)}
        for name, M_ in makers.items():
            case = first_step(wk.implicit_stepper(M=M_, rtol=1e-5, atol=1e-5, maxiter=1000,
                                                  side="right"), wk.initial_state())
            check(case.converged, f"{name} at {precision!r}: not converged")
            counts.setdefault(name, {})[precision] = case.iters
    print("[25 16^3 counts] cell-major GMRES (right, rtol atol 1e-5) at Kershaw 16^3, "
          "iterations at 'high' (K4) and in fp32 ('highest') beside the JAX suite's TPU run "
          "(r05, 'high' on its matrix unit): " + "; ".join(
              f"{name} {c['high']} ('high'), {c['highest']} (fp32), r05 {R05_PC16[name]}"
              for name, c in counts.items()), flush=True)
    print(f"[25] phase 25 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": k4_b["K4"], "masked_launches": snap["masked_launches"][3],
            "max_abs_err": max_abs_err, "max_rel_err": worst, "ms": k4_ms, "plain_ms": plain_ms,
            "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": library_ms,
            "ms_by_shape": times, "err_vs_float64": err64, "pc_counts_16": counts}



def slice6_phases(dev: torch.device, smi: str) -> None:
    """Phases 15 to 17: main paths G (GMRES + ILU(0) and block-Jacobi ILU(0)
    on the wave system), H (diffusion: CG, the FFT solve, the projection PC)
    and I (the aggregation V-cycle). No TPU kernel lies on them: they run in
    plain PyTorch, and K1 to K3 must not launch."""
    from circulantpreconditioner_tpu_torch.drivers import diffusion_implicit, wave_implicit
    from circulantpreconditioner_tpu_torch.drivers.wave_implicit import identity_plus_csr
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh, kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import DiffusionEquation, WaveSystem
    from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix
    from circulantpreconditioner_tpu_torch.solvers import AggregationVCyclePC
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs

    f32 = dict(device=dev, dtype=torch.float32)
    cpu64 = dict(device=torch.device("cpu"), dtype=torch.float64)
    rng = np.random.default_rng(15)
    cube = ((-0.5, 0.5),) * 3
    reset_kernel_launches()

    # --- 15: main path G, GMRES + ILU(0) on the wave system at 32^3 ---------
    ng = 32
    wm = WaveSystem(cartesian_mesh(cube, (ng,) * 3), cfl=1e3 / 3, **f32)
    A_I = identity_plus_csr(wm, torch.float32)
    indptr, indices = A_I.indptr.cpu().numpy(), A_I.indices.cpu().numpy()
    data = A_I.data.cpu().numpy().astype(np.float64)
    n = A_I.shape[0]
    t0 = time.perf_counter()
    lower = pcs._level_schedule(indptr, indices, True, n)
    upper = pcs._level_schedule(indptr, indices, False, n)
    t_sched = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcs._ilu0_factor_host(indptr, indices, data, lower)
    t_factor = time.perf_counter() - t0
    t0 = time.perf_counter()
    ilu = pcs.ilu0(A_I)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"[15 host] ILU(0) of I + D, cartesian {ng}^3 wave, {n} rows, {A_I.indices.numel()} "
          f"entries: level schedules {t_sched:.3f} s ({len(lower)} lower, {len(upper)} upper "
          f"levels, at most {max(map(len, lower))} rows in a level), float64 factor "
          f"{t_factor:.3f} s, the whole ILU0Preconditioner with its upload {t_build:.3f} s",
          flush=True)
    check(ilu.n_levels == (len(lower), len(upper)) == (98, 98),
          f"ILU(0) levels {ilu.n_levels}, expected (98, 98)")
    ilu64 = pcs.ilu0(CSRMatrix.from_scipy(A_I.to_scipy(), **cpu64))
    r = rng.standard_normal(n)
    z = ilu.apply(torch.as_tensor(r, **f32))
    torch.cuda.synchronize()
    z64 = ilu64.apply(torch.as_tensor(r, dtype=torch.float64)).numpy()
    rel = np.abs(z.double().cpu().numpy() - z64).max() / np.abs(z64).max()
    print(f"[15 ILU apply] card float32 against the CPU float64 apply of the same factor: "
          f"max|dz|/max|z| {rel:.3e} (tol {TOL_KERNEL:g})", flush=True)
    check(bool(torch.isfinite(z).all()) and rel <= TOL_KERNEL,
          f"the card's ILU(0) apply is off the float64 apply: {rel:.3e}")

    U0 = wm.initial_state()
    A = wm.implicit_matvec()
    for label, M in (("ILU(0)", ilu.apply),
                     ("block-Jacobi ILU(0), 4 blocks", pcs.block_jacobi_ilu0(A_I, 4))):
        step = wm.implicit_stepper(M=M, maxiter=100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (U1, _, its, resnorm, conv), snap = solve_run(lambda: step(U0))
        wall = time.perf_counter() - t0
        if label == "ILU(0)":
            record_loop("G", snap, its=[its], first_ms=wall * 1e3,
                        capture_s=snap["capture_seconds"], **warm_profile(step, U0, reps=1))
        true_res = (torch.linalg.norm(A(U1) - U0) / torch.linalg.norm(U0)).item()
        print(f"[15 main path G] GMRES + {label}, cartesian {ng}^3, maxiter 100: iterations "
              f"{its}, converged {conv}, preconditioned residual {resnorm:.3e}, true "
              f"||(I+D)U1 - U0||/||U0|| {true_res:.3e}, step wall {wall * 1e3:.1f} ms; {smi}",
              flush=True)
        check(bool(torch.isfinite(U1).all()) and (conv or its == 100),
              f"GMRES + {label}: iterations {its}, converged {conv}, non-finite state")

    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = wave_implicit.main([str(ng)] * 3 + ["--maxits", "100", "--ntmax", "2", "--tmax",
                                                  "1e9", "--device", "cuda", "--result-dir",
                                                  out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    its = [d["extras"][0] for d in res.diagnostics]
    conv = [d["extras"][2] for d in res.diagnostics]
    print(f"[15 driver] wave_implicit {ng}^3 (no --pc: ILU(0)) --maxits 100: iterations {its}, "
          f"converged {conv}, ms/step {[round(t * 1e3, 1) for t in res.step_seconds]}, driver "
          f"wall {wall:.2f} s", flush=True)
    check(res.iterations == 2 and bool(torch.isfinite(res.state).all()),
          f"wave_implicit with ILU(0): {res.iterations} steps, or a non-finite state")

    prof = device_profile(lambda: ilu.apply(U0), calls=5)
    launches = sum(prof.counts.values()) / 5
    apply_ms = median_ms({"ILU apply": lambda: ilu.apply(U0)}, calls=5, repeats=5)["ILU apply"]
    apply_graph = graph_ms(lambda: ilu.apply(U0), calls=5, repeats=5)
    print(f"[15 times] one ILU(0) apply at {ng}^3 ({sum(ilu.n_levels)} levels): {launches:.0f} "
          f"kernel launches (torch.profiler over 5 applies), {apply_ms:.3f} ms by CUDA events, "
          f"{apply_graph:.3f} ms by CUDA-graph replay, device time {sum(prof.values()):.3f} ms "
          f"(profiler); largest: " + "; ".join(
              f"{k[:40]} {v:.3f} ms x{prof.counts[k] // 5}" for k, v in
              sorted(prof.items(), key=lambda kv: -kv[1])[:3]) + f"; {smi}", flush=True)

    # --- 16: main path H, diffusion at 64^3 --------------------------------
    nd = 64
    dw = DiffusionEquation(cartesian_mesh(cube, (nd,) * 3), cfl=10.0, **f32)
    b = dw.initial_state()
    step = dw.implicit_stepper()
    t0 = time.perf_counter()
    (x, _, its, _, conv), snap = solve_run(lambda: step(b))
    first_ms = (time.perf_counter() - t0) * 1e3
    res_cg = (torch.linalg.norm(dw.implicit_matvec()(x) - b) / torch.linalg.norm(b)).item()
    walls, snap_w = solve_run(lambda: step_walls(step, b))
    record_loop("H", snap_w, its=[its], **warm_profile(step, b, reps=3))
    record_loop("H", first_ms=first_ms, capture_s=snap["capture_seconds"],
                captures=snap["captures"])
    print(f"[16 main path H] CG, wall cartesian {nd}^3, cfl 10: iterations {its}, converged "
          f"{conv}, ||(I+D)x - b||/||b|| {res_cg:.3e} (tol {TOL_RESIDUAL:g}), wall per step "
          f"{np.median(walls):.3f} ms (median of 3); {smi}", flush=True)
    check(conv and res_cg < TOL_RESIDUAL, f"diffusion CG at {nd}^3: {its} iterations, "
          f"converged {conv}, residual {res_cg:.3e}")

    mesh_p = cartesian_mesh(cube, (nd,) * 3, periodic=True)
    dp = DiffusionEquation(mesh_p, cfl=10.0, **f32)
    b = dp.initial_state()
    fft_step = dp.fft_stepper()
    x_fft = fft_step(b)[0]
    x_cg, _, its, _, conv = dp.implicit_stepper()(b)
    rel = ((x_fft - x_cg).abs().max() / x_cg.abs().max()).item()
    walls = step_walls(fft_step, b)
    print(f"[16 main path H] FFT step (staged DFT), periodic {nd}^3: max|x_fft - x_cg|/max|x| "
          f"{rel:.3e} (tol 1e-4; CG {its} iterations), wall per step {np.median(walls):.3f} ms "
          f"(median of 3); {smi}", flush=True)
    check(conv and rel <= 1e-4, f"the diffusion FFT step is off CG: {rel:.3e}")
    captured_against_eager(f"H diffusion FFT step {nd}^3", dp.fft_stepper, b, dp.dt, smi)
    k = (8, 4, 2)
    c = mesh_p.cell_center
    u0 = torch.as_tensor(np.sin(2 * np.pi * (c @ np.asarray(k, dtype=np.float64)))).to(**f32)
    u = u0
    for _ in range(3):
        u = fft_step(u)[0]
    amp = (torch.dot(u.double(), u0.double()) / torch.dot(u0.double(), u0.double())).item()
    want = dp.exact_mode_decay(k, 3)
    rel = abs(amp - want) / want
    print(f"[16 main path H] Fourier mode k = {k} after 3 FFT steps: amplitude {amp:.8f}, "
          f"exact_mode_decay {want:.8f}, relative difference {rel:.3e} (tol 1e-5)", flush=True)
    check(rel <= 1e-5, f"the mode's decay is off exact_mode_decay: {rel:.3e}")

    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = diffusion_implicit.main(["--mesh-family", "kershaw"] + [str(nd)] * 3
                                      + ["--method", "pc", "--ntmax", "2", "--tmax", "1e9",
                                         "--device", "cuda", "--result-dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    its = [d["extras"][0] for d in res.diagnostics]
    conv = [d["extras"][2] for d in res.diagnostics]
    print(f"[16 driver] diffusion_implicit Kershaw {nd}^3 --method pc: iterations {its}, "
          f"converged {conv}, ms/step {[round(t * 1e3, 2) for t in res.step_seconds]}, driver "
          f"wall {wall:.2f} s (the projection's host build included); {smi}", flush=True)
    check(res.iterations == 2 and all(conv) and bool(torch.isfinite(res.state).all()),
          f"diffusion --method pc: iterations {its}, converged {conv}")

    # --- 17: main path I, the aggregation V-cycle at Kershaw 24^3 ----------
    na = 24
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res, snap = solve_run(lambda: wave_implicit.main(
            ["--mesh-family", "kershaw"] + [str(na)] * 3 + ["--pc", "aggvcycle", "--ntmax",
                                                            "2", "--tmax", "1e9", "--device",
                                                            "cuda", "--result-dir", out_dir]))
        wall = time.perf_counter() - t0
    its = [d["extras"][0] for d in res.diagnostics]
    conv = [d["extras"][2] for d in res.diagnostics]
    print(f"[17 main path I] wave_implicit Kershaw {na}^3 --pc aggvcycle: iterations {its} "
          f"(the JAX package's record on its TPU: 111, results/bench_suite_r05.json), converged "
          f"{conv}, ms/step {[round(t * 1e3, 1) for t in res.step_seconds]}, driver wall "
          f"{wall:.2f} s; {smi}", flush=True)
    check(res.iterations == 2 and all(conv) and bool(torch.isfinite(res.state).all()),
          f"aggvcycle: iterations {its}, converged {conv}")
    record_loop("I", snap, its=its, first_ms=res.step_seconds[0] * 1e3,
                capture_s=snap["capture_seconds"])
    wk = WaveSystem(kershaw_mesh(cube, (na,) * 3), cfl=1e3 / 3, **f32)
    wk.divergence
    t0 = time.perf_counter()
    agg = AggregationVCyclePC.from_bsr(wk.divergence, A0_apply=wk.implicit_matvec(), shift=1.0)
    torch.cuda.synchronize()
    t_agg = time.perf_counter() - t0
    r = wk.initial_state()
    # the driver's step (GMRES right-preconditioned by this hierarchy), warm
    record_loop("I", **warm_profile(wk.implicit_stepper(M=agg.apply, side="right"), r))
    v_ms = median_ms({"V-cycle": lambda: agg.apply(r)}, calls=10, repeats=5)["V-cycle"]
    v_graph = graph_ms(lambda: agg.apply(r), calls=10, repeats=5)
    prof = device_profile(lambda: agg.apply(r), calls=5)
    print(f"[17 times] aggregation hierarchy at Kershaw {na}^3: {agg.n_levels} levels (block "
          f"rows {[L.n for L in agg.levels]}, bottom {agg.bot_inv.shape[0] // 4}), host build "
          f"{t_agg:.2f} s; one V-cycle apply {sum(prof.counts.values()) / 5:.0f} kernel "
          f"launches, {v_ms:.3f} ms by CUDA events, {v_graph:.3f} ms by CUDA-graph replay, "
          f"device time {sum(prof.values()):.3f} ms (profiler); one fine-level matvec "
          f"{median_ms({'A': lambda: wk.implicit_matvec()(r)}, calls=10, repeats=5)['A']:.3f} ms "
          f"by CUDA events; {smi}", flush=True)

    launched = kernel_launches()
    print(f"[15-17] K1 to K4 launches on paths G, H and I: {launched} (0 expected: no TPU "
          f"kernel lies on them)", flush=True)
    check(not any(launched.values()), f"paths G to I launched a kernel: {launched}")


def path_j_phases(dev: torch.device, smi: str) -> dict[str, int]:
    """Phase 18: main path J, the tet meshes and the supercell path. No TPU
    kernel lies on it: it runs in plain PyTorch and K5 (the grid V-cycle's
    coarse levels), and K1 to K4 must not launch. Returns the launch counts
    on J (K1 to K4 all 0)."""
    import functools

    from circulantpreconditioner_tpu_torch.drivers import wave_explicit, wave_implicit
    from circulantpreconditioner_tpu_torch.mesh import kershaw_tet_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.models.transport import _identity_plus
    from circulantpreconditioner_tpu_torch.ops.stencil import SupercellNormalOperator
    from circulantpreconditioner_tpu_torch.solvers import make_gmres
    from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC

    f32 = dict(device=dev, dtype=torch.float32)
    rng = np.random.default_rng(18)
    t_phase = time.perf_counter()
    reset_kernel_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()

    # --- 18: main path J, route J-bench at Kershaw-tet NJ^3 ----------------
    t0 = time.perf_counter()
    mesh = kershaw_tet_mesh(((0.0, 1.0),) * 3, (NJ,) * 3)
    t_mesh = time.perf_counter() - t0
    we = WaveSystem(mesh, cfl=1.0 / 3, **f32)  # the explicit model
    t0 = time.perf_counter()
    D = we.divergence
    torch.cuda.synchronize()
    t_bsr = time.perf_counter() - t0
    nnzb = int((D.blocks != 0).any(dim=(1, 2)).sum().item())
    t0 = time.perf_counter()
    S = we.supercell_operator
    torch.cuda.synchronize()
    t_sc = time.perf_counter() - t0
    check(isinstance(S, SupercellNormalOperator), "no supercell normal form at NJ^3")
    coef_bytes = sum(C.numel() * C.element_size() for C in S.arrays)
    n_sites, n = NJ**3, D.shape[0]
    print(f"[18 host build] Kershaw-tet {NJ}^3, eps 0.3: {mesh.n_cells} tets, {mesh.n_faces} "
          f"faces, {n} unknowns, {nnzb} non-zero 4x4 blocks; mesh {t_mesh:.2f} s, assembly (BSR "
          f"on the card) {t_bsr:.2f} s, supercell normal form {t_sc:.2f} s "
          f"({S.F} face slots a tet, offsets {sorted({o for r in S.slot_offset for o in r})}, "
          f"{coef_bytes / 1e6:.1f} MB of tables)", flush=True)

    x = torch.as_tensor(rng.standard_normal(n), **f32)
    y_bsr = D.matvec(x)
    scale = y_bsr.abs().max().item()
    rel_cm = (S.matvec(x) - y_bsr).abs().max().item() / scale
    rel_fm = (we.unpack_fm(S.matvec_fm(we.pack_fm(x))) - y_bsr).abs().max().item() / scale
    print(f"[18 supercell SpMV] against the assembled BSR matvec: max|dy|/max|y| {rel_cm:.3e} "
          f"cell-major, {rel_fm:.3e} field-major (tol {TOL_KERNEL:g})", flush=True)
    check(rel_cm <= TOL_KERNEL and rel_fm <= TOL_KERNEL,
          f"the supercell SpMV is off the BSR matvec: {rel_cm:.3e}, {rel_fm:.3e}")
    g = we.pack_fm(x)
    prof = device_profile(lambda: S.matvec_fm(g), calls=20)
    sc_ms = median_ms({"S": lambda: S.matvec_fm(g), "BSR": lambda: D.matvec(x)}, calls=10,
                      repeats=5)
    sc_graph = graph_ms(lambda: S.matvec_fm(g), calls=10, repeats=5)
    sc_bound, sc_by = bound(2.0 * nnzb * 16, coef_bytes + 2 * 4 * n)
    print(f"[18 supercell SpMV] one field-major apply: {sum(prof.counts.values()) / 20:.0f} kernel "
          f"launches, {sc_ms['S']:.4f} ms by CUDA events, {sc_graph:.4f} ms by CUDA-graph replay, "
          f"device {sum(prof.values()):.4f} ms (profiler); the BSR matvec {sc_ms['BSR']:.4f} ms "
          f"by CUDA events; bound {sc_bound:.4f} ms ({sc_by}: {(coef_bytes + 8 * n) / 1e6:.1f} "
          f"MB, K7's tables, x and y once); {smi}", flush=True)

    step_fm, step_bsr = we.explicit_stepper_fm(), we.explicit_stepper("matrix")
    G, U = we.pack_fm(we.initial_state()), we.initial_state()
    step_fm(G)  # warm-up (the allocator's first blocks); not part of the run
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(20):
        G, _ = step_fm(G)
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for _ in range(20):
        U, _ = step_bsr(U)
    rel = (we.unpack_fm(G) - U).abs().max().item() / U.abs().max().item()
    print(f"[18 main path J] explicit, 20 field-major steps at cfl 1/3: "
          f"{e0.elapsed_time(e1) / 20:.4f} ms per step by CUDA events, wall of the 20 "
          f"{wall:.1f} ms; against 20 BSR steps max|dU|/max|U| {rel:.3e} (tol {TOL_KERNEL:g}); "
          f"{smi}", flush=True)
    check(bool(torch.isfinite(G).all()) and rel <= TOL_KERNEL,
          f"explicit supercell steps are off the BSR steps: {rel:.3e}")
    del we, D, S, step_fm, step_bsr, G, U, g, x, y_bsr

    t0 = time.perf_counter()
    wi = WaveSystem(mesh, cfl=1e3 / 3, **f32)  # bench_suite.py's implicit model
    A_fm = functools.partial(_identity_plus, wi.divergence_op_fm(flat=True))
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    pc = GridVCyclePC.from_grid_model(wi.divergence, mesh.topology_shape, cells_per_site=6,
                                      A0_apply=A_fm, A0_apply_fm=A_fm, shift=1.0,
                                      dtype=torch.float32)
    torch.cuda.synchronize()
    t_pc = time.perf_counter() - t0
    sizes = [f"{pc.levels[0].n} tets -> {pc.levels[0].n_agg} sites"] + [
        "x".join(map(str, L.shape_xyz)) for L in pc.levels[1:]]
    print(f"[18 host build] implicit model (BSR, supercell operator) {t_model:.2f} s, grid "
          f"V-cycle {t_pc:.2f} s: {pc.n_levels} levels ({' -> '.join(sizes)} -> bottom "
          f"{pc.bot_inv.shape[0] // 4} sites); device memory "
          f"{(torch.cuda.memory_allocated() - mem0) / 1e6:.1f} MB held, peak "
          f"{(torch.cuda.max_memory_allocated() - mem0) / 1e6:.1f} MB since the phase began",
          flush=True)

    solver = make_gmres(A_fm, pc.apply_fm, rtol=1e-5, atol=1e-5, maxiter=1000, side="right")
    Dmv = wi.divergence.matvec
    G0 = G = wi.pack_fm(wi.initial_state()).reshape(-1)
    its, conv, walls, true_res, snaps = [], [], [], [], []
    k5_0, k6_0, k7_0 = (kernel_launches()[k] for k in ("K5", "K6", "K7"))
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, snap = solve_run(lambda: solver(G, G))
        walls.append((time.perf_counter() - t0) * 1e3)
        snaps.append(snap)
        x_cm, b_cm = wi.unpack_fm(res.x), wi.unpack_fm(G)
        true_res.append((torch.linalg.norm(x_cm + Dmv(x_cm) - b_cm)
                         / torch.linalg.norm(b_cm)).item())
        its.append(res.iters)
        conv.append(res.converged)
        G = res.x
    k5_j = kernel_launches()["K5"] - k5_0
    fused = sum(sn["vcycle_levels_fused"] for sn in snaps)
    plain = sum(sn["vcycle_levels_plain"] for sn in snaps)
    print(f"[18 main path J] K5 launches in the two solves {k5_j}: level visits below the "
          f"site level fused {fused}, plain {plain} (3 launches a fused visit)", flush=True)
    check(fused > 0 and plain == 0 and k5_j == 3 * fused,
          f"path J: {k5_j} K5 launches, level visits fused {fused} and plain {plain}")
    k6_j = kernel_launches()["K6"] - k6_0
    bj_f = sum(sn["block_jacobi_fused"] for sn in snaps)
    bj_p = sum(sn["block_jacobi_plain"] for sn in snaps)
    below = len(pc.levels) - 1  # the levels below the site level, each a K5 visit an apply
    print(f"[18 main path J] K6 launches in the two solves {k6_j}: the site level's "
          f"block-Jacobi applies fused {bj_f}, plain {bj_p} (2 an apply, {fused // below} "
          f"applies)", flush=True)
    check(bj_f * below == 2 * fused and bj_p == 0 and k6_j == bj_f,
          f"path J: {k6_j} K6 launches, block-Jacobi applies fused {bj_f} and plain {bj_p}")
    k7_j = kernel_launches()["K7"] - k7_0
    sc_f = sum(sn["supercell_fused"] for sn in snaps)
    sc_p = sum(sn["supercell_plain"] for sn in snaps)
    print(f"[18 main path J] K7 launches in the two solves {k7_j}: supercell SpMV applies "
          f"fused {sc_f}, plain {sc_p} (GMRES's A and the site level's two residuals)",
          flush=True)
    check(sc_f > 0 and sc_p == 0 and k7_j == sc_f,
          f"path J: {k7_j} K7 launches, supercell SpMV applies fused {sc_f} and plain {sc_p}")
    # the first step again, warm: bench_suite.py times this solve from U0 on the TPU
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = solver(G0, G0)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(lambda: solver(G0, G0), calls=1)
    print(f"[18 main path J] implicit, cfl 1e3/3, field-major GMRES + grid V-cycle (right, rtol "
          f"atol 1e-5): iterations {its} (the JAX package's TPU record: 41, "
          f"results/bench_suite_r05.json), converged {conv}, ||(I+D)x - b||/||b|| "
          f"{[f'{r:.3e}' for r in true_res]} (tol {TOL_RESIDUAL:g}, assembled operator); wall "
          f"per step {[round(w, 1) for w in walls]} ms; the first step again, warm: "
          f"{warm.iters} iterations, wall {warm_ms:.1f} ms, device {sum(prof.values()):.1f} ms "
          f"(profiler over one more, {sum(prof.counts.values())} launches); {smi}", flush=True)
    check(all(conv) and max(true_res) <= TOL_RESIDUAL and 40 <= its[0] <= 42,
          f"path J at {NJ}^3: iterations {its}, converged {conv}, residuals {true_res}")
    device_j = sum(prof.values())
    record_loop("J", snaps[1], its=its, first_ms=walls[0], capture_s=snaps[0]["capture_seconds"],
                warm_ms=warm_ms, device_ms=device_j, busy=100 * device_j / warm_ms)
    record_loop("J", captures=snaps[0]["captures"] + snaps[1]["captures"])
    torch.cuda.synchronize()
    held, peak = torch.cuda.memory_allocated() - mem0, torch.cuda.max_memory_allocated() - mem0
    n_graphs = len(solver.graphs)
    solver.release()
    torch.cuda.synchronize()
    print(f"[18 memory] device memory since the phase began, with the solver's {n_graphs} graphs: "
          f"{held / 1e6:.1f} MB held, peak {peak / 1e6:.1f} MB (the host loop: 677.6 MB held, "
          f"2,563.9 MB peak); after the solver released its graphs and buffers "
          f"{(torch.cuda.memory_allocated() - mem0) / 1e6:.1f} MB held", flush=True)

    r = G.clone()
    prof = device_profile(lambda: pc.apply_fm(r), calls=3)
    v_ms = median_ms({"V": lambda: pc.apply_fm(r)}, calls=5, repeats=5)["V"]
    v_graph = graph_ms(lambda: pc.apply_fm(r), calls=5, repeats=5)
    print(f"[18 times] one V-cycle apply (field-major): {sum(prof.counts.values()) / 3:.0f} kernel "
          f"launches, {v_ms:.3f} ms by CUDA events, {v_graph:.3f} ms by CUDA-graph replay, device "
          f"{sum(prof.values()):.3f} ms (profiler); largest: " + "; ".join(
              f"{k[:40]} {v:.3f} ms x{prof.counts[k] // 3}" for k, v in
              sorted(prof.items(), key=lambda kv: -kv[1])[:3]) + f"; {smi}", flush=True)
    del wi, pc, solver, A_fm, Dmv, G, G0, r, res, warm, x_cm, b_cm

    # --- 18: the drivers at 16^3: the implicit driver's field-major loop
    # over the block-sparse supercell stencil, and the explicit loop
    nd = 16
    for label, module, argv in (
            ("wave_implicit --pc gridmg kershawtet", wave_implicit,
             ["--mesh-family", "kershawtet", "--pc", "gridmg"]),
            ("wave_explicit tetra", wave_explicit, ["--mesh-family", "tetra"])):
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            res = module.main(argv + [str(nd)] * 3 + ["--ntmax", "2", "--tmax", "1e9",
                                                      "--device", "cuda", "--result-dir", out_dir])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        its = [d["extras"][0] for d in res.diagnostics if d["extras"]]
        conv = [d["extras"][2] for d in res.diagnostics if d["extras"]]
        print(f"[18 driver] {label} {nd}^3: {res.iterations} steps, iterations {its}, converged "
              f"{conv}, ms/step {[round(t * 1e3, 1) for t in res.step_seconds]}, driver wall "
              f"{wall:.2f} s; {smi}", flush=True)
        check(res.iterations == 2 and all(conv) and bool(torch.isfinite(res.state).all()),
              f"{label}: {res.iterations} steps, iterations {its}, converged {conv}")

    wd = WaveSystem(kershaw_tet_mesh(((0.0, 1.0),) * 3, (nd,) * 3), cfl=1e3 / 3, **f32)
    x = torch.randn(wd.divergence.shape[0], **f32)
    forms = {"dense M = 24, cell-major ('varying')": wd.divergence_op("varying"),
             "the normal form in K7, field-major (the explicit driver's)":
                 wd.divergence_op_fm(flat=True)}
    ms = median_ms({k: functools.partial(f, x) for k, f in forms.items()}, calls=10, repeats=5)
    print(f"[18 times] one D apply at Kershaw-tet {nd}^3: " + "; ".join(
        f"{k} {ms[k]:.4f} ms by CUDA events, {graph_ms(functools.partial(f, x), 10, 5):.4f} by "
        f"graph replay" for k, f in forms.items()) + f"; {smi}", flush=True)

    launched = kernel_launches()
    print(f"[18] K1 to K7 launches on path J: {launched} (K1 to K4 0 expected: no TPU kernel "
          f"lies on it); phase 18 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(not any(launched[k] for k in ("K1", "K2", "K3", "K4")),
          f"path J launched a TPU kernel's port: {launched}")
    return launched


def write_gmsh(path: str, points, cells) -> str:
    """A Gmsh MSH 2.2 ASCII file of hexahedra (type 5) or tetrahedra (type 4),
    node ids from 1 in order, coordinates to 17 significant digits (exact)."""
    points, cells = np.asarray(points, dtype=np.float64), np.asarray(cells, dtype=np.int64)
    etype = {4: 4, 8: 5}[cells.shape[1]]
    with open(path, "w") as f:
        f.write(f"$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n{len(points)}\n")
        np.savetxt(f, np.column_stack([np.arange(1, len(points) + 1), points]),
                   fmt="%d %.17g %.17g %.17g")
        f.write(f"$EndNodes\n$Elements\n{len(cells)}\n")
        np.savetxt(f, np.column_stack([np.arange(1, len(cells) + 1),
                                       np.tile([etype, 2, 0, 1], (len(cells), 1)), cells + 1]),
                   fmt="%d")
        f.write("$EndElements\n")
    return path


def read_vtk_cells(path: str) -> tuple[dict[str, int], np.ndarray]:
    """The header counts (CELLS, CELL_TYPES, CELL_DATA) of a write_vtk file of
    a wave state and its cell-major state (nC, 4): pressure, then velocity."""
    lines = open(path).read().split("\n")
    counts = {ln.split()[0]: int(ln.split()[1]) for ln in lines
              if ln.split()[:1] in (["CELLS"], ["CELL_TYPES"], ["CELL_DATA"])}
    n = counts["CELL_DATA"]
    i = lines.index("SCALARS pressure double 1") + 2
    j = lines.index("VECTORS velocity double") + 1
    p = np.array(lines[i:i + n], dtype=np.float64)
    v = np.array(" ".join(lines[j:j + n]).split(), dtype=np.float64).reshape(n, 3)
    return counts, np.column_stack([p, v])


def mesh_file_phases(dev: torch.device, smi: str, mesh64, path_d) -> dict[str, int]:
    """Phase 19: mesh files on the card. Path D from a Gmsh file of Kershaw
    64³ (19a), the FFT projection PC on a Kershaw-tet file with duplicated
    vertices (19b), the VTK writer (19c), the profiling utilities (19d).
    Returns K2's launches by file path."""
    from circulantpreconditioner_tpu_torch.drivers import wave_explicit, wave_implicit
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh, kershaw_tet_mesh, read_mesh
    from circulantpreconditioner_tpu_torch.mesh.conforming import count_nonconforming_pairs
    from circulantpreconditioner_tpu_torch.mesh.topology import recover_grid_topology
    from circulantpreconditioner_tpu_torch.mesh.unstructured import read_gmsh, weld_points
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator
    from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC
    from circulantpreconditioner_tpu_torch.utils import graphs
    from circulantpreconditioner_tpu_torch.utils.profiling import timed, trace

    t_phase = time.perf_counter()
    cube = ((-0.5, 0.5),) * 3
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--tmax", "1e9", "--device", "cuda", "--result-dir", f"{tmp}/out"]
        # --- 19a: path D from a Gmsh file of Kershaw NW^3 --------------------
        host = {}
        with timed(host, "write"):
            path = write_gmsh(f"{tmp}/kershaw{NW}.msh", mesh64.points, mesh64.cell_vertices)
        with timed(host, "read (parse, weld, faces)"):
            m = read_gmsh(path)
        with timed(host, "of which weld"):
            weld_points(m.points)
        with timed(host, "topology recovery"):
            recovered = recover_grid_topology(m)
        arrays = ("points", "cell_center", "cell_volume", "face_cells", "face_normal",
                  "face_area", "face_center", "face_group")
        same = all(np.array_equal(getattr(m, a), getattr(mesh64, a)) for a in arrays)
        print(f"[19a mesh file] Kershaw {NW}^3 Gmsh file ({os.path.getsize(path) / 1e6:.1f} MB, "
              f"shared vertices), host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                            host.items())
              + f"; topology_shape {getattr(m, 'topology_shape', None)}, welded {m.welded_nodes}, "
              f"every mesh array equal to kershaw_mesh's bit for bit: {same}", flush=True)
        check(recovered and m.topology_shape == (NW,) * 3 and same,
              f"the Kershaw {NW}^3 file did not give kershaw_mesh's grid")
        reset_kernel_launches()
        res = wave_implicit.main([path, "--pc", "gridmg", "--ntmax", "2"] + common)
        k2 = kernel_launches()["K2"]
        its = [d["extras"][0] for d in res.diagnostics]
        conv = [d["extras"][2] for d in res.diagnostics]
        U9 = path_d["state"]
        rel = (res.state - U9).abs().max().item() / U9.abs().max().item()
        print(f"[19a main path D from a file] wave_implicit {os.path.basename(path)} --pc gridmg: "
              f"iterations {its} (phase 9: {path_d['its']}), converged {conv}, K2 launches {k2} "
              f"(phase 9: {path_d['k2']}), max|U - U_phase9|/max|U_phase9| {rel:.3e} (tol 1e-6; "
              f"bit for bit: {bool(torch.equal(res.state, U9))}), ms/step "
              f"{[round(t * 1e3, 1) for t in res.step_seconds]}; {smi}", flush=True)
        check(its == path_d["its"] and all(conv) and k2 == path_d["k2"] and rel <= 1e-6,
              f"path D from the file: iterations {its}, K2 launches {k2}, deviation {rel:.3e}")
        launches[f"D wave_implicit gridmg from a Gmsh file {NW}^3"] = k2

        # --- 19d: one 19a step under the profiling utilities ------------------
        model = WaveSystem(m, cfl=1e3 / 3, device=dev, dtype=torch.float32)
        pc = GridVCyclePC.from_grid_model(model.divergence, m.topology_shape,
                                          A0_apply=model.implicit_matvec(),
                                          A0_apply_fm=model.implicit_matvec_fm(), shift=1.0,
                                          dtype=torch.float32)
        step = model.implicit_stepper_fm(M_fm=pc.apply_fm, side="right")
        G = model.pack_fm(model.initial_state()).reshape(-1)
        step(G)  # warm-up
        t = {}
        graphs.STATS.reset()
        k2_0 = kernel_launches()["K2"]
        with trace(f"{tmp}/trace") as logdir, timed(t, "traced"):
            step(G)
        k2 = kernel_launches()["K2"] - k2_0
        traced = graphs.STATS.snapshot()
        for k in range(2):
            with timed(t, f"step {k}"):
                step(G)
        untraced = graphs.STATS.snapshot()
        spans = {k: v for k, v in traced.items() if k.startswith("span_") and k.endswith("_n")}
        traces = [f for f in os.listdir(logdir) if f.endswith(".json")]
        text = open(os.path.join(logdir, traces[0])).read() if len(traces) == 1 else ""
        print(f"[19d profiling] trace: {traces} ({len(text) / 1e6:.1f} MB), names K2's kernel "
              f"k2_plane_stencil_kernel {text.count('k2_plane_stencil_kernel')} times, the host "
              f"span port.flag_wait {text.count('port.flag_wait')} times; timed "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in t.items())
              + f"; device span entries {spans}, K2 launches {k2}; port.op seconds "
              f"{traced['span_port_op_incl_s']:.6f}, after two untraced steps "
              f"{untraced['span_port_op_incl_s']:.6f}; {smi}", flush=True)
        check(traced["span_port_op_n"] == k2 > 0 and "port.flag_wait" in text
              and {k: untraced[k] for k in spans} == spans,
              "the spans of the traced step: port.op's entries are not K2's launches, the "
              "trace lacks port.flag_wait, or untraced steps added to the spans")
        check("k2_plane_stencil_kernel" in text, "the trace does not name K2's kernel")
        del model, pc, step, G, m, res, text

        # --- 19b: the FFT projection PC on a Kershaw-tet file -----------------
        nt = 16
        mt = kershaw_tet_mesh(cube, (nt,) * 3)
        cells = np.asarray(mt.cell_vertices)
        path = write_gmsh(f"{tmp}/kershawtet{nt}.msh", mt.points[cells.reshape(-1)],
                          np.arange(cells.size).reshape(cells.shape))
        t0 = time.perf_counter()
        m = read_mesh(path)
        t_read = time.perf_counter() - t0
        pieces = count_nonconforming_pairs(m)
        inv = np.argsort(m.cell_permutation)
        d_ctr = np.abs(m.cell_center[inv] - mt.cell_center).max()
        d_vol = np.abs(m.cell_volume[inv] - mt.cell_volume).max()
        print(f"[19b mesh file] Kershaw-tet {nt}^3 Gmsh file ({mt.n_cells} tets, {cells.size} "
              f"nodes, each cell's own): read_mesh {t_read:.2f} s; welded {m.welded_nodes} "
              f"({len(m.points)} nodes), non-conforming pairs left {pieces}, topology_shape "
              f"{getattr(m, 'topology_shape', None)}, bandwidth_ordered "
              f"{getattr(m, 'bandwidth_ordered', False)}; with cell_permutation undone, "
              f"max|d centre| {d_ctr:.1e}, max|d volume| {d_vol:.1e} (tol 1e-12)", flush=True)
        check(m.welded_nodes and pieces == 0 and getattr(m, "topology_shape", None) is None
              and getattr(m, "bandwidth_ordered", False) and max(d_ctr, d_vol) <= 1e-12,
              "the Kershaw-tet file was not welded, RCM-ordered and equal to kershaw_tet_mesh")
        model = WaveSystem(m, cfl=1e3 / 3, device=dev, dtype=torch.float32)
        W = WindowedBlockOperator.from_bsr(model.divergence, dtype=torch.float32)
        x = torch.randn(model.divergence.shape[0], device=dev, dtype=torch.float32)
        y = model.divergence.matvec(x)
        rel = (W.matvec(x) - y).abs().max().item() / y.abs().max().item()
        print(f"[19b window SpMV] against the BSR matvec: max|dy|/max|y| {rel:.3e} (tol 1e-5)",
              flush=True)
        check(rel <= 1e-5, f"the window SpMV is off the BSR matvec: {rel:.3e}")
        out = f"{tmp}/out19b"
        reset_kernel_launches()
        res = wave_implicit.main([path, "--pc", "circulant2l", "--ntmax", "2", "--vtk",
                                  "--output-freq", "1"] + common[:-1] + [out])
        launches[f"wave_implicit circulant2l from a Kershaw-tet file {nt}^3"] = kernel_launches()["K2"]
        its = [d["extras"][0] for d in res.diagnostics]
        conv = [d["extras"][2] for d in res.diagnostics]
        m64 = WaveSystem(m, cfl=1e3 / 3, device=dev, dtype=torch.float64)
        U = [m64.initial_state()]
        for k in (1, 2):
            _, Uk = read_vtk_cells(f"{out}/{os.path.basename(path)}_wave_{k:06d}.vtk")
            U.append(torch.as_tensor(Uk.reshape(-1), device=dev))
        res_true = [(torch.linalg.norm(U[k] + m64.divergence.matvec(U[k]) - U[k - 1])
                     / torch.linalg.norm(U[k - 1])).item() for k in (1, 2)]
        d_final = ((U[2] - res.state.double()).abs().max() / res.state.abs().max()).item()
        print(f"[19b FFT projection PC] wave_implicit {os.path.basename(path)} --pc circulant2l "
              f"(float32): iterations {its} (the JAX package, float32 on a CPU: 299 and 254), "
              f"converged {conv}, ||(I+D)U_k - U_k-1||/||U_k-1|| {[f'{r:.3e}' for r in res_true]} "
              f"(tol {TOL_RESIDUAL:g}, float64 assembled operator, states read back from the "
              f"VTK files, max|dU|/max|U| to the final state {d_final:.1e}), ms/step "
              f"{[round(t * 1e3, 1) for t in res.step_seconds]}; {smi}", flush=True)
        check(len(its) == 2 and all(conv) and max(res_true) <= TOL_RESIDUAL and d_final <= 1e-6,
              f"circulant2l from the file: iterations {its}, converged {conv}, residuals "
              f"{res_true}")
        del model, m64, W, x, y, U, res

        # --- 19c: the VTK writer from the explicit driver ---------------------
        mk = kershaw_mesh(cube, (nt,) * 3)
        path = write_gmsh(f"{tmp}/kershaw{nt}.msh", mk.points, mk.cell_vertices)
        out = f"{tmp}/out19c"
        reset_kernel_launches()
        res = wave_explicit.main([path, "--ntmax", "3", "--vtk", "--output-freq", "1"]
                                 + common[:-1] + [out])
        k2 = kernel_launches()["K2"]
        launches[f"C wave_explicit from a Gmsh file {nt}^3"] = k2
        files = sorted(os.listdir(out))
        counts = [read_vtk_cells(f"{out}/{f}")[0] for f in files]
        _, U3 = read_vtk_cells(f"{out}/{files[-1]}")
        U_fin = res.state.double().cpu().numpy()
        d_final = np.abs(U3.reshape(-1) - U_fin).max() / np.abs(U_fin).max()
        print(f"[19c writers] wave_explicit {os.path.basename(path)} --vtk, 3 steps: files {files}, "
              f"header counts {counts}, K2 launches {k2}, max|dU|/max|U| of the last file to the "
              f"final state {d_final:.1e} (tol 1e-6)", flush=True)
        check(len(files) == 3 and all(c == {"CELLS": mk.n_cells, "CELL_TYPES": mk.n_cells,
                                            "CELL_DATA": mk.n_cells} for c in counts)
              and k2 == 3 and d_final <= 1e-6, f"wave_explicit --vtk: files {files}, {counts}")
    check("h5py" not in sys.modules, "phase 19 imported h5py")
    print(f"[19] phase 19 took {time.perf_counter() - t_phase:.1f} s; K2 launches {launches}",
          flush=True)
    return launches


def run_captured(main, argv) -> tuple:
    """A driver's main(argv), its stdout echoed and returned: (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv)
    sys.stdout.write(buf.getvalue())
    return res, buf.getvalue()


def nccl_per_call(fn, calls: int = 20) -> dict[str, float]:
    """The NCCL records and kernels torch.profiler shows per call of fn, by
    name (the collectives' own records, nccl:*, and NCCL's kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count / calls for e in prof.key_averages() if "nccl" in e.key.lower()}


# the row-sharded GMRES's iterations at Kershaw NW^3 in float32 on one NCCL
# rank, uncaptured (PERF.md §6). circulant2l's are held: its slab solve runs
# the JAX PC's "high" tier, bf16×3 through K4, since PR 16 (107 and 62; 106
# and 62 while every tier ran fp32). pbjacobi's ~800
# float32 iterations move between calls with capture off too (740 against
# 744 once; one device 807 against 805), so its captured run is held to the
# uncaptured run of the same call (sharded_run) and printed beside these
SHARDED_ITERS = {"pbjacobi": [744, 816], "circulant2l": [107, 62]}


def distributed_phases(dev: torch.device, smi: str, mesh64, path_c_state,
                       inside=None) -> tuple[dict[str, int], object]:
    """Phase 20: the distributed layer (parallel/) on a world of one rank, the
    card, through NCCL: the slab and pencil solves and the sharded drivers
    at full size (20a to 20d), each sharded operator's time per apply beside
    its one-device counterpart and the NCCL records of one apply. At one rank
    every collective is issued and copies the rank's own data: the times are
    the layer's cost on one card, not scaling figures. `inside(dm)` runs last,
    in the same world (phase 24), its seconds apart. Returns K1 to K3's
    launches on the sharded drivers (none expected) and what `inside`
    returned."""
    import torch.distributed as dist

    from circulantpreconditioner_tpu_torch.drivers import transport_fft, wave_explicit, wave_implicit
    from circulantpreconditioner_tpu_torch.mesh import (
        cartesian_mesh,
        kershaw_mesh,
        kershaw_tet_mesh,
        read_mesh,
    )
    from circulantpreconditioner_tpu_torch.models import TransportEquation, WaveSystem
    from circulantpreconditioner_tpu_torch.ops.assembly import wave_block_stencil
    from circulantpreconditioner_tpu_torch.ops.circulant import CirculantTransportOperator
    from circulantpreconditioner_tpu_torch.ops.dft_matmul import MatmulBlockCirculantSolver
    from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator
    from circulantpreconditioner_tpu_torch.parallel import (
        DistributedBlockCirculantPC,
        HaloELLMatrix,
        HaloWindowOperator,
        PencilCirculantSolver,
        ShardedELLMatrix,
        SlabBlockCirculantSolver,
        SlabCirculantSolver,
        SlabStencilOperator,
        device_mesh,
        device_mesh_2d,
        gather_to_host0,
        rank_world,
        sharded_pbjacobi,
    )
    from circulantpreconditioner_tpu_torch.parallel.fft_dist import make_distributed_fft3
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import BlockCirculantProjectionPC
    from circulantpreconditioner_tpu_torch.utils.graphs import CapturedStep

    t_phase = time.perf_counter()
    rng = np.random.default_rng(20)
    f32 = dict(device=dev, dtype=torch.float32)
    launched = dict.fromkeys(kernel_launches(), 0)

    def sharded_run(main, argv):
        """The driver captured (its steps, or its GMRES, as graph replays
        with the collectives inside), then with capture off: the same
        iterations, states within 1e-6, the captured run's graph replays."""
        from circulantpreconditioner_tpu_torch.utils import graphs

        reset_kernel_launches()
        graphs.STATS.reset()
        res, text = run_captured(main, argv)
        snap = graphs.STATS.snapshot()
        graphs.CAPTURE = False
        graphs.STATS.reset()
        try:
            eager = main(argv)
        finally:
            graphs.CAPTURE = True
        eager_snap = graphs.STATS.snapshot()
        for k, v in kernel_launches().items():
            launched[k] += v
        its = [d["extras"][0] for d in res.diagnostics if d["extras"]]
        its_e = [d["extras"][0] for d in eager.diagnostics if d["extras"]]
        rel = ((res.state - eager.state).abs().max() / eager.state.abs().max()).item()
        label = " ".join(a for a in argv if a not in common and not a.startswith(tmp))
        print(f"[20 captured] {main.__module__.rsplit('.', 1)[1]} {label}: "
              f"{snap['captures']} graphs, {snap['replays']} replays; ms/step captured "
              f"{[round(t * 1e3, 3) for t in res.step_seconds]}, capture off "
              f"{[round(t * 1e3, 3) for t in eager.step_seconds]}; iterations {its} (capture "
              f"off {its_e}); max|dU|/max|U| {rel:.3e} (tol 1e-6); {smi}", flush=True)
        check(snap["replays"] > 0 and snap["captures"] > 0 and eager_snap["replays"] == 0,
              f"{label}: captured {snap}, capture off {eager_snap}")
        check(its == its_e and res.iterations == eager.iterations and rel <= 1e-6,
              f"{label}: captured {its} against {its_e}, states {rel:.3e} apart")
        return res, text

    def per_apply(label: str, sharded, single, single_label: str, collectives: bool = True):
        ev = median_ms({"sharded": sharded, "single": single})
        gr = {"sharded": graph_ms(sharded), "single": graph_ms(single)}
        nccl = nccl_per_call(sharded)
        print(f"[20 times] {label}: {ev['sharded']:.4f} ms/apply by CUDA events, "
              f"{gr['sharded']:.4f} by CUDA-graph replay; {single_label} {ev['single']:.4f} "
              f"and {gr['single']:.4f}; NCCL per apply {nccl}; {smi}", flush=True)
        check(bool(nccl) == collectives, f"{label}: NCCL records per apply {nccl}")

    with rank_world(None, dev), tempfile.TemporaryDirectory() as tmp:
        dm = device_mesh()
        check(dist.get_backend() == "nccl" and dm.shape == {"shard": 1}
              and dm.device.type == "cuda", f"phase 20's world: {dist.get_backend()}, {dm.shape}")
        common = ["--tmax", "1e9", "--device", "cuda", "--result-dir", f"{tmp}/out"]
        # --- 20a: transport at N^3, the slab and pencil solves -------------
        op = CirculantTransportOperator.create((N, N, N), flagship_lambdas(), **f32)
        b = torch.as_tensor(rng.random((N, N, N)), **f32)
        x_ref = op.solve(b)
        solvers = {"slab": SlabCirculantSolver.from_operator(op, dm),
                   "pencil 1x1": PencilCirculantSolver.from_operator(op, device_mesh_2d((1, 1)))}
        for name, s in solvers.items():
            x = s.unshard(s.solve(s.shard(b)))
            rel = ((x - x_ref).abs().max() / x_ref.abs().max()).item()
            res = rel_residual(op, x, b)
            print(f"[20a {name}] {N}^3 flagship: max|x - x_cuFFT|/max|x_cuFFT| {rel:.3e} "
                  f"(tol 1e-5), ||Cx - b||/||b|| {res:.3e} (tol {TOL_RESIDUAL:g})", flush=True)
            check(rel <= 1e-5 and res <= TOL_RESIDUAL, f"the {name} solve: {rel:.3e}, {res:.3e}")
        model = TransportEquation(cartesian_mesh(((-0.5, 0.5),) * 3, (N,) * 3, periodic=True),
                                  [1.0, 0.0, 0.0], cfl=1e3 / 3, **f32)
        u_ref = model.initial_state().reshape(op.shape_zyx)
        for _ in range(3):  # the driver's three steps on one device
            u_ref = model.fft_operator.solve(u_ref)
        for shard in ("slab", "pencil"):
            r, _ = sharded_run(transport_fft.main, [str(N)] * 3 + ["--shard", shard,
                                                                   "--ntmax", "3"] + common)
            u = r.state.reshape(-1)
            rel = ((u - u_ref.reshape(-1)).abs().max() / u_ref.abs().max()).item()
            print(f"[20a driver] transport_fft {N}^3 --shard {shard}: 3 steps, median "
                  f"{np.median(r.step_seconds) * 1e3:.3f} ms/step, max|u - u_1dev|/max|u_1dev| "
                  f"{rel:.3e} (tol 1e-5)", flush=True)
            check(r.iterations == 3 and bool(torch.isfinite(u).all()) and rel <= 1e-5,
                  f"transport_fft --shard {shard}: {r.iterations} steps, {rel:.3e}")
        for name, s in solvers.items():
            bs = s.shard(b)
            per_apply(f"{name} solve {N}^3", lambda: s.solve(bs), lambda: op.solve(b),
                      "cuFFT CirculantTransportOperator.solve")
        v = torch.complex(b, torch.flip(b, dims=(0,)))
        fft3 = make_distributed_fft3(dm)
        vh = dm.all_gather(fft3(v), "shard")
        rel = ((vh - torch.fft.fftn(v)).abs().max() / torch.fft.fftn(v).abs().max()).item()
        check(rel <= 1e-5, f"make_distributed_fft3 is off torch.fft.fftn: {rel:.3e}")
        per_apply(f"make_distributed_fft3 {N}^3 (against fftn: {rel:.1e})", lambda: fft3(v),
                  lambda: torch.fft.fftn(v), "torch.fft.fftn (one device)")
        del solvers, op, b, x_ref, model, u_ref, v, vh

        # --- 20b: Kershaw NW^3 explicit, slab and rows ---------------------
        kershaw = ["--mesh-family", "kershaw", str(NW), str(NW), str(NW)] + common
        for shard in ("slab", "rows"):
            r, text = sharded_run(wave_explicit.main, kershaw + ["--shard", shard, "--ntmax", "20"])
            rel = ((r.state - path_c_state).abs().max() / path_c_state.abs().max()).item()
            print(f"[20b driver] wave_explicit Kershaw {NW}^3 --shard {shard}: 20 steps, median "
                  f"{np.median(r.step_seconds) * 1e3:.4f} ms/step, max|U - U_pathC|/max|U_pathC| "
                  f"{rel:.3e} (tol 1e-5)", flush=True)
            check(r.iterations == 20 and rel <= 1e-5, f"wave_explicit --shard {shard}: {rel:.3e}")
        # a chunk of 20 slab steps as one graph: the ranks' dnorms reduced
        # inside it (run_time_loop's way) against one eager all-reduce after
        # its replay
        me = WaveSystem(mesh64, cfl=1.0 / 3, **f32)
        S = SlabStencilOperator(me.varying_operator, dm)

        def slab_step(u):
            du = S.matvec(u)
            return u - du, torch.linalg.norm(du.reshape(-1))

        xs0 = S.shard_vector(me.initial_state())
        in_graph, after = CapturedStep(slab_step), CapturedStep(slab_step)
        chunks = {"norms inside the graph": lambda: (
                      in_graph.start(xs0, dm.global_norms), in_graph.advance(20).cpu())[1],
                  "one eager all-reduce per chunk": lambda: (
                      after.start(xs0), dm.global_norms(after.advance(20)).cpu())[1]}
        dn = {name: run() for name, run in chunks.items()}
        check(torch.equal(*dn.values()), f"the chunk's global dnorms differ: {dn}")
        walls = {name: np.median(step_walls(lambda _: run(), None, reps=7)) / 20
                 for name, run in chunks.items()}
        print(f"[20b chunk] 20 slab steps at Kershaw {NW}^3 as one graph, wall per step: "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in walls.items())
              + f" (the same dnorms); {smi}", flush=True)
        del me, S, in_graph, after
        # --- 20c: Kershaw NW^3 implicit, --shard rows ----------------------
        # float32 is the drivers' precision; its GMRES counts are printed
        # beside one device's. The counts are held (± 1) in float64, at
        # (NW/4)^3 to keep the phase short: in float32 two correct orders of
        # summation part by many iterations (pbjacobi at Kershaw 8^3 on a
        # CPU: 226 sharded, 219 on one device, 126 for both in float64)
        for pc in ("pbjacobi", "circulant2l"):
            for prec in ("float32", "float64"):
                n = str(NW if prec == "float32" else NW // 4)
                argv = (["--mesh-family", "kershaw", n, n, n] + common
                        + ["--pc", pc, "--ntmax", "2"] + (["--f64"] if prec == "float64" else []))
                r, text = sharded_run(wave_implicit.main, argv + ["--shard", "rows"])
                r1 = wave_implicit.main(argv)
                its = [d["extras"][0] for d in r.diagnostics]
                its1 = [d["extras"][0] for d in r1.diagnostics]
                conv = [d["extras"][2] for d in r.diagnostics]
                rel = ((r.state - r1.state).abs().max() / r1.state.abs().max()).item()
                print(f"[20c driver] wave_implicit Kershaw {n}^3 --shard rows --pc {pc} {prec}: "
                      f"iterations {its} (one device: {its1}"
                      + (f"; uncaptured, as recorded: {SHARDED_ITERS[pc]}" if prec == "float32"
                         else "") + f"), converged {conv}, ms/step "
                      f"{[round(t * 1e3, 1) for t in r.step_seconds]} (one device: "
                      f"{[round(t * 1e3, 1) for t in r1.step_seconds]}), "
                      f"max|U - U_1dev|/max|U_1dev| {rel:.3e}", flush=True)
                check(len(its) == 2 and bool(torch.isfinite(r.state).all()),
                      f"--shard rows --pc {pc} {prec}: iterations {its}, non-finite state")
                if prec == "float32" and pc == "circulant2l":
                    check(its == SHARDED_ITERS[pc], f"--shard rows --pc {pc} float32: "
                          f"iterations {its}, uncaptured {SHARDED_ITERS[pc]}")
                if prec == "float64":
                    check(all(abs(a - c) <= 1 for a, c in zip(its, its1)),
                          f"--shard rows --pc {pc} float64: iterations {its} against {its1}")
        # the sharded operators at NW^3 (one model: the time step does not
        # change an apply's cost), the projection PC at (NW/2)^3, whose host
        # build at NW^3 takes about 8 s per PC
        mw = WaveSystem(mesh64, cfl=1e3 / 3, **f32)
        D = mw.divergence
        V = mw.varying_operator
        U0 = mw.initial_state()
        S = SlabStencilOperator(V, dm)
        xs = S.shard_vector(U0)
        full = gather_to_host0(xs)
        check(full is not None and np.array_equal(full.reshape(-1), U0.cpu().numpy()),
              "gather_to_host0 did not return the whole state on rank 0")
        print(f"[20 gather_to_host0] rank 0 holds {full.shape}, equal to the state", flush=True)
        per_apply(f"SlabStencilOperator Kershaw {NW}^3", lambda: S.matvec(xs),
                  lambda: V.matvec(U0), "VaryingStencilOperator.matvec (one device)")
        A = D.to_csr(torch.float32)
        for cls in (HaloELLMatrix, ShardedELLMatrix):
            Ar = cls(A, dm, row_multiple=4)
            xr = Ar.shard_vector(U0)
            per_apply(f"{cls.__name__} Kershaw {NW}^3", lambda: Ar.matvec(xr),
                      lambda: D.matvec(U0), "BSRMatrix.matvec (one device)")
        Dinv = np.linalg.inv(D.block_diagonal().cpu().numpy() + np.eye(4)[None, :, :])
        pj_d = sharded_pbjacobi(Dinv, Ar.n_padded, dm)
        pj_1 = pcs.pbjacobi(D, shift=1.0)
        per_apply(f"sharded_pbjacobi Kershaw {NW}^3", lambda: pj_d(xr), lambda: pj_1(U0),
                  "pbjacobi (one device)", collectives=False)
        # the all-matmul block-circulant slab solve, the PC's coarse solve
        offsets, blocks = wave_block_stencil(3, mw.dt, mw.c0, (1.0 / NW,) * 3)
        sb = SlabBlockCirculantSolver.from_stencil((NW,) * 3, offsets, blocks, dm)
        mb = MatmulBlockCirculantSolver.from_stencil((NW,) * 3, offsets, blocks, **f32,
                                                     precision="high")
        bs = sb.shard(U0)
        x1 = mb.solve(U0)
        rel = ((sb.unshard(sb.solve(bs)).reshape(-1) - x1).abs().max() / x1.abs().max()).item()
        check(rel <= 1e-4, f"SlabBlockCirculantSolver is off MatmulBlockCirculantSolver: {rel:.3e}")
        per_apply(f"SlabBlockCirculantSolver {NW}^3 (against the one-device form: {rel:.1e})",
                  lambda: sb.solve(bs), lambda: mb.solve(U0),
                  "MatmulBlockCirculantSolver.solve (one device)")
        del mw, D, V, S, A, Ar, pj_d, pj_1, sb, mb, bs, x1
        nh = NW // 2
        m2 = kershaw_mesh(((-0.5, 0.5),) * 3, (nh,) * 3)
        mi = WaveSystem(m2, cfl=1e3 / 3, **f32)
        Ah = HaloELLMatrix(mi.divergence.to_csr(torch.float32), dm, row_multiple=4)
        r0 = torch.as_tensor(rng.random(mi.divergence.shape[0]), **f32)
        rs = Ah.shard_vector(r0)
        t0 = time.perf_counter()
        pc_d = DistributedBlockCirculantPC(m2, mi.dt, mi.c0, dm, Ah.n_padded, dtype=torch.float32)
        t_d = time.perf_counter() - t0
        t0 = time.perf_counter()
        pc_1 = BlockCirculantProjectionPC(m2, mi.dt, mi.c0, **f32)
        t_1 = time.perf_counter() - t0
        z_d, z_1 = Ah.unshard_vector(pc_d.apply(rs)), pc_1.apply(r0)
        rel = ((z_d - z_1).abs().max() / z_1.abs().max()).item()
        print(f"[20c projection PC] Kershaw {nh}^3: grid {pc_d.n_xyz}, halos {pc_d.halo_fwd} and "
              f"{pc_d.halo_bak} rows; host build {t_d:.2f} s (one device: {t_1:.2f} s); one apply "
              f"against the one-device PC's: max|dz|/max|z| {rel:.3e} (tol 1e-4)", flush=True)
        check(rel <= 1e-4, f"the distributed PC apply is off the one-device apply: {rel:.3e}")
        per_apply(f"DistributedBlockCirculantPC Kershaw {nh}^3", lambda: pc_d.apply(rs),
                  lambda: pc_1.apply(r0), "BlockCirculantProjectionPC.apply (one device)")
        # the sharded GMRES's reductions: three all-reduces per iteration
        # (the two projections, of up to 31 numbers, and a norm)
        h = torch.ones(31, **f32)
        ev = median_ms({"all_reduce": lambda: dm.all_reduce(h), "clone": h.clone})
        print(f"[20 times] RankMesh.all_reduce of 31 float32: {ev['all_reduce']:.4f} ms/call by "
              f"CUDA events, {graph_ms(lambda: dm.all_reduce(h)):.4f} by CUDA-graph replay (its "
              f"clone alone {ev['clone']:.4f}); NCCL per call {nccl_per_call(lambda: dm.all_reduce(h))}"
              f"; {smi}", flush=True)
        del mi, Ah, pc_d, pc_1

        # --- 20d: the window route on phase 19b's welded Kershaw-tet file --
        nt = 16
        mt = kershaw_tet_mesh(((-0.5, 0.5),) * 3, (nt,) * 3)
        cells = np.asarray(mt.cell_vertices)
        path = write_gmsh(f"{tmp}/kershawtet{nt}.msh", mt.points[cells.reshape(-1)],
                          np.arange(cells.size).reshape(cells.shape))
        r, text = sharded_run(wave_implicit.main, [path, "--shard", "rows", "--pc", "circulant2l",
                                                   "--ntmax", "2"] + common)
        its = [d["extras"][0] for d in r.diagnostics]
        conv = [d["extras"][2] for d in r.diagnostics]
        print(f"[20d driver] wave_implicit kershawtet{nt}.msh --shard rows --pc circulant2l: "
              f"route {'halo windowed' if 'halo windowed' in text else 'NOT the window'}, "
              f"iterations {its} (one device: phase 19b's), converged {conv}, "
              f"ms/step {[round(t * 1e3, 1) for t in r.step_seconds]}", flush=True)
        check("halo windowed" in text and len(its) == 2 and all(conv),
              f"the window route: iterations {its}, converged {conv}")
        m = read_mesh(path)
        W = WindowedBlockOperator.from_bsr(WaveSystem(m, cfl=1e3 / 3, **f32).divergence)
        H = HaloWindowOperator(W, dm)
        x1 = torch.as_tensor(rng.random(W.shape[1]), **f32)
        xh = H.shard_vector(x1)
        rel = ((H.unshard_vector(H.matvec(xh)) - W.matvec(x1)).abs().max()
               / W.matvec(x1).abs().max()).item()
        check(rel <= 1e-6, f"HaloWindowOperator is off WindowedBlockOperator: {rel:.3e}")
        per_apply(f"HaloWindowOperator Kershaw-tet {nt}^3 (against W: {rel:.1e})",
                  lambda: H.matvec(xh), lambda: W.matvec(x1), "WindowedBlockOperator.matvec")
        t_inside = time.perf_counter()
        inside_out = inside(dm) if inside is not None else None
        t_inside = time.perf_counter() - t_inside
    check(not dist.is_initialized(), "phase 20 left its process group open")
    print(f"[20] phase 20 took {time.perf_counter() - t_phase - t_inside:.1f} s; K1 to K4 "
          f"launches on the sharded drivers {launched} (K4: circulant2l's slab solve at "
          f"'high')", flush=True)
    check(not (launched["K1"] or launched["K2"] or launched["K3"]) and launched["K4"] > 0,
          f"the sharded drivers launched K1 to K3, or circulant2l no K4: {launched}")
    return launched, inside_out


# the sharded gridmg case at Kershaw NV^3: its one-card GMRES count (the
# bench row wave_implicit_step_ms_kershaw32, results/bench_suite_r05.json)
NV, GRIDMG_ITERS_NV = 32, 33


def sharded_vcycle_phase(dev: torch.device, smi: str, dm) -> dict[str, int]:
    """Phase 24, inside phase 20's world of one NCCL rank: the grid V-cycle on
    z-slabs (parallel/vcycle_dist.py) at Kershaw NV^3 in float32, against the
    one-device GridVCyclePC, and bench_suite.py's distributed row at world
    size 1 with short chains. Returns K1 to K3's launches on the sharded
    GMRES step (counted from 0)."""
    from circulantpreconditioner_tpu_torch import bench_suite
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.parallel import SlabGridVCyclePC
    from circulantpreconditioner_tpu_torch.solvers import make_gmres
    from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC
    from circulantpreconditioner_tpu_torch.utils import graphs

    t_phase = time.perf_counter()
    f32 = dict(device=dev, dtype=torch.float32)
    model = WaveSystem(kershaw_mesh(((0.0, 1.0),) * 3, (NV,) * 3), cfl=1e3 / 3, **f32)
    pc = GridVCyclePC.from_grid_model(model.divergence, model.mesh.topology_shape,
                                      A0_apply=model.implicit_matvec(),
                                      A0_apply_fm=model.implicit_matvec_fm(), shift=1.0,
                                      dtype=torch.float32)
    spc = SlabGridVCyclePC.from_wave_model(model, dm, pc=pc)
    r = torch.as_tensor(np.random.default_rng(24).random(model.divergence.shape[0]), **f32)
    z1 = pc.apply_fm(r)
    rel = ((spc.unshard(spc.apply(spc.shard(r))) - z1).abs().max() / z1.abs().max()).item()
    print(f"[24 apply] SlabGridVCyclePC at Kershaw {NV}^3 ({spc.describe()}) against "
          f"GridVCyclePC.apply_fm: max|dz|/max|z| {rel:.3e} (tol 1e-5)", flush=True)
    check(rel <= 1e-5, f"the sharded V-cycle apply is off the one-device apply: {rel:.3e}")

    # K2 at the path's shape, the rank's slab and its two halo planes, against
    # its plain version on the same inputs
    Wx = spc.fine.op
    x_ext = torch.as_tensor(np.random.default_rng(25).random((Wx.m, Wx.arrays[1].shape[-1])),
                            **f32)
    y_k2, y_plain = spc.fine.ext_apply(x_ext), Wx.matvec_fm(x_ext)
    err = ((y_k2 - y_plain).abs().max() / y_plain.abs().max()).item()
    print(f"[24 K2] on the slab and halo planes {tuple(x_ext.shape)} (grid {Wx.shape_zyx}): "
          f"max|y_K2 - y_plain|/max|y_plain| {err:.3e} (tol {TOL_K2[torch.float32]:g})",
          flush=True)
    check(err <= TOL_K2[torch.float32], f"K2 on the slab is off its plain version: {err:.3e}")
    kw = dict(rtol=1e-5, atol=1e-5, maxiter=1000, side="right")
    G0 = model.pack_fm(model.initial_state()).reshape(-1)
    b = spc.shard(G0)
    one = make_gmres(model.implicit_matvec_fm(), pc.apply_fm, **kw)
    sharded = make_gmres(spc.fine, spc.apply, allreduce=dm.all_reduce, **kw)
    r1 = one(G0, G0)
    graphs.STATS.reset()
    reset_kernel_launches()
    rs = sharded(b, b)  # the path: the sharded GMRES step, captured
    launched = kernel_launches()
    snap = graphs.STATS.snapshot()
    warm = {}
    for name, solve, x0 in (("one device", one, G0), ("sharded", sharded, b)):
        reset_kernel_launches()
        solve(x0, x0)
        warm[name] = kernel_launches()["K2"]
    graphs.CAPTURE = False
    graphs.STATS.reset()
    try:
        eager = make_gmres(spc.fine, spc.apply, allreduce=dm.all_reduce, **kw)
        re = eager(b, b)
    finally:
        graphs.CAPTURE = True
    eager_replays = graphs.STATS.replays
    rel1 = ((spc.unshard(rs.x) - r1.x).abs().max() / r1.x.abs().max()).item()
    rel_e = ((rs.x - re.x).abs().max() / re.x.abs().max()).item()
    print(f"[24 GMRES] Kershaw {NV}^3 field-major GMRES + grid V-cycle: sharded over one NCCL "
          f"rank {rs.iters} iterations (converged {rs.converged}; {snap['captures']} graphs, "
          f"{snap['replays']} replays), one device {r1.iters}, r05 {GRIDMG_ITERS_NV}; "
          f"max|x - x_1dev|/max|x_1dev| {rel1:.3e}; K2 launches of a warm step: sharded "
          f"{warm['sharded']}, one device {warm['one device']}; capture off {re.iters} "
          f"iterations, max|dx|/max|x| {rel_e:.3e} (tol 1e-6); {smi}", flush=True)
    check(rs.converged and rs.iters == r1.iters == GRIDMG_ITERS_NV,
          f"sharded gridmg {rs.iters} iterations, one device {r1.iters}")
    check(warm["sharded"] == warm["one device"] > 0, f"K2 launches per step {warm}")
    check(snap["replays"] > 0 and eager_replays == 0 and re.iters == rs.iters and rel_e <= 1e-6,
          f"captured {rs.iters} ({snap}) against capture off {re.iters} ({eager_replays} "
          f"replays), {rel_e:.3e}")
    for s in (one, sharded, eager):
        s.release()  # before the group closes: NCCL waits for graphs that hold it

    # the row's circulant2l gate is r05's count, which 8 virtual CPU devices
    # computed in fp32 (XLA's CPU backend ignores the tier): held at
    # "highest"; at the JAX row's "high" (bf16×3 through K4) the count is
    # printed beside it and every other gate held
    runs = {}
    for precision in ("highest", "high"):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = bench_suite.dist_worker(NV, chains=(1, 3), precision=precision,
                                         log=lambda msg: print(f"[24] {msg}", file=sys.stderr))
        rec = json.loads(text.getvalue().strip().splitlines()[-1])
        runs[precision] = rc, rec
        print(f"[24 bench_suite.py --dist-worker {NV}, world size 1, chains of 1 and 3, "
              f"{precision!r}] {json.dumps(rec)}", flush=True)
    (rc, rec), (_, rec_hi) = runs["highest"], runs["high"]
    print(f"[24] circulant2l at {NV}^3: {rec_hi['gmres_iters']} iterations at 'high', "
          f"{rec['gmres_iters']} at 'highest' (fp32), r05 {rec['r05']['gmres_iters']}", flush=True)
    check(rc == 0 and not rec.get("gate_failures"), f"the distributed row at {NV}^3, "
          f"'highest': exit {rc}, {rec.get('gate_failures')}")
    others = [f for f in rec_hi.get("gate_failures", []) if not f.startswith("gmres_iters")]
    check(rec_hi["converged"] and not others, f"the distributed row at {NV}^3, 'high': "
          f"converged {rec_hi['converged']}, {rec_hi.get('gate_failures')}")
    print(f"[24] K1 to K4 launches on the sharded GMRES step: {launched}; phase 24 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(launched["K2"] > 0 and not launched["K1"] and not launched["K3"],
          f"the sharded gridmg step launched {launched}")
    return launched


# phase 26: kernel K5 at the main path's shapes
TOL_K5 = 1e-5  # max|y_K5 − y_plain| / max|y_plain|, one stage
TOL_K5_APPLY = 1e-4  # the same over a whole apply_fm: the stages' rounding carried through


def k5_stage_cost(L, stage: str, zc: bool = False) -> tuple[float, float]:
    """(flops, bytes) of one K5 stage on the level L in float32: m fields on
    N sites, K stencil offsets, Nc sites on the next level. The smoothing
    reads r and Dinv and writes z; the restriction reads r, z, the
    coefficients and cnt_inv and writes the next level's right-hand side; the
    sweep reads r, z, zc (when given), the coefficients and Dinv and writes z'."""
    m, N, Nc = L.b, int(np.prod(L.shape_xyz)), int(np.prod(L.cshape_xyz))
    K = len(L.stencil.offsets)
    a_flops, a_bytes = 2.0 * K * m * m * N, 4.0 * K * m * m * N
    if stage == "smooth":
        return 2.0 * m * m * N, 4.0 * (2 * m * N + m * m * N)
    if stage == "restrict":
        return a_flops + 2.0 * m * N, a_bytes + 4.0 * (2 * m * N + Nc + m * Nc)
    return (a_flops + 2.0 * m * m * N + 4.0 * m * N,
            a_bytes + 4.0 * (3 * m * N + m * m * N + (m * Nc if zc else 0)))


def k5_phase(dev: torch.device, smi: str, mi) -> dict:
    """Phase 26: K5 against its plain versions on the levels below the fine
    one of path D's grid V-cycle (Kershaw NW^3: the 32^3 and 16^3 Galerkin
    levels, m = 4, float32): each stage, and a whole apply_fm against the
    same hierarchy on the V-cycle's generic stages; each stage and the coarse part of an apply
    timed by CUDA-graph replay beside its plain version and its bound.
    Returns K5's entry of the kernels line, less its launches by path."""
    import copy
    import dataclasses

    from circulantpreconditioner_tpu_torch.ops import vcycle_sweep as vs
    from circulantpreconditioner_tpu_torch.solvers import aggregation_pc as ap
    from circulantpreconditioner_tpu_torch.utils.graphs import STATS

    t_phase = time.perf_counter()
    f32 = torch.float32
    pc = ap.GridVCyclePC.from_grid_model(mi.divergence, (NW,) * 3, A0_apply=mi.implicit_matvec(),
                                         A0_apply_fm=mi.implicit_matvec_fm(), shift=1.0,
                                         dtype=f32)
    generic = copy.copy(pc)  # the same levels on the generic stages
    generic.levels = tuple(dataclasses.replace(L, stages=ap._GRID) if L.stages is ap._K5 else L
                           for L in pc.levels)
    coarse = [l for l, L in enumerate(pc.levels) if L.stages is ap._K5]
    check(coarse == [1, 2], f"K5: path D's hierarchy fuses levels {coarse}, not [1, 2]")
    rng = np.random.default_rng(26)

    def rand(n):
        return torch.as_tensor(rng.standard_normal(n), dtype=f32, device=dev)

    def err(got, want):
        d = (got - want).abs().max().item()
        return d, d / want.abs().max().item()

    omega, worst, worst_abs, stages, errs = pc.omega, 0.0, 0.0, {}, []
    for l in coarse:
        L = pc.levels[l]
        label = "x".join(map(str, L.shape_xyz))
        N, Nc = int(np.prod(L.shape_xyz)), int(np.prod(L.cshape_xyz))
        r, z, zc = rand(L.b * N), rand(L.b * N), rand(L.b * Nc)
        # (K5, plain) pairs: the V(1,1) visit's three (timed), then the
        # pre-smoothing sweep (checked only)
        pairs = {
            "smooth": (lambda: vs.smooth_cuda(L.Dinv, r, omega),
                       lambda: ap._grid_smooth_fm(L, omega, r)),
            "restrict": (lambda: vs.restrict_cuda(L.stencil, L.cnt_inv, L.cshape_xyz, r, z),
                         lambda: ap._GRID.restrict(L, r, z)),
            "sweep": (lambda: vs.sweep_cuda(L.stencil, L.Dinv, L.cshape_xyz, omega, r, z, zc),
                      lambda: ap._sweep_plain(L, omega, r, z, zc)),
            "sweep, no prolongation": (
                lambda: vs.sweep_cuda(L.stencil, L.Dinv, L.cshape_xyz, omega, r, z),
                lambda: ap._sweep_plain(L, omega, r, z)),
        }
        for name, (k5, plain) in pairs.items():
            d_abs, d_rel = err(k5(), plain())
            errs.append(f"{name} {label} {d_rel:.2e}")
            worst, worst_abs = max(worst, d_rel), max(worst_abs, d_abs)
            check(d_rel <= TOL_K5, f"K5 {name} at {label} is off its plain version: {d_rel:.3e}")
            if "," in name:
                continue
            flops, nbytes = k5_stage_cost(L, name, zc=True)
            b_ms, b_by = bound(flops, nbytes)
            stages[f"{name} {label}"] = {"ms": graph_ms(k5), "plain_ms": graph_ms(plain),
                                         "bound_ms": b_ms, "bound_by": b_by,
                                         "mbytes": nbytes / 1e6, "max_rel_err": d_rel}
    print(f"[26 K5] against its plain versions at Kershaw {NW}^3's levels, max|y_K5 - y_plain|"
          f"/max|y_plain| (tol {TOL_K5:g}): " + "; ".join(errs), flush=True)

    # a whole apply_fm: three K5 launches on each fused level
    g = rand(4 * NW**3)
    STATS.reset()
    before = vs.VCycleSweepKernel.launches
    y = pc.apply_fm(g)
    torch.cuda.synchronize()
    launched = vs.VCycleSweepKernel.launches - before
    visits = (STATS.vcycle_levels_fused, STATS.vcycle_levels_plain)
    d_abs, d_apply = err(y, generic.apply_fm(g))
    print(f"[26 K5] apply_fm at Kershaw {NW}^3: {launched} K5 launches, level visits (fused, "
          f"plain) {visits}; against the generic stages max|dy|/max|y| {d_apply:.3e} (tol "
          f"{TOL_K5_APPLY:g})", flush=True)
    check(launched == 3 * len(coarse) and visits == (len(coarse), 0),
          f"K5: apply_fm launched {launched}, level visits {visits}")
    check(d_apply <= TOL_K5_APPLY, f"K5: apply_fm off the generic stages by {d_apply:.3e}")

    # the coarse part of an apply (the levels below the fine one and the
    # bottom solve), as path D's span port.pc.coarse holds it
    L1 = pc.levels[1]
    rc = rand(L1.b * int(np.prod(L1.shape_xyz)))
    part = {name: (lambda lv=lv: ap._vcycle(lv, pc.bot_inv, pc.n_smooth, omega, 1, rc))
            for name, lv in (("K5", pc.levels), ("plain", generic.levels))}
    nb = pc.bot_inv.shape[0]
    part_flops = 2.0 * nb * nb
    part_bytes = 4.0 * (nb * nb + 2 * nb)
    for l in coarse:
        for name in ("smooth", "restrict", "sweep"):
            flops, nbytes = k5_stage_cost(pc.levels[l], name, zc=True)
            part_flops, part_bytes = part_flops + flops, part_bytes + nbytes
    part_ms = {name: graph_ms(fn) for name, fn in part.items()}
    b_ms, b_by = bound(part_flops, part_bytes)
    print("[26 K5 times] CUDA-graph replay of 20 calls, ms per call: " + "; ".join(
        f"{k} {v['ms']:.5f} (plain {v['plain_ms']:.5f}, bound {v['bound_ms']:.5f}, "
        f"{v['mbytes']:.2f} MB)" for k, v in stages.items())
        + f"; the coarse part of a {NW}^3 apply (6 K5 launches and the {nb}^2 bottom gemv) "
        f"{part_ms['K5']:.4f} ms, its plain stages {part_ms['plain']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {part_bytes / 1e6:.1f} MB, held in the 50 MB L2 when warm); "
        f"phase 26 took {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return {"max_abs_err": worst_abs, "max_rel_err": worst, "apply_max_rel_err": d_apply,
            "ms": part_ms["K5"], "plain_ms": part_ms["plain"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "stages": stages}


# phase 27: kernel K6 at the benchmark cells' shapes
TOL_K6 = {torch.float32: 1e-5, torch.float64: 1e-12}  # max|y_K6 − y_plain| / max|y_plain|
L2_BYTES = 50e6  # the H100's L2


def k6_phase(dev: torch.device, smi: str) -> dict:
    """Phase 27: K6 against its plain versions (the einsums it replaced) at
    the shapes and Dinv layouts of the benchmark's wave cells, b = 4: the
    pre-smoothing ω·Dinv·r and the fused post-sweep zn + ω·Dinv·(r − y), each
    timed by CUDA-graph replay beside its plain version and its bound by
    bytes. "cold": the calls rotate through copies of the inputs that
    overflow the L2, as in a step, where K2, GMRES's basis and the other
    levels evict them between two smoothings; "warm": the same inputs every
    call. Returns K6's entry of the kernels line, less its launches."""
    from circulantpreconditioner_tpu_torch.ops import block_jacobi as bj
    from circulantpreconditioner_tpu_torch.solvers import aggregation_pc as ap
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs

    t_phase = time.perf_counter()
    b, omega = 4, 0.8
    rng = np.random.default_rng(27)
    # (label, sites, cells a site, layout): each cell's Dinv as its call site keeps it
    shapes = [(f"Kershaw {NW}^3 fine level", NW**3, 1, "cell"),
              (f"Kershaw {NW}^3 pbjacobi_fm", NW**3, 1, "field"),
              (f"Kershaw-tet {NJ}^3 site level", NJ**3, 6, "cell"),
              (f"Kershaw-tet {NJ}^3 pbjacobi_fm", NJ**3, 6, "field")]

    def operands(S, g, layout, dtype):
        """(Dinv in `layout`, its plain ω·Dinv·v, ω) on random blocks near I."""
        D = torch.as_tensor(np.eye(b)[None] + 0.3 * rng.standard_normal((g * S, b, b)),
                            device=dev, dtype=dtype)
        if layout == "field":
            pj = pcs.PointBlockJacobiFM(
                (D.permute(1, 2, 0) if g == 1 else D.reshape(S, g, b, b).permute(1, 2, 3, 0))
                .contiguous(), g)
            return pj.DinvT, pj._plain, 1.0
        if g == 1:
            L = ap._GridLevel(Dinv=D, cnt_inv=None, shape_xyz=(S, 1, 1),
                              cshape_xyz=(-(-S // 2), 1, 1), b=b)
            return D, lambda v: ap._grid_smooth_fm(L, omega, v), omega
        L = ap._Level(A=None, Dinv=D, cnt_inv=None, n=g * S, b=b, factor=g, n_agg=S)
        return D, lambda v: ap._smooth_fm(L, omega, v), omega

    def vec(n, dtype):
        return torch.as_tensor(rng.standard_normal(n), device=dev, dtype=dtype)

    forms, errs, worst, worst_abs = {}, [], 0.0, 0.0
    for label, S, g, layout in shapes:
        n = g * b * S
        for dtype in ((torch.float32, torch.float64) if g == 1 and layout == "cell"
                      else (torch.float32,)):
            Dinv, plain, w = operands(S, g, layout, dtype)
            r, zn, y = vec(n, dtype), vec(n, dtype), vec(n, dtype)
            for form, args, want in (("pre", (r, None, None), lambda: plain(r)),
                                     ("post", (r, zn, y), lambda: zn + plain(r - y))):
                got, ref = bj.apply_cuda(Dinv, layout, g, w, *args), want()
                d = (got - ref).abs().max().item()
                d_rel = d / ref.abs().max().item()
                errs.append(f"{label} {form} {str(dtype)[6:]} {d_rel:.2e}")
                check(d_rel <= TOL_K6[dtype], f"K6 at {label} ({form}, {dtype}) is off its "
                      f"plain version: {d_rel:.3e}")
                if dtype == torch.float32:
                    worst, worst_abs = max(worst, d_rel), max(worst_abs, d)
            del Dinv, plain, r, zn, y
        # times in float32, each call on the next of `copies` input sets
        for form, n_vec in (("pre", 2), ("post", 4)):
            nbytes = 4.0 * (b * b + n_vec * b) * g * S
            copies = max(2, int(np.ceil(2 * L2_BYTES / nbytes)))
            sets = [operands(S, g, layout, torch.float32)
                    + tuple(vec(n, torch.float32) for _ in range(3)) for _ in range(copies)]
            if form == "pre":
                k6 = lambda D, p, w, r, zn, y: bj.apply_cuda(D, layout, g, w, r)  # noqa: E731
                pl = lambda D, p, w, r, zn, y: p(r)  # noqa: E731
            else:
                k6 = lambda D, p, w, r, zn, y: bj.apply_cuda(D, layout, g, w, r, zn, y)  # noqa: E731
                pl = lambda D, p, w, r, zn, y: zn + p(r - y)  # noqa: E731

            def rotated(fn, sets=sets, turn=[0]):
                def call():
                    turn[0] += 1
                    return fn(*sets[turn[0] % len(sets)])
                return call

            b_ms, b_by = bound(2.0 * b * b * g * S, nbytes)
            ms = graph_ms(rotated(k6))
            forms[f"{label} {form}"] = {
                "ms": ms, "warm_ms": graph_ms(lambda: k6(*sets[0])),
                "plain_ms": graph_ms(rotated(pl)), "bound_ms": b_ms, "bound_by": b_by,
                "mbytes": nbytes / 1e6, "over_bound": ms / b_ms, "copies": copies}
            del sets
    print(f"[27 K6] against its plain versions, max|y_K6 - y_plain|/max|y_plain| (tol "
          f"{TOL_K6[torch.float32]:g} float32, {TOL_K6[torch.float64]:g} float64): "
          + "; ".join(errs), flush=True)
    print("[27 K6 times] CUDA-graph replay of 20 calls, ms per call, inputs rotated past the L2 "
          "(warm: the same inputs): " + "; ".join(
              f"{k} {v['ms']:.5f} ({v['over_bound']:.2f}x bound {v['bound_ms']:.5f}, "
              f"{v['mbytes']:.2f} MB; warm {v['warm_ms']:.5f}; plain {v['plain_ms']:.5f})"
              for k, v in forms.items())
          + f"; phase 27 took {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    main_form = forms[f"Kershaw {NW}^3 fine level post"]
    return {"max_abs_err": worst_abs, "max_rel_err": worst, "ms": main_form["ms"],
            "plain_ms": main_form["plain_ms"], "bound_ms": main_form["bound_ms"],
            "bound_by": main_form["bound_by"], "library_ms": main_form["plain_ms"],
            "forms": forms}


# phase 28: kernel K7 at the benchmark cell's shape
TOL_K7 = {torch.float32: 1e-5, torch.float64: 1e-12}  # max|y_K7 − y_plain| / max|y_plain|


def k7_phase(dev: torch.device, smi: str) -> dict:
    """Phase 28: K7 against its plain version (SupercellNormalOperator.
    plain_fm, run on the card) in float32 and float64 at Kershaw-tet 12³ and
    in float32 at NJ³, the benchmark cell's; each also against the
    block-sparse SupercellStencilOperator, the apply K7 replaced, and K7's
    cell-major apply against the assembled BSR matvec. Then K7 timed at NJ³
    by CUDA-graph replay beside the plain version, the block-sparse stencil
    and its least bytes (the bound of portbench's supercell_spmv_roofline:
    per tet the 4x4 diagonal block, x and y, per interior face side s and
    n̂). "cold": the calls rotate through copies of the tables and x that
    overflow the L2, as in a step; "warm": the same inputs every call.
    Returns K7's entry of the kernels line, less its launches."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_tet_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.ops import supercell_stencil as k7
    from circulantpreconditioner_tpu_torch.ops.stencil import (
        SupercellNormalOperator,
        SupercellStencilOperator,
    )

    t_phase = time.perf_counter()
    rng = np.random.default_rng(28)
    errs, worst, worst_abs, built = [], 0.0, 0.0, {}
    for n, dtype in ((12, torch.float32), (12, torch.float64), (NJ, torch.float32)):
        model = WaveSystem(kershaw_tet_mesh(((0.0, 1.0),) * 3, (n,) * 3), cfl=1e3 / 3,
                           device=dev, dtype=dtype)
        D = model.divergence
        t0 = time.perf_counter()
        S = model.supercell_operator
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        check(isinstance(S, SupercellNormalOperator), f"no supercell normal form at {n}^3")
        B = SupercellStencilOperator.from_bsr(D, model.mesh.topology_shape, 6)
        x = torch.as_tensor(rng.standard_normal(D.shape[0]), device=dev, dtype=dtype)
        g = model.pack_fm(x)
        y7, yp, yb = k7.supercell_stencil_cuda(S, g), S.plain_fm(g), B.matvec_fm(g)
        scale = yp.abs().max().item()
        d = (y7 - yp).abs().max().item()
        d_b = (y7 - yb).abs().max().item() / scale
        y_bsr = D.matvec(x)
        d_cm = (S.matvec(x) - y_bsr).abs().max().item() / y_bsr.abs().max().item()
        tol = TOL_K7[dtype]
        errs.append(f"{n}^3 {str(dtype)[6:]}: plain {d / scale:.2e}, block-sparse {d_b:.2e}, "
                    f"cell-major vs BSR {d_cm:.2e}")
        check(d / scale <= tol and d_b <= tol and d_cm <= max(tol, TOL_KERNEL),
              f"K7 at {n}^3 ({dtype}) is off: plain {d / scale:.3e}, block-sparse {d_b:.3e}, "
              f"BSR {d_cm:.3e}")
        if dtype == torch.float32:
            worst, worst_abs = max(worst, d / scale), max(worst_abs, d)
        if n == NJ:
            built = dict(model=model, S=S, B=B, g=g, t_build=t_build)
        del model, D, S, B, x, g, y7, yp, yb, y_bsr
    print(f"[28 K7] against its plain version and the block-sparse stencil, max|dy|/max|y| "
          f"(tol {TOL_K7[torch.float32]:g} float32, {TOL_K7[torch.float64]:g} float64): "
          + "; ".join(errs), flush=True)

    S, B, g0 = built["S"], built["B"], built["g"]
    diag, s, nvec = S.arrays
    M, N, m = S.M, S.N, S.m
    cells, sides = S.g * N, int((s != 0).sum().item())
    least = 4.0 * (cells * (m * m + 2 * m) + sides * m)  # supercell_spmv_roofline's bytes
    stream = 4.0 * (cells * (m * m + 2 * m + S.F * m))  # what K7 reads and writes
    table_mb = sum(a.numel() * a.element_size() for a in S.arrays) / 1e6
    sparse_mb = sum(C.numel() * C.element_size() for C in B.coefs) / 1e6
    copies = max(2, int(np.ceil(2 * L2_BYTES / stream)))
    ops = [S] + [SupercellNormalOperator(S.shape_zyx, S.m, S.g, S.c0, S.slot_offset, S.slot_col,
                                         tuple(a.clone() for a in S.arrays))
                 for _ in range(copies - 1)]
    xs = [g0] + [torch.randn_like(g0) for _ in range(copies - 1)]

    def rotated(fn, turn=[0]):
        def call():
            turn[0] += 1
            return fn(ops[turn[0] % copies], xs[turn[0] % copies])
        return call

    b_ms, b_by = bound(cells * (2.0 * m * m + S.F * (4 * (m - 1) + 8)), least)
    ms = graph_ms(rotated(k7.supercell_stencil_cuda))
    times = {"K7": ms, "K7 warm": graph_ms(lambda: k7.supercell_stencil_cuda(S, g0)),
             "plain": graph_ms(rotated(lambda op, x: op.plain_fm(x)), calls=10, repeats=5),
             "block-sparse": graph_ms(lambda: B.matvec_fm(g0), calls=10, repeats=5)}
    print(f"[28 K7 times] Kershaw-tet {NJ}^3, float32, CUDA-graph replay, ms per apply: "
          + "; ".join(f"{k} {v:.5f}" for k, v in times.items())
          + f"; bound {b_ms:.5f} ({b_by}: {least / 1e6:.2f} MB least, K7 streams "
          f"{stream / 1e6:.2f} MB), K7 at {100 * b_ms / ms:.1f} % of it ({copies} input sets "
          f"rotated); tables {table_mb:.1f} MB against the block-sparse {sparse_mb:.1f} MB; host "
          f"build of the normal form "
          f"{built['t_build']:.2f} s; phase 28 took {time.perf_counter() - t_phase:.1f} s; "
          f"{smi}", flush=True)
    return {"max_abs_err": worst_abs, "max_rel_err": worst, "ms": ms,
            "warm_ms": times["K7 warm"], "plain_ms": times["plain"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": times["block-sparse"], "table_mb": table_mb}


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
        PASSES,
        PLANE_PASSES,
        FusedCirculantSolver,
        fused_circulant_reference,
        fused_circulant_solve_cuda,
        k1_launch,
        k1_scratch,
    )
    from circulantpreconditioner_tpu_torch.ops.spectral_collapse import (
        DenseCirculantSolver,
        make_circulant_solver,
    )
    from circulantpreconditioner_tpu_torch.solvers import make_gmres

    dev = torch.device("cuda")
    f32 = dict(device=dev, dtype=torch.float32)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[1 device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    lib_path, build_s = build.build(force=True)
    build.load_library()
    print(f"[2 build] K1 to K7 built from csrc/ in {build_s:.2f} s", flush=True)
    ptxas = lib_path.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(ptxas):  # K1's and K3's register and shared-memory report
        if "Compiling entry function" in line and ("k3_cmm" in line or "k1_" in line):
            print("[2 build] " + " | ".join(x.strip() for x in ptxas[i:i + 4]), flush=True)
    mma = tensor_core_instructions(lib_path, build.nvcc_path(), "k3_cmm_tf32x3")
    print(f"[2 build] K3 float32 kernels, tensor-core instructions (HMMA, HGMMA) in their SASS "
          f"(cuobjdump -sass): {mma}", flush=True)
    check(len(mma) > 0 and min(mma.values()) > 0, f"K3's float32 kernels have no tensor-core "
          f"instruction: {mma}")

    lap("1 and 2")
    # --- 3: K1 against its plain version ---------------------------------
    rng = np.random.default_rng(1)
    h64 = 1.0 / 64
    dt64 = (1e3 / 3) * (h64 / 6) / np.linalg.norm([1.0, 0.5, 0.25])
    # (1,5,8): λ_z = 0, since on an axis of one point the transport spectrum
    # is 1 (ops/circulant.py, as in the JAX package) while matvec's roll is
    # the identity, so ‖Cx − b‖ would not measure the solve there
    configs = [
        ("6x5x8", (6, 5, 8), (0.3, 0.2, 0.9)),
        ("100^3 flagship", (N, N, N), flagship_lambdas()),
        ("64^3 a=(1,0.5,0.25)", (64, 64, 64), tuple(a * dt64 / h64 for a in (0.25, 0.5, 1.0))),
        ("7x11x13", (7, 11, 13), (0.3, 0.2, 0.9)),
        ("101x100x100", (101, N, N), flagship_lambdas()),
        ("400x16x16", (400, 16, 16), (1.0, 0.5, 0.25)),
        ("1x5x8", (1, 5, 8), (0.0, 0.2, 0.9)),
        ("4x200x300 (unfused: a plane beyond shared memory)", (4, 200, 300), (0.3, 0.2, 0.9)),
        ("2x3x9000 (rows beyond shared memory)", (2, 3, 9000), (0.5, 0.5, 0.5)),
    ]
    max_abs_err = 0.0
    for name, shape, lams in configs:
        solver = FusedCirculantSolver.create(shape, lams, precision="high", **f32)
        op = CirculantTransportOperator.create(shape, lams, **f32)
        b = torch.as_tensor((rng.random(shape) * 50 + 600).astype(np.float32), device=dev)
        x_k = fused_circulant_solve_cuda(b, solver.plan, "high")
        torch.cuda.synchronize()
        if max(shape) > 5000:
            plain = "float64 plain"
            s64 = FusedCirculantSolver.create(shape, lams, device=dev, dtype=torch.float64)
            x_p = fused_circulant_reference(b.double(), s64.arrays, "high")
        else:
            plain = "plain"
            x_p = fused_circulant_reference(b, solver.arrays, "high")
        err = (x_k - x_p).abs().max().item()
        rel = err / x_p.abs().max().item()
        res = rel_residual(op, x_k, b)
        max_abs_err = max(max_abs_err, err)
        print(f"[3 K1 vs {plain}] {name}: max|dx|/max|x| {rel:.3e} (tol {TOL_KERNEL:g}), "
              f"||Cx-b||/||b|| {res:.3e} (tol {TOL_RESIDUAL:g})", flush=True)
        check(rel <= TOL_KERNEL, f"K1 disagrees with its {plain} version at {name}: {rel:.3e}")
        check(res < TOL_RESIDUAL, f"K1 residual {res:.3e} at {name}")
    for name, shape, lams in configs[1:2] + configs[3:4]:
        solver = FusedCirculantSolver.create(shape, lams, precision="high", **f32)
        b = torch.as_tensor((rng.random(shape) * 50 + 600).astype(np.float32), device=dev)
        rels = k1_pass_errors(b, solver.plan)
        print(f"[3 K1 passes vs k1_passes_reference] {name}: "
              + ", ".join(f"{p} {r:.3e}" for p, r in zip(PASSES, rels))
              + f" (tol {TOL_KERNEL:g})", flush=True)
        check(max(rels) <= TOL_KERNEL, f"a K1 pass disagrees with its plain executor at {name}")

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
        # the driver's step, one graph replay per step and one per chunk of
        # 10 (the JAX package's jit(lax.scan)), against capture off
        model_a = TransportEquation(cartesian_mesh(((-0.5, 0.5),) * 3, (N,) * 3, periodic=True),
                                    (1.0, 0.0, 0.0), cfl=1e3 / 3, **f32)
        for chunk in (None, 10):
            captured_against_eager(f"A transport_fft {N}^3", model_a.fft_stepper,
                                   model_a.initial_state(), model_a.dt, smi, chunk=chunk)

        # --- 5: main path B ---------------------------------------------------
        mesh = cartesian_mesh(((-0.5, 0.5),) * 3, (N, N, N), periodic=True)
        model = TransportEquation(mesh, (1.0, 0.0, 0.0), cfl=1e3 / 3, **f32)
        op = model.fft_operator
        M = make_circulant_solver(op.shape_zyx, op.lambdas_zyx, precision="high",
                                  elide_zero_axes=False, fused=True, **f32)
        check(isinstance(M, FusedCirculantSolver), "fused=True did not give the K1 solver")
        step = model.implicit_stepper(M=M.as_preconditioner(), side="right")
        u0 = model.initial_state()
        t0 = time.perf_counter()
        # warm-up (allocator, cuBLAS handles) and the capture of the solve's
        # graphs; not part of the run
        _, snap = solve_run(lambda: step(u0))
        first_b = dict(first_ms=(time.perf_counter() - t0) * 1e3,
                       capture_s=snap["capture_seconds"], captures=snap["captures"])
        FusedCirculantSolver.launches = 0
        res_b, snap = solve_run(lambda: run_time_loop(step, u0, model.dt, tmax=1e9, ntmax=3,
                                                      log=None))
        launches = FusedCirculantSolver.launches
        masked_k1 = snap["masked_launches"][0]
        its = [d["extras"][0] for d in res_b.diagnostics]
        conv = [d["extras"][2] for d in res_b.diagnostics]
        print(f"[5 main path B] GMRES + K1 preconditioner, periodic 100^3: iterations {its}, "
              f"converged {conv}, ms/step {[round(s * 1e3, 3) for s in res_b.step_seconds]}, "
              f"K1 launches {launches} ({snap['masked_launches'][0]} of them by "
              f"{snap['masked']} masked iterations)", flush=True)
        check(launches > 0, "main path B never launched K1")
        expected = k1_expected_launches(its, snap["masked"], snap["true_restarts"])
        check(launches == expected, f"main path B: {launches} K1 launches, expected "
              f"{expected} from the iterations {its}, {snap['masked']} masked and "
              f"{snap['true_restarts']} cycles that the true residual forced")
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
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(u0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        prof_b = device_profile(lambda: step(u0), calls=5)
        busy_b, wall_b = sum(prof_b.values()), float(np.median(walls))
        k1_b = sum(v for k, v in prof_b.items() if "k1_" in k)
        print(f"[5 main path B] one step in a tight loop: wall {wall_b:.3f} ms (median of 10), "
              f"device {busy_b:.3f} ms/step (profiled over 5 steps), K1 {k1_b:.4f} ms/step, busy "
              f"{100 * busy_b / wall_b:.1f} %; largest: " + "; ".join(
                  f"{k[:40]} {v:.4f} ms x{prof_b.counts[k] / 5:g}" for k, v in
                  sorted(prof_b.items(), key=lambda kv: -kv[1])[:6]) + f"; {smi}", flush=True)
        record_loop("B", snap, its=its, warm_ms=wall_b, device_ms=busy_b,
                    busy=100 * busy_b / wall_b)
        record_loop("B", **first_b)
        # the same solve with the host reading each iteration's flags before it
        # queues the next (lookahead 0: no masked iteration, one idle gap each)
        s0 = make_gmres(model.implicit_matvec(), M.as_preconditioner(), side="right")
        s0._lookahead = 0
        l0 = warm_profile(lambda u: s0(u, u), u0, reps=5)
        record_loop("B", lookahead0=l0)
        print(f"[5 main path B] the same solve at lookahead 0: wall {l0['warm_ms']:.3f} ms, "
              f"device {l0['device_ms']:.3f} ms, busy {l0['busy']:.1f} % (lookahead 1, the "
              f"default: {wall_b:.3f}, {busy_b:.3f}, {100 * busy_b / wall_b:.1f} %)", flush=True)
        # the same 2 steps by the uncaptured loop: the same iterations, the
        # same states
        u_c, its_c = u0, []
        for _ in range(2):
            u_c, _, it_c, _, _ = step(u_c)
            its_c.append(it_c)
        u_e, its_e = uncaptured_steps(
            lambda: make_gmres(model.implicit_matvec(), M.as_preconditioner(), side="right"), u0)
        rel = ((u_c - u_e).abs().max() / u_e.abs().max()).item()
        print(f"[5 main path B] 2 steps captured against uncaptured: iterations "
              f"{its_c} and {its_e}, max|du|/max|u| {rel:.3e} (tol 1e-6)", flush=True)
        check(its_c == its_e and rel <= 1e-6, f"path B captured {its_c} against uncaptured "
              f"{its_e}, states {rel:.3e} apart")

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
        "K1 (fused CUDA)": lambda: fused_circulant_solve_cuda(b, fused.plan, "high"),
        "K1 plain (torch.matmul)": lambda: fused_circulant_reference(b, fused.arrays, "high"),
        "DenseCirculantSolver": lambda: dense.solve(b),
        "MatmulCirculantSolver": lambda: staged.solve(b),
        "cuFFT CirculantTransportOperator": lambda: op.solve(b),
    }
    residuals = {name: rel_residual(op, fn(), b) for name, fn in runs.items()}
    ms = median_ms(runs)
    k1_graph = {name: graph_ms(runs[name]) for name in (
        "K1 (fused CUDA)", "K1 plain (torch.matmul)", "cuFFT CirculantTransportOperator")}
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
    print("[6 times] by CUDA-graph replay of 20 solves (no launch gaps): "
          + "; ".join(f"{n} {v:.4f} ms/solve" for n, v in k1_graph.items())
          + f" (cuFFT: rfftn, × 1/Λ, irfftn, three calls); {smi}", flush=True)
    out, scratch = torch.empty_like(b), k1_scratch(b, fused.plan)
    k1_launch(b, fused.plan, out, scratch)
    masks = {name: 1 << i for i, name in enumerate(PASSES)} | PLANE_PASSES
    pass_ms = {name: graph_ms(lambda m=m: k1_launch(b, fused.plan, out, scratch, m))
               for name, m in masks.items()}
    pass_ms["the solve as five unfused passes"] = graph_ms(
        lambda: [k1_launch(b, fused.plan, out, scratch, 1 << i) for i in range(len(PASSES))])
    print("[6 times] K1 by pass, CUDA-graph replay of 20 launches: "
          + "; ".join(f"{n} {v * 1e3:.2f} us" for n, v in pass_ms.items())
          + f"; the solve runs the two plane passes and z; {smi}", flush=True)

    # K1's least time for its function, x = C⁻¹b: b in, 1/Λ (re, im) in and
    # x out over the memory rate, or the FFT form's operations (a real 3D
    # FFT each way at 2.5·n·log2(n) flops, one complex product per mode) over
    # the fp32 peak; beside it, the bound of K1's own algorithm as it runs at
    # 100^3, the plane form (nz ≥ 64 and a plane fits): the bytes of its three
    # launches (b and x once, the half spectrum out of the first, in and out
    # of z, into the last, 1/Λ in z) against the flops of its plan's stages;
    # and the five-pass form's, whose spectrum crosses device memory 8 times
    nxr = N // 2 + 1
    spec = N * N * nxr
    k1_bytes = 4.0 * (2 * N**3 + 2 * spec)
    k1_fft_flops = 2 * 2.5 * N**3 * np.log2(N**3) + 6.0 * spec
    k1_bound, k1_by = bound(k1_fft_flops, k1_bytes)
    k1_alg, k1_alg_by = bound(k1_flops(fused.plan, True), 4.0 * 2 * N**3 + 8.0 * 5 * spec)
    five_ms, _ = bound(k1_flops(fused.plan, False), 4.0 * 2 * N**3 + 8.0 * 9 * spec)
    print(f"[6 times] K1 bound at 100^3: {k1_bound:.4f} ms ({k1_by}: {k1_bytes / 1e6:.2f} MB; "
          f"the FFT form's {k1_fft_flops / 1e9:.3f} GFLOP); K1's plane form "
          f"{k1_alg:.4f} ms ({k1_alg_by}: {(8 * N**3 + 40 * spec) / 1e6:.2f} MB, its plan's "
          f"{k1_flops(fused.plan, True) / 1e9:.3f} GFLOP); the five-pass form {five_ms:.4f} ms "
          f"({(8 * N**3 + 72 * spec) / 1e6:.2f} MB, {k1_flops(fused.plan, False) / 1e9:.3f} "
          f"GFLOP); the library yardstick is the cuFFT solve above, three calls", flush=True)

    lap("3 to 6")
    k2, mesh64, mi, path_d = wave_phases(dev, smi)
    lap("7 to 10")
    k3 = fft_pc_phases(dev, smi, mesh64, mi)
    k2["launches_by_path"].update(k3.pop("k2_launches_by_path"))
    lap("11 to 14")
    slice6_phases(dev, smi)
    lap("15 to 17")
    j_launches = path_j_phases(dev, smi)
    lap("18")
    k2["launches_by_path"].update(mesh_file_phases(dev, smi, mesh64, path_d))
    lap("19")
    d_launches, v_launches = distributed_phases(
        dev, smi, mesh64, path_d["state_c"], inside=lambda dm: sharded_vcycle_phase(dev, smi, dm))
    lap("20 and 24")
    device_loop_phase(smi)
    captured_steps_phase(smi)
    lap("21 and 22")
    b_launches = bench_phase(smi)
    lap("23")
    k4 = precision_tier_phase(dev, smi)
    lap("25")
    k5 = k5_phase(dev, smi, mi)
    lap("26")
    k6 = k6_phase(dev, smi)
    lap("27")
    k7 = k7_phase(dev, smi)
    lap("28")
    j_path = f"J Kershaw-tet {NJ}^3 and the tet drivers"
    d_path = "20 the sharded drivers (parallel/)"
    b_path = "23 bench.py flagship and bench_suite.py rows at 16^3"
    v_path = f"24 sharded grid V-cycle GMRES step (parallel/vcycle_dist.py), Kershaw {NV}^3"
    k4_path = "B GMRES + dense collapse at 'high' 100^3, 3 steps"

    print(json.dumps({"kernels": [{
        "name": "fused_circulant_solve (K1)",
        "route": "cuda",
        "source": "circulantpreconditioner_tpu_torch/csrc/fused_circulant.cu",
        "replaces": "circulantpreconditioner_tpu/ops/fused_circulant.py:117",
        "launches": launches,
        "masked_launches": masked_k1,
        "launches_by_path": {"B GMRES + K1 preconditioner 100^3, 3 steps": launches,
                             j_path: j_launches["K1"], d_path: d_launches["K1"],
                             b_path: b_launches["K1"], v_path: v_launches["K1"]},
        "max_abs_err": max_abs_err,
        "ms": k1_graph["K1 (fused CUDA)"],
        "plain_ms": k1_graph["K1 plain (torch.matmul)"],
        "events_ms": ms["K1 (fused CUDA)"],
        "pass_ms": pass_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "algorithm_bound_ms": k1_alg,
        "library_ms": k1_graph["cuFFT CirculantTransportOperator"],
    }, {
        "name": "plane_stencil_matvec (K2)",
        "route": "cuda",
        "source": "circulantpreconditioner_tpu_torch/csrc/plane_stencil.cu",
        "replaces": "circulantpreconditioner_tpu/ops/pallas_stencil.py:69",
        **k2, "launches_by_path": {**k2["launches_by_path"], j_path: j_launches["K2"],
                                   d_path: d_launches["K2"], b_path: b_launches["K2"],
                                   v_path: v_launches["K2"]},
    }, {
        "name": "complex_matmul (K3)",
        "route": "cuda",
        "source": "circulantpreconditioner_tpu_torch/csrc/complex_matmul.cu",
        "replaces": "circulantpreconditioner_tpu/ops/pallas_kernels.py:33",
        **k3, "launches_by_path": {**k3["launches_by_path"], j_path: j_launches["K3"],
                                   d_path: d_launches["K3"], b_path: b_launches["K3"],
                                   v_path: v_launches["K3"]},
    }, {
        "name": "tier_matmul (K4)",
        "route": "cuda",
        "source": "circulantpreconditioner_tpu_torch/csrc/tier_matmul.cu",
        "replaces": "circulantpreconditioner_tpu/ops/fused_circulant.py:80",
        **k4, "launches_by_path": {k4_path: k4["launches"], j_path: j_launches["K4"],
                                   d_path: d_launches["K4"], b_path: b_launches["K4"],
                                   v_path: v_launches["K4"]},
    }, {
        "name": "vcycle_sweep (K5)",
        "route": "cuda",
        "source": "circulantpreconditioner_tpu_torch/csrc/vcycle_sweep.cu",
        "replaces": "none: XLA fuses circulantpreconditioner_tpu/solvers/aggregation_pc.py "
                    "_vcycle",
        "launches": path_d["k5"],
        **k5, "launches_by_path": {f"D wave_implicit gridmg {NW}^3": path_d["k5"],
                                   j_path: j_launches["K5"], d_path: d_launches["K5"],
                                   b_path: b_launches["K5"], v_path: v_launches["K5"]},
    }, {
        "name": "block_jacobi (K6)",
        "route": "cuda",
        "source": "circulantpreconditioner_tpu_torch/csrc/block_jacobi.cu",
        "replaces": "none: XLA runs the JAX package's block-Jacobi einsums "
                    "(circulantpreconditioner_tpu/solvers/aggregation_pc.py _grid_smooth_fm, "
                    "_smooth_fm; solvers/preconditioners.py pbjacobi_fm)",
        "launches": path_d["k6"],
        **k6, "launches_by_path": {f"D wave_implicit gridmg {NW}^3": path_d["k6"],
                                   j_path: j_launches["K6"], d_path: d_launches["K6"],
                                   b_path: b_launches["K6"], v_path: v_launches["K6"]},
    }, {
        "name": "supercell_stencil (K7)",
        "route": "cuda",
        "source": "circulantpreconditioner_tpu_torch/csrc/supercell_stencil.cu",
        "replaces": "none: XLA runs the JAX package's block-sparse supercell stencil "
                    "(circulantpreconditioner_tpu/ops/stencil.py SupercellStencilOperator)",
        "launches": j_launches["K7"],
        **k7, "launches_by_path": {j_path: j_launches["K7"], d_path: d_launches["K7"],
                                   b_path: b_launches["K7"], v_path: v_launches["K7"]},
    }]}))
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all", flush=True)
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
