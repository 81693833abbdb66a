"""The port's benchmark suite: the counterpart of the repository's
`bench_suite.py` (the JAX package's), its 14 single-device rows on one
NVIDIA GPU and its two distributed rows on P GPUs of one host.

    python -m circulantpreconditioner_tpu_torch.bench_suite [out.json] [row1,row2,...]
        [--scipy-baselines] [--dist-ranks 1,4]

Prints one JSON line per row. With `out.json` it writes the rows there under
a header (date, device, methodology); with a subset of rows the results
merge into an existing file by metric name, and a row that fails drops that
row's older records (as the JAX suite does). Each row keeps the JAX row's
metric name, unit, problem, preconditioner, tolerances, restart and side,
and drives the port's own entry points (models, steppers, preconditioners,
GMRES and CG) at the row's full size in float32 on the card:

| row | metric | problem, route |
| --- | --- | --- |
| circulant | circulant_pc_applies_per_s_100cubed | bench.py's flagship, shared |
| transport_implicit | transport_implicit_step_ms_100cubed | GMRES + circulant PC (right, restart 8); PCNONE (left) |
| wave_explicit | wave_explicit_step_us_kershaw64 | explicit_stepper_fm, captured chunks (K2) |
| spmv, spmv64 | spmv_gnnz_per_s_kershaw{32,64} | renormalised chain of divergence_op_fm (K2) |
| spmv_tet | spmv_gnnz_per_s_tet16 | the same on tet_mesh 16³ (supercell normal form, K7) |
| wave_implicit, 32, 64 | wave_implicit_step_ms_kershaw{16,32,64} | field-major GMRES + grid V-cycle (K2); at 16³ also dct2lm, dct2l, circulant2l |
| wave_dct_direct | wave_dct_direct_us_per_step_64cubed | dct_fft_stepper_fm, captured chunks |
| diffusion_implicit | diffusion_implicit_step_ms_64cubed | CG on the wall mesh; the periodic FFT step |
| wave_ilu | wave_ilu0_step_ms_32cubed | GMRES + ILU(0) (left, maxiter 100) |
| pc_iterations | wave_implicit_gmres_iters_by_pc | Kershaw 8³, 16³, 24³ × 7 preconditioners |
| ladder_top | wave_implicit_step_ms_kershawtet50 | Kershaw-tet 50³: supercell SpMV, explicit, GMRES + grid V-cycle |
| scale_distributed, 48 | wave_implicit_dist_kershaw{32,48}_{P}dev | row-sharded GMRES over P ranks: circulant2l; the sharded grid V-cycle (K2) |

The JAX suite's four fixture rows read meshes that are absent: they are not
here. Its two distributed rows ran `_scale_worker` on 8 virtual CPU devices
in a subprocess; here each runs `torchrun --nproc-per-node P -m
circulantpreconditioner_tpu_torch.bench_suite --dist-worker N` (`dist_command`:
one process per card, NCCL) for each P of --dist-ranks (default 1, and 4
where four cards are visible), before the suite makes a CUDA context of its
own. Each rank builds the JAX row's Kershaw N³ problem and solves it twice
(`dist_case`): the JAX row's circulant2l case (HaloELLMatrix,
DistributedBlockCirculantPC + sharded_pbjacobi) and the grid V-cycle on
z-slabs (parallel/vcycle_dist.py, the counterpart of the JAX row's GSPMD
gridmg), K2 on each rank's slab; rank 0 also solves the latter on one card.
Rank 0 prints the record, under the JAX record's keys, with the port's P,
cards and launches beside.

Timing (bench.py, `paired_chain_time`): differenced pairs of chains on the
card, accepted only where two pairs agree within 10 %, failing otherwise and
below a row's bound. The direct steps, SpMVs and explicit steps chain as
CUDA-graph replays timed by CUDA events (a captured step's chunk of steps,
or a graph that holds a block of calls); the Krylov rows chain K re-solves
of the first step (each link feeds U0 plus a vanishing multiple of the last
solution, as the JAX suite's t=0 chains do: the work per link does not
decay), driven by the host and timed by its clock, with the device time per
step from torch.profiler beside (on the distributed rows, every chain begun
after a barrier of all the ranks and timed as its slowest rank's, rank 0's
device time beside). The rows whose solvers take a precision tier run the
JAX rows' "high" (bf16×3 through K4 on the card: transport_implicit's dense
PC, the DCT solves of dct2l, dct2lm and wave_dct_direct, the distributed
circulant2l's slab solve) and say so in `precision`; `launches_per_step`
counts K1 to K7. The SpMV rows and the explicit step carry
`bound_ms`: the bytes of D's coefficients, its input and its output over the
memory rate (the operations of 2 per stored entry are far below it).

Gates: a converged count must lie within ±1 of the JAX suite's TPU run
(results/bench_suite_r05.json), the band path J uses: gridmg 25, 33 and 38,
the alternatives at 16³ (28, 43, 62), tet50 41, transport's first step 3,
diffusion CG 3, and every entry of the preconditioner table; the distributed
rows' circulant2l 99 and 111 (the virtual devices' counts), their sharded
gridmg count within one of the one-card count of the same call, and at P =
1 the same K2 launches per step as one card. A row that
misses a gate or raises is printed with its failure; the suite goes on, and
exits 1 at the end. The SciPy GMRES baselines of the wave rows time the
host's CPU, not the port (91.5 s per step at 64³ and 236 s at tet50 in
r05): they run only with --scipy-baselines. The SpMV rows' SciPy baselines
take seconds and always run.
"""

from __future__ import annotations

import datetime
import functools
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.bench import (
    PRECISION,
    GraphChain,
    bound,
    device_info,
    flagship_record,
    host_chain,
    kernel_counts,
    paired_chain_time,
    per_call,
    require_cuda,
)

B01 = ((0.0, 1.0),) * 3  # the JAX suite's domain
F32 = torch.float32

# The JAX suite's TPU iteration counts (results/bench_suite_r05.json), which
# the converged counts are held to within GATE_BAND: by metric, the record's
# count field, its count and the field that says it converged; the
# preconditioner table by mesh and name.
GATE_BAND = 1
R05_ITERS = {
    "transport_implicit_step_ms_100cubed": {"gmres_iters_first_step": (3, "converged")},
    "wave_implicit_step_ms_kershaw16": {
        "gmres_iters": (25, "converged"), "dct2lm_gmres_iters": (28, "dct2lm_converged"),
        "dct2l_gmres_iters": (43, "dct2l_converged"),
        "circulant2l_gmres_iters": (62, "circulant2l_converged")},
    "wave_implicit_step_ms_kershaw32": {"gmres_iters": (33, "converged")},
    "wave_implicit_step_ms_kershaw64": {"gmres_iters": (38, "converged")},
    "wave_implicit_step_ms_kershawtet50": {"gmres_iters": (41, "converged")},
    "diffusion_implicit_step_ms_64cubed": {"cg_iters": (3, "converged")},
}
R05_PC_TABLE = {
    "kershaw8": {"none": 56, "pbjacobi": 117, "circulant2l": 40, "dct2l": 18, "dct2lm": 10,
                 "gridmg": 2, "aggvcycle": 2},
    "kershaw16": {"none": 144, "pbjacobi": 269, "circulant2l": 62, "dct2l": 43, "dct2lm": 28,
                  "gridmg": 25, "aggvcycle": 78},
    "kershaw24": {"none": 204, "pbjacobi": 420, "circulant2l": 80, "dct2l": 60, "dct2lm": 52,
                  "gridmg": 30, "aggvcycle": 111},
}
PC_NAMES = ("none", "pbjacobi", "circulant2l", "dct2l", "dct2lm", "gridmg", "aggvcycle")

METHODOLOGY = ("paired differenced chains on the card (bench.py paired_chain_time): each pair "
               "a K1 and a K2 chain back to back, (T(K2) - T(K1))/(K2 - K1) per call; the best "
               "pair accepted only when another agrees within 10 %, else more pairs up to 12, "
               "else the row fails; a time below bound_ms fails. Direct steps, SpMVs and "
               "explicit steps: CUDA-graph replays timed by CUDA events; Krylov rows: re-solves "
               "of the first step driven by the host, host clock, device time by torch.profiler")


# --- helpers ----------------------------------------------------------------

def renormalised(D: Callable, v: torch.Tensor) -> torch.Tensor:
    """One link of the SpMV chains: D v scaled back to ‖v‖ (no overflow)."""
    y = D(v)
    return y / torch.clamp(torch.linalg.norm(y), min=1e-30) * torch.linalg.norm(v)


def explicit_link(D: Callable, v: torch.Tensor) -> torch.Tensor:
    return v - D(v)


def t0_link(step: Callable, U0: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A re-solve of the first step: U0 plus a vanishing multiple of the last
    solution (1e-30·‖v‖ rounds to nothing), so each link does the same work."""
    return step(U0 + (1e-30 * torch.linalg.norm(v)) * v)[0]


def tensor_bytes(obj, seen: set | None = None) -> int:
    """Bytes of the distinct tensors an operator or preconditioner holds:
    through tuples, lists, dicts, partials, bound methods and the port's own
    objects (the counterpart of the JAX suite's sum over pytree leaves)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(v, seen) for v in obj)
    if isinstance(obj, dict):
        return sum(tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, functools.partial):
        return tensor_bytes((obj.func, obj.args, obj.keywords), seen)
    if hasattr(obj, "__self__") and hasattr(obj, "__func__"):
        return tensor_bytes(obj.__self__, seen)
    if type(obj).__module__.startswith("circulantpreconditioner_tpu_torch") and hasattr(
            obj, "__dict__"):
        return tensor_bytes(vars(obj), seen)
    return 0


def operator_bytes(model) -> int:
    """Bytes of the field-major D's coefficients: the wave normal form (K2's
    operands) or, on a supercell mesh, the supercell operator's tensors (K7's
    tables, or the block-sparse form's)."""
    if model.cells_per_site == 1:
        return tensor_bytes(model.normal_operator.arrays)
    return tensor_bytes(model.supercell_operator)


def spmv_bound(model, nnz: int) -> tuple[float, str]:
    """D's bound: its coefficients, x and y once; 2 operations per entry."""
    elt = torch.finfo(model.dtype).bits // 8
    return bound(2.0 * nnz, operator_bytes(model) + 2 * elt * model.divergence.shape[0])


def device_ms(fn: Callable, calls: int = 2) -> float:
    """Device ms per call from torch.profiler: kernels and copies (an aten::
    op would count its kernels twice)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if not e.key.startswith("aten::")) / 1e3 / calls


def gate_record(rec: dict) -> dict:
    """Hold rec's converged counts to R05_ITERS (within GATE_BAND), noting
    each r05 count beside the port's; a miss, or a gated solve that did not
    converge, goes into rec["gate_failures"]. A count the record does not
    hold (a preconditioner the run left out) is not gated."""
    for field_, (want, conv) in R05_ITERS.get(rec["metric"], {}).items():
        if field_ not in rec:
            continue
        got = rec[field_]
        rec.setdefault("r05", {})[field_] = want
        if not rec[conv]:
            rec.setdefault("gate_failures", []).append(f"{field_}: not converged")
        elif abs(got - want) > GATE_BAND:
            rec.setdefault("gate_failures", []).append(
                f"{field_} {got}, outside {want} ± {GATE_BAND} (results/bench_suite_r05.json)")
    return rec


@dataclass
class KrylovCase:
    """A Krylov step and its first solve (no timing): `step` maps U to a
    tuple whose first item is U_new (a model's stepper: U_new, ‖U_new − U‖,
    iterations, residual, converged)."""

    step: Callable
    U0: torch.Tensor
    iters: int
    converged: bool
    state: torch.Tensor
    extra: dict = field(default_factory=dict)


def first_step(step: Callable, U0: torch.Tensor, **extra) -> KrylovCase:
    x, _, it, _, conv = step(U0)
    return KrylovCase(step, U0, int(it), bool(conv), x, dict(extra))


@dataclass
class Suite:
    """One run of the suite: the card, the options, the log and the meshes
    shared between rows (a Kershaw mesh of one size serves several)."""

    device: torch.device
    scipy_baselines: bool = False
    log: Callable = print
    meshes: dict = field(default_factory=dict)
    dist_ranks: tuple[int, ...] = (1,)  # the distributed rows' world sizes

    def kershaw(self, n: int):
        from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh

        if n not in self.meshes:
            self.log(f"bench: building kershaw {n}^3 ...")
            self.meshes[n] = kershaw_mesh(B01, (n,) * 3)
        return self.meshes[n]

    def krylov_time(self, case: KrylovCase, K1: int, K2: int, chain=host_chain) -> dict:
        """The paired t=0 chain of a Krylov case, with the K1 to K3 launches
        and the device time per step; `chain(link, x0)` makes the chain
        (dist_host_chain across the ranks of a distributed row)."""
        link = functools.partial(t0_link, case.step, case.U0)
        steps = [0]

        def counted(v):
            steps[0] += 1
            return link(v)

        link(case.U0)  # warm: the solver's graphs exist after the first step
        before = kernel_counts()
        t = paired_chain_time(chain(counted, case.U0), K1, K2, device=self.device)
        launches = per_call(before, steps[0])
        return {"ms": t.per_s * 1e3, "chain": t.as_dict(), "launches_per_step": launches,
                "device_ms_per_step": device_ms(lambda: link(case.U0), calls=2)}

    def graph_time(self, link: Callable, x0: torch.Tensor, K1: int, K2: int, block: int,
                   bound_ms: float | None = None) -> dict:
        """The paired chain of a graph of `block` links, replayed."""
        chain = GraphChain(link, x0, block)
        chain.run(block)  # the warm-up and the capture
        torch.cuda.synchronize()
        before, links = kernel_counts(), chain.links
        t = paired_chain_time(chain, K1, K2, device=self.device, bound_ms=bound_ms)
        return {"ms": t.per_s * 1e3, "chain": t.as_dict(),
                "launches_per_step": per_call(before, chain.links - links)}

    def captured_time(self, step, U0: torch.Tensor, K1: int, K2: int, block: int,
                      bound_ms: float | None = None) -> dict:
        """The paired chain of a captured step (utils/graphs.CapturedStep):
        `block` steps per graph replay, as run_time_loop's chunks run them."""
        steps = [0]

        def chain(K: int) -> float:
            step.start(U0)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(K // block):
                step.advance(block)
            e1.record()
            torch.cuda.synchronize()
            steps[0] += K
            return e0.elapsed_time(e1) / 1e3

        chain(block)  # the warm-up and the capture
        before, done = kernel_counts(), steps[0]
        t = paired_chain_time(chain, K1, K2, device=self.device, bound_ms=bound_ms)
        return {"ms": t.per_s * 1e3, "chain": t.as_dict(),
                "launches_per_step": per_call(before, steps[0] - done)}


# --- the rows: case builders (no timing; the tests run them on the CPU) and
# the rows that time them --------------------------------------------------

def bench_circulant(s: Suite) -> dict:
    rec = flagship_record(device=s.device, log=s.log)
    rec.pop("device")
    rec["staged_full3d_solves_per_s"] = rec["submetrics"]["staged_full3d_solves_per_s"]
    return rec


def transport_implicit_case(n: int, *, device, dtype=F32, steady_steps: int = 50
                            ) -> dict[str, KrylovCase]:
    """Implicit transport on the n³ wall cube, a = (1, 0, 0), cfl 1e3/3: GMRES
    right-preconditioned by the dense circulant solve (restart 8), and PCNONE
    (left, restart 30); each first step, and the count of the step after
    `steady_steps` steps of the time loop."""
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.models import TransportEquation
    from circulantpreconditioner_tpu_torch.ops.spectral_collapse import make_circulant_solver

    mesh = cartesian_mesh(B01, (n,) * 3)
    model = TransportEquation(mesh, velocity=[1.0, 0.0, 0.0], cfl=1e3 / 3, device=device,
                              dtype=dtype)
    op = model.fft_operator
    M = make_circulant_solver(op.shape_zyx, op.lambdas_zyx, device=device, dtype=dtype,
                              precision=PRECISION).as_preconditioner()
    u0 = model.initial_state()
    cases = {}
    for name, M_, side, restart in (("circulant", M, "right", 8), ("pcnone", None, "left", 30)):
        step = model.implicit_stepper(M=M_, rtol=1e-5, atol=1e-5, maxiter=1000, side=side,
                                      restart=restart)
        case = first_step(step, u0)
        v = u0
        for _ in range(steady_steps):
            v = step(v)[0]
        case.extra["iters_steady"] = int(step(v)[2])
        cases[name] = case
    return cases


def bench_transport_implicit(s: Suite, n: int = 100) -> dict:
    s.log(f"bench: transport {n}^3 GMRES + circulant PC and PCNONE ...")
    cases = transport_implicit_case(n, device=s.device)
    pc, no = cases["circulant"], cases["pcnone"]
    t_pc = s.krylov_time(pc, K1=20, K2=120)
    t_no = s.krylov_time(no, K1=2, K2=6)
    return gate_record({
        "metric": f"transport_implicit_step_ms_{n}cubed", "value": t_pc["ms"], "unit": "ms/step",
        "pc": "circulant (dense collapse, right-PC true residual, restart 8)",
        "precision": PRECISION,
        "note": "t=0 solve (fixed iteration count) per step; late-time steps decay to the "
                "*_steady counts",
        "gmres_iters_first_step": pc.iters, "gmres_iters_steady": pc.extra["iters_steady"],
        "converged": pc.converged, "unknowns": n**3,
        "device_ms_per_step": t_pc["device_ms_per_step"],
        "launches_per_step": t_pc["launches_per_step"], "chain": t_pc["chain"],
        "pcnone_ms_per_step": t_no["ms"], "pcnone_gmres_iters_first_step": no.iters,
        "pcnone_gmres_iters_steady": no.extra["iters_steady"], "pcnone_converged": no.converged,
        "pcnone_device_ms_per_step": t_no["device_ms_per_step"], "pcnone_chain": t_no["chain"]})


def wave_explicit_case(n: int, *, device, dtype=F32, mesh=None, steps: int = 0):
    """Kershaw n³ at the explicit driver's cfl 1/3: the model, its
    field-major captured step, the packed initial state and the state after
    `steps` steps."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    model = WaveSystem(mesh or kershaw_mesh(B01, (n,) * 3), cfl=1.0 / 3, device=device,
                       dtype=dtype)
    step = model.explicit_stepper_fm()
    G0 = G = model.pack_fm(model.initial_state())
    for _ in range(steps):
        G = step(G)[0]
    return model, step, G0, G


def bench_wave_explicit(s: Suite, n: int = 64, K1: int = 100, K2: int = 500,
                        block: int = 20) -> dict:
    s.log(f"bench: kershaw {n}^3 explicit ...")
    model, step, G0, _ = wave_explicit_case(n, device=s.device, mesh=s.kershaw(n))
    N = model.divergence.shape[0]
    # one step: D's coefficients and U read, U_new written; D's 2 operations
    # per stored entry and the subtraction
    nnz = model.divergence.to_csr(F32).nnz
    b_ms, b_by = bound(2.0 * nnz + N, operator_bytes(model) + 2 * 4 * N)
    t = s.captured_time(step, G0, K1, K2, block, bound_ms=b_ms)
    step.release()
    return {"metric": f"wave_explicit_step_us_kershaw{n}", "value": t["ms"] * 1e3,
            "unit": "us/step", "unknowns": int(N),
            "operator": "K2 (csrc/plane_stencil.cu), field-major, captured chunks of "
                        f"{block} steps",
            "bound_ms": b_ms, "bound_by": b_by, "launches_per_step": t["launches_per_step"],
            "chain": t["chain"]}


@dataclass
class SpmvCase:
    model: object
    nnz: int
    D: Callable
    x_cm: np.ndarray
    x0: torch.Tensor

    def link(self, v: torch.Tensor) -> torch.Tensor:
        return renormalised(self.D, v)


def spmv_case(n: int, family: str = "kershaw", *, device, dtype=F32, mesh=None) -> SpmvCase:
    """The wave system at cfl 1e3/3 on Kershaw or tet n³: D field-major, the
    stored entries of the assembled D, and the chain's start."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh, tet_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    if mesh is None:
        mesh = (kershaw_mesh if family == "kershaw" else tet_mesh)(B01, (n,) * 3)
    model = WaveSystem(mesh, cfl=1e3 / 3, device=device, dtype=dtype)
    A = model.divergence.to_csr(dtype)
    x_cm = np.random.default_rng(0).random(A.shape[0]).astype(np.float32)
    return SpmvCase(model, A.nnz, model.divergence_op_fm(), x_cm, model.pack_fm(x_cm))


def bench_spmv(s: Suite, n: int = 32, K1: int = 50, K2: int = 250, block: int = 10) -> dict:
    s.log(f"bench: kershaw {n}^3 SpMV ...")
    c = spmv_case(n, device=s.device, mesh=s.kershaw(n))
    b_ms, b_by = spmv_bound(c.model, c.nnz)
    t = s.graph_time(c.link, c.x0, K1, K2, block, bound_ms=b_ms)
    per = t["ms"] / 1e3
    As = c.model.divergence.to_csr(F32).to_scipy()
    xv = c.x_cm
    As @ xv
    t0 = time.perf_counter()
    for _ in range(20):
        yv = As @ xv
        xv = yv / max(np.linalg.norm(yv), 1e-30) * np.linalg.norm(xv)
    base = (time.perf_counter() - t0) / 20
    return {"metric": f"spmv_gnnz_per_s_kershaw{n}", "value": c.nnz / per / 1e9,
            "unit": "Gnnz/s", "vs_baseline": base / per, "nnz": c.nnz,
            "ms_per_apply": t["ms"], "bound_ms": b_ms, "bound_by": b_by,
            "launches_per_step": t["launches_per_step"], "chain": t["chain"],
            "scipy_baseline_ms_per_apply": base * 1e3}


def bench_spmv_tet(s: Suite, n: int = 16, K1: int = 50, K2: int = 250, block: int = 10) -> dict:
    s.log(f"bench: tet {n}^3 SpMV ...")
    c = spmv_case(n, "tet", device=s.device)
    b_ms, b_by = spmv_bound(c.model, c.nnz)
    t = s.graph_time(c.link, c.x0, K1, K2, block, bound_ms=b_ms)
    return {"metric": f"spmv_gnnz_per_s_tet{n}", "value": c.nnz / (t["ms"] / 1e3) / 1e9,
            "unit": "Gnnz/s", "nnz": c.nnz, "ms_per_apply": t["ms"], "bound_ms": b_ms,
            "bound_by": b_by, "launches_per_step": t["launches_per_step"], "chain": t["chain"]}


def pc_table_case(n: int, *, device, dtype=F32, names=PC_NAMES, mesh=None
                  ) -> dict[str, KrylovCase]:
    """The implicit wave step at Kershaw n³, cfl 1e3/3, cell-major GMRES
    (right, rtol atol 1e-5, maxiter 1000) with each preconditioner of
    `names`, as the JAX suite's iteration table builds them."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
    from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import (
        AggregationVCyclePC,
        GridVCyclePC,
    )
    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import (
        BlockCirculantProjectionPC,
        DCTBlockProjectionPC,
    )

    mesh = mesh or kershaw_mesh(B01, (n,) * 3)
    model = WaveSystem(mesh, cfl=1e3 / 3, device=device, dtype=dtype)
    kw = dict(device=device, dtype=dtype)
    pj = pcs.pbjacobi(model.divergence, shift=1.0)
    makers = {
        "none": lambda: None,
        "pbjacobi": lambda: pj,
        "circulant2l": lambda: pcs.additive(
            BlockCirculantProjectionPC(mesh, model.dt, model.c0, **kw).apply, pj),
        "dct2l": lambda: pcs.additive(
            DCTBlockProjectionPC(mesh, model.dt, model.c0, **kw).apply, pj),
        "dct2lm": lambda: pcs.multiplicative(
            model.implicit_matvec(), DCTBlockProjectionPC(mesh, model.dt, model.c0, **kw).apply,
            pj),
        "gridmg": lambda: GridVCyclePC.from_grid_model(
            model.divergence, mesh.topology_shape, cells_per_site=1,
            A0_apply=model.implicit_matvec(), A0_apply_fm=model.implicit_matvec_fm(), shift=1.0,
            dtype=dtype).apply,
        "aggvcycle": lambda: AggregationVCyclePC.from_bsr(
            model.divergence, A0_apply=model.implicit_matvec(), shift=1.0, factor=4,
            bottom_max=600, dtype=dtype).apply,
    }
    U0 = model.initial_state()
    return {name: first_step(model.implicit_stepper(M=makers[name](), rtol=1e-5, atol=1e-5,
                                                    maxiter=1000, side="right"), U0)
            for name in names}


def bench_pc_iterations(s: Suite, sides=(8, 16, 24)) -> dict:
    table, failures = {}, []
    for n in sides:
        s.log(f"bench: pc iteration table, kershaw {n}^3 ...")
        t0 = time.perf_counter()
        cases = pc_table_case(n, device=s.device, mesh=s.kershaw(n))
        row = {}
        for name, c in cases.items():
            want = R05_PC_TABLE.get(f"kershaw{n}", {}).get(name)
            row[name] = {"iters": c.iters, "converged": c.converged, "r05": want}
            if want is not None and (not c.converged or abs(c.iters - want) > GATE_BAND):
                failures.append(f"kershaw{n} {name}: {c.iters} iterations (converged "
                                f"{c.converged}), r05 {want} ± {GATE_BAND}")
        table[f"kershaw{n}"] = row
        s.log(f"bench: kershaw {n}^3 table in {time.perf_counter() - t0:.1f} s: "
              + ", ".join(f"{k} {v['iters']}" for k, v in row.items()))
    rec = {"metric": "wave_implicit_gmres_iters_by_pc", "value": table, "unit": "iterations",
           "precision": PRECISION,
           "note": "cell-major GMRES (right, rtol atol 1e-5, maxiter 1000); gridmg and aggvcycle "
                   "at kershaw8 (512 cells <= bottom_max) are the exact dense inverse; dct2l's "
                   "and dct2lm's DCT solve at the precision tier, circulant2l's coarse solve "
                   "by torch.fft"}
    if failures:
        rec["gate_failures"] = failures
    return rec


def wave_implicit_case(n: int, pc: str = "gridmg", *, device, dtype=F32, mesh=None
                       ) -> KrylovCase:
    """The implicit wave step at Kershaw n³, cfl 1e3/3: field-major GMRES
    (right, rtol atol 1e-5, maxiter 1000) with `pc` as the JAX suite's
    bench_wave_implicit builds it (gridmg all field-major; dct2lm's coarse
    solve behind one relayout pair; dct2l and circulant2l cell-major coarse
    solve plus field-major pbjacobi)."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
    from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC
    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import (
        BlockCirculantProjectionPC,
        DCTBlockProjectionPC,
    )

    mesh = mesh or kershaw_mesh(B01, (n,) * 3)
    model = WaveSystem(mesh, cfl=1e3 / 3, device=device, dtype=dtype)
    kw = dict(device=device, dtype=dtype)
    pj_fm = pcs.pbjacobi_fm(model.divergence, shift=1.0)
    if pc == "gridmg":
        pc_obj = GridVCyclePC.from_grid_model(
            model.divergence, mesh.topology_shape, cells_per_site=1,
            A0_apply=model.implicit_matvec(), A0_apply_fm=model.implicit_matvec_fm(),
            shift=1.0, dtype=dtype)
        M_cm, M_fm = None, pc_obj.apply_fm
    elif pc == "dct2lm":
        coarse = DCTBlockProjectionPC(mesh, model.dt, model.c0, **kw)
        M_cm, M_fm = None, pcs.multiplicative(
            model.implicit_matvec_fm(), pcs.cell_major_adapter(coarse.apply, model.nb), pj_fm)
    elif pc in ("dct2l", "circulant2l"):
        cls = BlockCirculantProjectionPC if pc == "circulant2l" else DCTBlockProjectionPC
        M_cm, M_fm = cls(mesh, model.dt, model.c0, **kw).apply, pj_fm
    else:
        raise ValueError(f"unknown preconditioner {pc!r}")
    step = model.implicit_stepper_fm(M_cm=M_cm, M_fm=M_fm, rtol=1e-5, atol=1e-5,
                                     maxiter=1000, side="right")
    return first_step(step, model.pack_fm(model.initial_state()).reshape(-1), model=model)


def scipy_implicit_baseline(model, U0: np.ndarray, reps: int = 2) -> tuple[float, int]:
    """One t=0 implicit solve with scipy.sparse GMRES + point-block Jacobi on
    the host's CPU (the JAX suite's yardstick). Returns (seconds, iterations)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    D = model.divergence
    b = D.block_size
    A = (sp.identity(D.shape[0], format="csr") + D.to_csr().to_scipy().astype(np.float64)).tocsr()
    Dinv = np.linalg.inv(D.block_diagonal().cpu().numpy().astype(np.float64)
                         + np.eye(b)[None, :, :])

    def pb(r):
        return np.einsum("nij,nj->ni", Dinv, r.reshape(-1, b)).reshape(-1)

    rhs = np.asarray(U0, dtype=np.float64)
    it = [0]

    def cb(_):
        it[0] += 1

    best = None
    for _ in range(reps):
        it[0] = 0
        t0 = time.perf_counter()
        spla.gmres(A, rhs, rtol=1e-5, atol=1e-5 * np.linalg.norm(rhs), restart=30, maxiter=34,
                   M=spla.LinearOperator(A.shape, pb), callback=cb, callback_type="pr_norm")
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, it[0]


def bench_wave_implicit(s: Suite, n: int = 16, pcs_=("gridmg",), K1: int = 5,
                        K2: int = 20) -> dict:
    """The gridmg row at Kershaw n³; the other preconditioners of `pcs_` go
    into the same record as <pc>_ms_per_step and <pc>_gmres_iters."""
    rec: dict = {}
    for pc in pcs_:
        s.log(f"bench: kershaw {n}^3 implicit ({pc}) ...")
        c = wave_implicit_case(n, pc, device=s.device, mesh=s.kershaw(n))
        t = s.krylov_time(c, K1, K2)
        if pc == "gridmg":
            model = c.extra["model"]
            rec.update({"metric": f"wave_implicit_step_ms_kershaw{n}", "value": t["ms"],
                        "unit": "ms/step", "pc": pc, "gmres_iters": c.iters,
                        "converged": c.converged, "unknowns": int(model.divergence.shape[0]),
                        "note": "t=0 solve (fixed iteration count) per step",
                        "device_ms_per_step": t["device_ms_per_step"],
                        "launches_per_step": t["launches_per_step"], "chain": t["chain"]})
            if s.scipy_baselines:
                s.log(f"bench: kershaw {n}^3 scipy CPU baseline ...")
                per_base, base_iters = scipy_implicit_baseline(
                    model, model.initial_state().cpu().numpy(), reps=1)
                rec.update(vs_baseline=per_base * 1e3 / t["ms"],
                           scipy_baseline_ms_per_step=per_base * 1e3,
                           scipy_baseline_gmres_iters=base_iters)
        else:
            rec.update({f"{pc}_ms_per_step": t["ms"], f"{pc}_gmres_iters": c.iters,
                        f"{pc}_precision": PRECISION if pc.startswith("dct") else None,
                        f"{pc}_converged": c.converged,
                        f"{pc}_device_ms_per_step": t["device_ms_per_step"],
                        f"{pc}_launches_per_step": t["launches_per_step"]})
    return gate_record(rec)


def wave_dct_direct_case(n: int, *, device, dtype=F32, steps: int = 0):
    """The wall cartesian n³ wave system at cfl 1e3/3: the exact DCT/DST direct
    step, field-major and captured; the packed initial state and the state
    after `steps` steps."""
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    model = WaveSystem(cartesian_mesh(B01, (n,) * 3), cfl=1e3 / 3, device=device, dtype=dtype)
    step = model.dct_fft_stepper_fm()
    U0 = U = model.pack_fm(model.initial_state())
    for _ in range(steps):
        U = step(U)[0]
    return model, step, U0, U


def bench_wave_dct_direct(s: Suite, n: int = 64) -> dict:
    s.log(f"bench: cartesian {n}^3 DCT direct step ...")
    model, step, U0, _ = wave_dct_direct_case(n, device=s.device)
    t = s.captured_time(step, U0, K1=50, K2=250, block=10)
    step.release()
    return {"metric": f"wave_dct_direct_us_per_step_{n}cubed", "value": t["ms"] * 1e3,
            "unit": "us/step", "unknowns": int(model.divergence.shape[0]),
            "precision": PRECISION,  # the model's DCTBlockWaveSolver, as the JAX model's
            "note": "exact wall-BC direct solve (field-major, captured chunks of 10 steps), "
                    "replaces GMRES+ILU", "launches_per_step": t["launches_per_step"],
            "chain": t["chain"]}


def diffusion_case(n: int, *, device, dtype=F32, fft_steps: int = 0):
    """Diffusion at cfl 10 on the wall cartesian n³ mesh (CG, rtol atol 1e-5,
    maxiter 1000: its first step) and on the periodic one (the FFT step,
    captured; the state after `fft_steps` steps)."""
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.models import DiffusionEquation

    model = DiffusionEquation(cartesian_mesh(B01, (n,) * 3), cfl=10.0, device=device,
                              dtype=dtype)
    cg = first_step(model.implicit_stepper(rtol=1e-5, atol=1e-5, maxiter=1000),
                    model.initial_state())
    modelp = DiffusionEquation(cartesian_mesh(B01, (n,) * 3, periodic=True), cfl=10.0,
                               device=device, dtype=dtype)
    fft_step = modelp.fft_stepper()
    up = u = modelp.initial_state()
    for _ in range(fft_steps):
        u = fft_step(u)[0]
    return cg, fft_step, up, u


def bench_diffusion_implicit(s: Suite, n: int = 64) -> dict:
    s.log(f"bench: diffusion {n}^3 CG and FFT steps ...")
    cg, fft_step, up, _ = diffusion_case(n, device=s.device)
    t = s.krylov_time(cg, K1=5, K2=20)
    tf = s.captured_time(fft_step, up, K1=100, K2=500, block=20)
    fft_step.release()
    return gate_record({
        "metric": f"diffusion_implicit_step_ms_{n}cubed", "value": t["ms"], "unit": "ms/step",
        "cg_iters": cg.iters, "converged": cg.converged, "unknowns": n**3,
        "note": "t=0 CG solve per step", "device_ms_per_step": t["device_ms_per_step"],
        "launches_per_step": t["launches_per_step"], "chain": t["chain"],
        "fft_direct_us_per_step_periodic": tf["ms"] * 1e3, "fft_chain": tf["chain"]})


def wave_ilu_case(n: int, *, device, dtype=F32) -> KrylovCase:
    """GMRES + ILU(0) (left, rtol atol 1e-5, maxiter 100) on the wall
    cartesian n³ wave system at cfl 1e3/3, the JAX suite's bench_wave_ilu:
    the first solve, the preconditioner and its host factor's seconds."""
    from circulantpreconditioner_tpu_torch.drivers.wave_implicit import identity_plus_csr
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.solvers import make_gmres
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs

    model = WaveSystem(cartesian_mesh(B01, (n,) * 3), cfl=1e3 / 3, device=device, dtype=dtype)
    t0 = time.perf_counter()
    A_I = identity_plus_csr(model, dtype)
    ilu = pcs.ilu0(A_I)
    setup_s = time.perf_counter() - t0
    solver = make_gmres(model.implicit_matvec(), ilu.apply, rtol=1e-5, atol=1e-5, maxiter=100,
                        side="left")
    U0 = model.initial_state()
    res = solver(U0, U0)
    step = lambda U: (solver(U, U).x,)  # noqa: E731
    return KrylovCase(step, U0, int(res.iters), bool(res.converged), res.x,
                      {"M": ilu.apply, "setup_s": setup_s, "unknowns": int(A_I.shape[0])})


def bench_wave_ilu(s: Suite, n: int = 32) -> dict:
    s.log(f"bench: ILU(0) at {n}^3 ...")
    c = wave_ilu_case(n, device=s.device)
    ta = s.graph_time(functools.partial(renormalised, c.extra["M"]), c.U0, K1=3, K2=9, block=3)
    t = s.krylov_time(c, K1=1, K2=2)
    return {
        "metric": f"wave_ilu0_step_ms_{n}cubed", "value": t["ms"], "unit": "ms/step",
        "unknowns": c.extra["unknowns"], "pc": "ilu0 (level-scheduled sweeps)",
        "gmres_iters": c.iters, "converged": c.converged, "ilu_apply_ms": ta["ms"],
        "setup_s": c.extra["setup_s"], "device_ms_per_step": t["device_ms_per_step"],
        "launches_per_step": t["launches_per_step"], "chain": t["chain"],
        "note": "the reference impl_seq default PC; at cfl 1e3/3 GMRES + ILU(0) does not "
                "converge in 100 iterations (in the JAX package either); compare "
                "wave_dct_direct_us_per_step (exact direct solve) on the same operator"}


def ladder_top_case(n: int, *, device, dtype=F32, mesh=None):
    """Kershaw-tet n³ (6 tets per hex) at cfl 1e3/3 through the model's own
    field-major route (drivers/wave_implicit.py --pc gridmg): GMRES (right,
    rtol atol 1e-5, maxiter 1000) over the supercell operator (K7 on the card),
    preconditioned by the grid V-cycle whose fine level is the model's
    operator."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_tet_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC

    mesh = mesh or kershaw_tet_mesh(B01, (n,) * 3)
    model = WaveSystem(mesh, cfl=1e3 / 3, device=device, dtype=dtype)
    pc = GridVCyclePC.from_grid_model(
        model.divergence, mesh.topology_shape, cells_per_site=model.cells_per_site,
        A0_apply=model.implicit_matvec(), A0_apply_fm=model.implicit_matvec_fm(), shift=1.0,
        dtype=dtype)
    step = model.implicit_stepper_fm(M_fm=pc.apply_fm, rtol=1e-5, atol=1e-5, maxiter=1000,
                                     side="right")
    return first_step(step, model.pack_fm(model.initial_state()).reshape(-1), model=model,
                      pc=pc)


def bench_ladder_top(s: Suite, n: int = 50) -> dict:
    from circulantpreconditioner_tpu_torch.mesh import kershaw_tet_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    s.log(f"bench: generating kershaw-tet {n}^3 (6x{n**3} tets) ...")
    mesh = kershaw_tet_mesh(B01, (n,) * 3)
    model_e = WaveSystem(mesh, cfl=1.0 / 3, device=s.device, dtype=F32)
    nnz = int(torch.count_nonzero(model_e.divergence.blocks).item())
    D_fm = model_e.divergence_op_fm(flat=True)
    G0 = model_e.pack_fm(model_e.initial_state()).reshape(-1)
    b_ms, b_by = spmv_bound(model_e, nnz)
    t_spmv = s.graph_time(functools.partial(renormalised, D_fm), G0, K1=20, K2=100, block=10,
                          bound_ms=b_ms)
    t_exp = s.graph_time(functools.partial(explicit_link, D_fm), G0, K1=20, K2=100, block=10,
                         bound_ms=b_ms)
    op_mb = tensor_bytes(model_e.supercell_operator) / 1e6
    del model_e, D_fm, G0
    s.log("bench: ladder-top implicit (grid V-cycle PC) ...")
    c = ladder_top_case(n, device=s.device, mesh=mesh)
    t = s.krylov_time(c, K1=1, K2=3)
    pc = c.extra["pc"]
    rec = {"metric": f"wave_implicit_step_ms_kershawtet{n}", "value": t["ms"], "unit": "ms/step",
           "cells": int(mesh.n_cells), "unknowns": int(c.U0.numel()),
           "pc": f"grid-vcycle ({pc.n_levels} levels)", "gmres_iters": c.iters,
           "converged": c.converged, "device_ms_per_step": t["device_ms_per_step"],
           "launches_per_step": t["launches_per_step"], "chain": t["chain"],
           "spmv_route": f"{type(c.extra['model'].supercell_operator).__name__} (field-major)",
           "spmv_gnnz_per_s": nnz / (t_spmv["ms"] / 1e3) / 1e9, "nnz": nnz,
           "spmv_ms_per_apply": t_spmv["ms"], "spmv_bound_ms": b_ms, "spmv_bound_by": b_by,
           "explicit_us_per_step": t_exp["ms"] * 1e3, "operator_dev_mb": op_mb,
           "pc_dev_mb": tensor_bytes(pc) / 1e6,
           "note": "generated KershawTetra3-rung analog; t=0 solve per step"}
    if s.scipy_baselines:
        s.log("bench: ladder-top scipy CPU baseline ...")
        model = c.extra["model"]
        per_base, base_iters = scipy_implicit_baseline(
            model, model.initial_state().cpu().numpy(), reps=1)
        rec.update(vs_baseline=per_base * 1e3 / t["ms"], scipy_baseline_ms_per_step=per_base * 1e3,
                   scipy_baseline_gmres_iters=base_iters)
    return gate_record(rec)


# --- the two distributed rows: torchrun workers --------------------------------

# circulant2l's GMRES iterations in the JAX suite's distributed records
# (results/bench_suite_r05.json wave_implicit_dist_kershaw{32,48}_8dev: 8
# virtual CPU devices, not the TPU), held within GATE_BAND
R05_DIST_ITERS = {32: 99, 48: 111}
DIST_CHAINS = (2, 6)  # K1, K2 re-solves of the first step per chain


def dist_command(n: int, P: int) -> list[str]:
    """The command of a distributed row at P ranks: torchrun (as `python -m
    torch.distributed.run`) starting P workers of this module, one per card."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            str(P), "-m", "circulantpreconditioner_tpu_torch.bench_suite", "--dist-worker", str(n)]


def default_dist_ranks() -> tuple[int, ...]:
    """P = 1, and 4 where four cards are visible (torch.cuda.device_count
    creates no CUDA context: the workers still find the cards free)."""
    return (1, 4) if torch.cuda.device_count() >= 4 else (1,)


@dataclass
class DistCase:
    """The two solves of a distributed row on this rank (no timing): the
    first step of each, its step function and start. `circ`: the JAX row's
    circulant2l case, row-sharded cell-major; `grid`: the sharded grid V-cycle
    (parallel/vcycle_dist.py), field-major z-slabs with K2 as the fine level;
    `grid_1dev`: rank 0's one-device GridVCyclePC solve of the same step
    (None on the other ranks)."""

    circ: KrylovCase
    grid: KrylovCase
    grid_1dev: KrylovCase | None
    extra: dict = field(default_factory=dict)

    def release(self) -> None:
        """Drop the solvers' graphs: a process group must outlive the graphs
        that hold its collectives."""
        for s in self.extra.pop("solvers", ()):
            s.release()


def dist_case(n: int, *, mesh, device, dtype=F32, precision: str = PRECISION) -> DistCase:
    """A distributed row's problem on this rank of `mesh` (a RankMesh): the
    Kershaw n³ wave system at cfl 1e3/3 (eps 0.3) as the JAX suite's
    `_scale_worker` builds it, GMRES right, rtol atol 1e-5, maxiter 1000,
    its reductions all-reduced over the ranks: (1) HaloELLMatrix +
    DistributedBlockCirculantPC + sharded_pbjacobi, additive (circulant2l);
    (2) the sharded grid V-cycle over the K2 slab operator (gridmg). Rank 0
    also solves (2) on one device (bench row wave_implicit's case). The PC's
    slab solve runs at `precision`, the JAX row's "high" unless asked."""
    import torch.distributed as dist

    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.parallel import (
        DistributedBlockCirculantPC,
        HaloELLMatrix,
        SlabGridVCyclePC,
        sharded_pbjacobi,
    )
    from circulantpreconditioner_tpu_torch.solvers import make_gmres
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
    from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC

    fv_mesh = kershaw_mesh(B01, (n,) * 3)
    model = WaveSystem(fv_mesh, cfl=1e3 / 3, device=device, dtype=dtype)
    D = model.divergence
    b = D.block_size
    kw = dict(rtol=1e-5, atol=1e-5, maxiter=1000, side="right")
    Ah = HaloELLMatrix(D.to_csr(dtype), mesh, row_multiple=b)
    coarse = DistributedBlockCirculantPC(fv_mesh, model.dt, model.c0, mesh, Ah.n_padded,
                                         dtype=dtype, precision=precision)
    Dinv = np.linalg.inv(D.block_diagonal().cpu().numpy().astype(np.float64)
                         + np.eye(b)[None, :, :])
    M = pcs.additive(coarse.apply, sharded_pbjacobi(Dinv, Ah.n_padded, mesh, dtype=dtype))
    circ = make_gmres(lambda v: v + Ah.matvec(v), M, allreduce=mesh.all_reduce, **kw)
    U0 = Ah.shard_vector(model.initial_state())

    pc = GridVCyclePC.from_grid_model(D, fv_mesh.topology_shape, cells_per_site=1,
                                      A0_apply=model.implicit_matvec(),
                                      A0_apply_fm=model.implicit_matvec_fm(), shift=1.0,
                                      dtype=dtype)
    spc = SlabGridVCyclePC.from_wave_model(model, mesh, pc=pc)
    grid = make_gmres(spc.fine, spc.apply, allreduce=mesh.all_reduce, **kw)
    G_full = model.pack_fm(model.initial_state()).reshape(-1)
    G0 = spc.shard(G_full)
    solvers = [circ, grid]
    cases = []
    for solver, x0 in ((circ, U0), (grid, G0)):
        res = solver(x0, x0)
        cases.append(KrylovCase(lambda U, s=solver: (s(U, U).x,), x0, int(res.iters),
                                bool(res.converged), res.x))
    grid_1dev = None
    if dist.get_rank() == 0:
        one = make_gmres(model.implicit_matvec_fm(), pc.apply_fm, **kw)
        solvers.append(one)
        res = one(G_full, G_full)
        grid_1dev = KrylovCase(lambda U: (one(U, U).x,), G_full, int(res.iters),
                               bool(res.converged), res.x)
    return DistCase(*cases, grid_1dev, {
        "unknowns": int(D.shape[0]), "pc_halo_fwd": int(coarse.halo_fwd),
        "pc_halo_bak": int(coarse.halo_bak), "spmv_halo": int(Ah.halo),
        "gridmg_levels": spc.describe(), "unshard_circ": Ah.unshard_vector,
        "unshard_grid": spc.unshard, "solvers": solvers})


def dist_host_chain(link: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                    mesh) -> Callable[[int], float]:
    """host_chain on every rank: each chain begun after a barrier of all the
    ranks, its seconds the largest of any rank's (an all-reduce MAX), so every
    rank sees the same pairs and accepts the same one."""
    import torch.distributed as dist

    def chain(K: int) -> float:
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = x0
        for _ in range(K):
            v = link(v)
        torch.cuda.synchronize()
        t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    return chain


def dist_time(case: KrylovCase, mesh, chains=DIST_CHAINS) -> dict:
    """Suite.krylov_time of a sharded Krylov case, its chains across the
    ranks (this rank's launches and device time)."""
    return Suite(mesh.device).krylov_time(case, *chains,
                                          chain=functools.partial(dist_host_chain, mesh=mesh))


def one_device_launches(case: KrylovCase) -> dict[str, float]:
    """K1 to K3 launches of one warm re-solve of a one-device case's first step."""
    case.step(case.U0)
    before = kernel_counts()
    case.step(case.U0)
    return per_call(before, 1)


def dist_record(n: int, P: int, case: DistCase, t_circ: dict, t_grid: dict,
                grid_1dev_launches: dict | None, cards: dict) -> dict:
    """A distributed row's record: the JAX record's keys (by metric name
    wave_implicit_dist_kershaw{n}_{P}dev), the port's fields beside, and the
    gates: circulant2l's count within GATE_BAND of r05's, the sharded gridmg
    count within one of the one-device count, and at P = 1 the same K2
    launches per step as one device."""
    rec = {"metric": f"wave_implicit_dist_kershaw{n}_{P}dev", "value": t_circ["ms"],
           "unit": "ms/step", "gmres_iters": case.circ.iters, "converged": case.circ.converged,
           "unknowns": case.extra["unknowns"], "pc": "circulant2l (halo all_to_all)",
           "pc_halo_fwd": case.extra["pc_halo_fwd"], "pc_halo_bak": case.extra["pc_halo_bak"],
           "spmv_halo": case.extra["spmv_halo"], "device": f"{cards['name']} x{P}",
           "gridmg_gspmd_iters": case.grid.iters, "gridmg_gspmd_converged": case.grid.converged,
           "gridmg_gspmd_ms_per_step": t_grid["ms"],
           "note": "t=0 solve per step, chained re-solves begun after a barrier of every rank, "
                   "each chain the slowest rank's; gridmg_gspmd: the sharded grid V-cycle "
                   "(parallel/vcycle_dist.py: z-slabs, the coarse grid gathered where a slab "
                   "turns odd), field-major GMRES, K2 on each rank's slab",
           "ranks": P, "cards": cards["nvidia_smi"],
           "device_ms_per_step": t_circ["device_ms_per_step"],
           "launches_per_step": t_circ["launches_per_step"], "chain": t_circ["chain"],
           "gridmg_levels": case.extra["gridmg_levels"],
           "gridmg_device_ms_per_step": t_grid["device_ms_per_step"],
           "gridmg_launches_per_step": t_grid["launches_per_step"],
           "gridmg_chain": t_grid["chain"]}
    failures = []
    want = R05_DIST_ITERS.get(n)
    if want is not None:
        rec["r05"] = {"gmres_iters": want}
        if not case.circ.converged:
            failures.append("gmres_iters: not converged")
        elif abs(case.circ.iters - want) > GATE_BAND:
            failures.append(f"gmres_iters {case.circ.iters}, outside {want} ± {GATE_BAND} "
                            "(results/bench_suite_r05.json, 8 virtual CPU devices)")
    one = case.grid_1dev
    if one is not None:
        rec.update(gridmg_one_device_iters=one.iters, gridmg_one_device_converged=one.converged,
                   gridmg_one_device_launches_per_step=grid_1dev_launches)
        if not (case.grid.converged and one.converged):
            failures.append(f"gridmg converged {case.grid.converged}, one device "
                            f"{one.converged}")
        elif abs(case.grid.iters - one.iters) > 1:
            failures.append(f"gridmg_gspmd_iters {case.grid.iters}, one device {one.iters} "
                            "(± 1)")
        if P == 1 and t_grid["launches_per_step"]["K2"] != grid_1dev_launches["K2"]:
            failures.append(f"gridmg K2 launches per step {t_grid['launches_per_step']['K2']}, "
                            f"one device {grid_1dev_launches['K2']}")
    if failures:
        rec["gate_failures"] = failures
    return rec


def dist_cards(device: torch.device) -> dict:
    """The rank's card by name, and nvidia-smi's name and power limit of
    every card of the host."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    return {"name": name, "nvidia_smi": smi or ["not read"]}


def dist_worker(n: int, device: str = "cuda", chains=DIST_CHAINS, log=None,
                precision: str = PRECISION) -> int:
    """One rank of a distributed row, under torchrun (or a process group the
    caller opened): builds and solves `dist_case` (its PC's slab solve at
    `precision`), times both solves, and on rank 0 prints the record as the
    last line of its stdout. Returns 1 when a gate fails (every rank computes
    the same counts), else 0."""
    import torch.distributed as dist

    from circulantpreconditioner_tpu_torch.parallel import device_mesh, rank_world

    with rank_world(None, device):
        dm = device_mesh()
        P, rank0 = dist.get_world_size(), dist.get_rank() == 0
        say = (log or (lambda msg: print(msg, file=sys.stderr, flush=True))) if rank0 \
            else (lambda msg: None)
        say(f"bench: distributed kershaw {n}^3 over {P} rank(s) ...")
        case = dist_case(n, mesh=dm, device=dm.device, precision=precision)
        say(f"bench: circulant2l {case.circ.iters} iterations, gridmg sharded "
            f"{case.grid.iters} ({case.extra['gridmg_levels']})"
            + (f", one device {case.grid_1dev.iters}" if case.grid_1dev else ""))
        try:
            t_circ = dist_time(case.circ, dm, chains)
            t_grid = dist_time(case.grid, dm, chains)
            l1 = one_device_launches(case.grid_1dev) if case.grid_1dev else None
            rec = dist_record(n, P, case, t_circ, t_grid, l1, dist_cards(dm.device))
            rec["precision"] = precision
            if rank0:
                print(json.dumps(rec), flush=True)
            dist.barrier()  # rank 0's one-device solves are done
        finally:
            case.release()
    return 1 if rec.get("gate_failures") else 0


def bench_scale_distributed(s: Suite, n: int = 32) -> list[dict]:
    """The row at each P of s.dist_ranks: torchrun's workers (dist_command),
    started from this process, rank 0's record read from their stdout."""
    from circulantpreconditioner_tpu_torch.native.build import build

    build()  # once, here, rather than in every worker (nvcc makes no CUDA context)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    recs = []
    for P in s.dist_ranks:
        cmd = dist_command(n, P)
        s.log(f"bench: {' '.join(cmd[1:])}")
        out = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, env=env, timeout=3000)
        lines = out.stdout.strip().splitlines()
        try:
            rec = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            raise RuntimeError(f"the P = {P} workers exited {out.returncode} with no record; "
                               f"stdout ends {out.stdout[-400:]!r}") from None
        if out.returncode and not rec.get("gate_failures"):
            raise RuntimeError(f"the P = {P} workers exited {out.returncode}")
        recs.append(rec)
    return recs


@dataclass
class Row:
    metric: str
    unit: str
    run: Callable[[Suite], dict | list[dict]]
    per_ranks: bool = False  # one record per P, named metric + f"_{P}dev"


# the issue order of the port: the flagship first, path J's rung last
ROWS = {
    "circulant": Row("circulant_pc_applies_per_s_100cubed", "solves/s", bench_circulant),
    "transport_implicit": Row("transport_implicit_step_ms_100cubed", "ms/step",
                              bench_transport_implicit),
    "wave_explicit": Row("wave_explicit_step_us_kershaw64", "us/step", bench_wave_explicit),
    "spmv": Row("spmv_gnnz_per_s_kershaw32", "Gnnz/s", bench_spmv),
    "spmv64": Row("spmv_gnnz_per_s_kershaw64", "Gnnz/s", lambda s: bench_spmv(s, 64)),
    "spmv_tet": Row("spmv_gnnz_per_s_tet16", "Gnnz/s", bench_spmv_tet),
    "wave_implicit": Row("wave_implicit_step_ms_kershaw16", "ms/step",
                         lambda s: bench_wave_implicit(
                             s, 16, ("gridmg", "dct2lm", "dct2l", "circulant2l"))),
    "wave_implicit32": Row("wave_implicit_step_ms_kershaw32", "ms/step",
                           lambda s: bench_wave_implicit(s, 32)),
    "wave_implicit64": Row("wave_implicit_step_ms_kershaw64", "ms/step",
                           lambda s: bench_wave_implicit(s, 64)),
    "wave_dct_direct": Row("wave_dct_direct_us_per_step_64cubed", "us/step",
                           bench_wave_dct_direct),
    "diffusion_implicit": Row("diffusion_implicit_step_ms_64cubed", "ms/step",
                              bench_diffusion_implicit),
    "wave_ilu": Row("wave_ilu0_step_ms_32cubed", "ms/step", bench_wave_ilu),
    "pc_iterations": Row("wave_implicit_gmres_iters_by_pc", "iterations", bench_pc_iterations),
    "ladder_top": Row("wave_implicit_step_ms_kershawtet50", "ms/step", bench_ladder_top),
}

# the JAX suite's distributed rows (wave_implicit_dist_kershaw{32,48}_8dev),
# one record per world size P; the suite runs them first, before it touches
# the card itself
DIST_ROWS = {
    "scale_distributed": Row("wave_implicit_dist_kershaw32", "ms/step",
                             bench_scale_distributed, per_ranks=True),
    "scale_distributed48": Row("wave_implicit_dist_kershaw48", "ms/step",
                               lambda s: bench_scale_distributed(s, 48), per_ranks=True),
}


def _row(name: str) -> Row:
    return ROWS[name] if name in ROWS else DIST_ROWS[name]


def run_rows(s: Suite, names) -> tuple[list[dict], list[str]]:
    """Each named row, its record printed as one JSON line; a row that raises
    or misses a gate is recorded (its traceback on stderr) and the next row
    runs. Returns the records and the failed rows' names."""
    results, failed = [], []
    for name in names:
        row = _row(name)
        t0 = time.perf_counter()
        try:
            out = row.run(s)
        except Exception as e:  # the suite's boundary: record the row's failure, go on
            traceback.print_exc()
            out = {"metric": f"{name}_ERROR", "error": f"{type(e).__name__}: {e}"[:500]}
        for rec in out if isinstance(out, list) else [out]:
            rec["seconds"] = time.perf_counter() - t0
            metric_ok = rec.get("metric") == row.metric or (
                row.per_ranks and rec.get("metric", "").startswith(row.metric + "_"))
            if "error" in rec or rec.get("gate_failures"):
                if name not in failed:
                    failed.append(name)
                s.log(f"bench: row {name} FAILED: {rec.get('error') or rec['gate_failures']}")
            elif not metric_ok or rec["unit"] != row.unit:
                raise AssertionError(f"row {name} produced {rec['metric']} in {rec['unit']}")
            print(json.dumps(rec), flush=True)
            results.append(rec)
    return results, failed


def write_results(out_path: str, results: list[dict], only: list[str] | None,
                  failed: list[str], device: dict) -> None:
    """Write the records under a header; with a subset of rows, merge into an
    existing file by metric name, dropping a failed row's older records and a
    re-run row's older error record."""
    payload = {"date": datetime.date.today().isoformat(), "device": device,
               "methodology": METHODOLOGY, "results": results}
    if only and os.path.exists(out_path):
        with open(out_path) as f:
            old = json.load(f)
        merged = {r["metric"]: r for r in old.get("results", [])}
        for name in failed:
            for k in [k for k in merged if k.startswith(_row(name).metric)]:
                del merged[k]
        for name in only:
            if name not in failed:
                merged.pop(f"{name}_ERROR", None)
        merged.update({r["metric"]: r for r in results})
        payload["results"] = list(merged.values())
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {out_path}", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    import argparse

    names = list(DIST_ROWS) + list(ROWS)
    p = argparse.ArgumentParser(description="The port's benchmark suite (see the module "
                                            "docstring).")
    p.add_argument("out", nargs="?", help="JSON file for the results")
    p.add_argument("rows", nargs="?", help="comma-separated rows (default: all), of "
                                           + ", ".join(names))
    p.add_argument("--scipy-baselines", action="store_true",
                   help="time the wave rows' SciPy GMRES baselines on the host CPU (minutes)")
    p.add_argument("--dist-ranks", help="comma-separated world sizes of the distributed rows "
                                        "(default: 1, and 4 where four cards are visible)")
    p.add_argument("--dist-worker", type=int, metavar="N",
                   help="run as one rank of a distributed row at Kershaw N^3 (under torchrun)")
    args = p.parse_args(argv)
    if args.dist_worker is not None:
        return dist_worker(args.dist_worker)
    only = args.rows.split(",") if args.rows else None
    unknown = sorted(set(only or ()) - set(names))
    if unknown:
        p.error(f"unknown rows {unknown}; the rows are {names}")
    if not torch.cuda.is_available():
        print("bench_suite: torch.cuda.is_available() is False; the suite runs on a GPU only",
              file=sys.stderr)
        return 1
    ranks = (tuple(int(v) for v in args.dist_ranks.split(",")) if args.dist_ranks
             else default_dist_ranks())
    s = Suite(require_cuda("cuda"), scipy_baselines=args.scipy_baselines,
              log=lambda msg: print(msg, file=sys.stderr, flush=True), dist_ranks=ranks)
    # the distributed rows' workers start before this process makes a CUDA
    # context (device_info's first call does)
    results, failed = run_rows(s, [n for n in DIST_ROWS if not only or n in only])
    info = device_info()
    s.log(f"bench_suite: {info['nvidia_smi']} | torch {info['torch']} cuda {info['cuda']}")
    more, more_failed = run_rows(s, [n for n in ROWS if not only or n in only])
    results, failed = results + more, failed + more_failed
    if args.out:
        write_results(args.out, results, only, failed,
                      {k: info[k] for k in ("name", "power_limit", "count", "torch", "cuda")})
    if failed:
        print(f"bench_suite: {len(failed)} row(s) failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
