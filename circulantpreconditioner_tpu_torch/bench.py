"""The port's flagship benchmark: the counterpart of the repository's
`bench.py` (the JAX package's), on one NVIDIA GPU.

    python -m circulantpreconditioner_tpu_torch.bench

Flagship metric `circulant_pc_applies_per_s_100cubed`: direct solves of the
100³ periodic transport circulant C x = b per second (one solve is one
preconditioner apply), with λ = (0, 0, dt/h), dt = (1e3/3)(h/6), in float32.
`make_circulant_solver` at the "high" tier gives `DenseCirculantSolver` for
this λ: the y and z transforms cancel, and the solve is one (10⁴, 100)·(100,
100) product in bf16×3, one launch of kernel K4 (ops/tier_matmul.py), as the
JAX bench's "high" tier computes it on the TPU. A solve must pass the
residual gate ‖C x − b‖/‖b‖ < 1e-4 against the full 3D operator's matvec,
or the program exits 1. The submetrics time the full-3D formulations under
the same method: the staged DFT solver as the JAX package builds it
(`use_kernel=False`), the same solver through kernel K3 (`use_kernel=True`)
and the fused solver, kernel K1; each with its residual and its K1 to K7
launches per solve, all at the "high" tier (`precision` in the record). The
SciPy pipeline (rfftn → divide → irfftn) on the host's CPU is
`vs_baseline`'s yardstick.

Timing: paired, differenced chains on the card (`paired_chain_time`). A
chain is K dependent solves x ← solve(x), run as replays of one CUDA graph
that holds a block of them (utils/graphs.GraphSet, which counts the kernels'
launches per replay), timed by CUDA events and ended by a synchronise. Each
pair times a K1 chain and then a K2 chain, and gives (T(K2) − T(K1)) /
(K2 − K1) seconds per solve: the fixed cost of a chain cancels. The best pair
is accepted only when another pair agrees with it within 10 %; a pair with
no partner (a hiccup) is passed over; more pairs are taken, up to a fixed
number, and if none agree the measurement fails. So does a time below the
bound: no card beats its roofline. Without a CUDA device the timer raises:
it never times the CPU.

The one JSON line: {"metric", "value", "unit", "vs_baseline", "bound_ms",
"bound_by", "precision", "device": {"name", "power_limit", "torch", "cuda"},
"submetrics"}. `bound_ms` is that of the form the flagship runs: at "high"
K4's three bf16 passes, so the bytes (8.04 MB, 0.0024 ms) bound it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

METRIC = "circulant_pc_applies_per_s_100cubed"
UNIT = "solves/s"
N = 100  # the reference's largest registered grid ("gros calcul")
TOL_RESIDUAL = 1e-4  # ‖C x − b‖/‖b‖, the JAX bench's gate
PEAK_FP32 = 67e12  # H100 SXM float32 outside the tensor cores (NVIDIA data sheet)
PEAK_BF16 = 989e12  # H100 SXM dense bf16 on the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
PRECISION = "high"  # the JAX bench's tier (the repository's bench.py:144,157,166)
AGREE = 0.10  # the accepted pair and its partner differ by at most this share
MIN_PAIRS, MAX_PAIRS = 3, 12


class TimingError(RuntimeError):
    """A chain measurement that cannot be trusted: no two pairs agree, a time
    below the card's bound, or no CUDA device to time."""


@dataclass
class ChainTime:
    """Seconds per call of a paired chain measurement: `per_s` is the
    accepted pair, `pairs` every pair taken (seconds per call, in order),
    `partner` the pair that agreed with it."""

    per_s: float
    pairs: list[float] = field(default_factory=list)
    partner: float = 0.0

    @property
    def spread(self) -> float:
        """(max − min)/median over the positive pairs."""
        pos = sorted(p for p in self.pairs if p > 0)
        return (pos[-1] - pos[0]) / pos[len(pos) // 2] if pos else float("inf")

    def as_dict(self) -> dict:
        return {"per_call_ms": self.per_s * 1e3, "partner_ms": self.partner * 1e3,
                "pairs": len(self.pairs), "pair_spread": self.spread}


def agreeing_best(pers: list[float], agree: float = AGREE) -> tuple[float, float] | None:
    """The smallest positive per-call time that another pair confirms (the
    next larger one lies within `agree` of it), with that partner; None when
    no two pairs agree. Smaller pairs without a partner are hiccups: a stall
    during a pair's K1 chain shrinks its difference."""
    pos = sorted(p for p in pers if p > 0)
    for lo, hi in zip(pos, pos[1:]):
        if hi <= lo * (1 + agree):
            return lo, hi
    return None


def paired_chain_estimate(chain: Callable[[int], float], K1: int, K2: int, *,
                          min_pairs: int = MIN_PAIRS, max_pairs: int = MAX_PAIRS,
                          agree: float = AGREE, bound_ms: float | None = None) -> ChainTime:
    """Seconds per call from pairs of chains: `chain(K)` runs K dependent
    calls and returns their seconds. Takes `min_pairs` pairs, then more, up to
    `max_pairs`, until two agree (`agreeing_best`); raises TimingError when
    none do, or when the accepted time lies below `bound_ms`."""
    if not 0 < K1 < K2:
        raise ValueError(f"need 0 < K1 < K2, got {K1}, {K2}")
    pers: list[float] = []
    best = None
    while best is None:
        if len(pers) >= max_pairs:
            raise TimingError(f"no two of {len(pers)} chain pairs agree within {agree:.0%}: "
                              f"{[f'{p * 1e3:.6g}' for p in sorted(pers)]} ms per call")
        t1 = chain(K1)
        t2 = chain(K2)
        pers.append((t2 - t1) / (K2 - K1))
        if len(pers) >= min_pairs:
            best = agreeing_best(pers, agree)
    per, partner = best
    if bound_ms is not None and per * 1e3 < bound_ms:
        raise TimingError(f"{per * 1e3:.6g} ms per call is below the card's bound "
                          f"{bound_ms:.6g} ms")
    return ChainTime(per, pers, partner)


def require_cuda(device: torch.device | str) -> torch.device:
    """The device, when it is a CUDA device that is present; raises
    otherwise: a time of the CPU is never reported as the card's."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise TimingError(f"chains are timed on a CUDA device only; got {str(dev)!r} "
                          f"(torch.cuda.is_available() is {torch.cuda.is_available()})")
    return dev


def paired_chain_time(chain: Callable[[int], float], K1: int, K2: int, *,
                      device: torch.device | str, **kw) -> ChainTime:
    """`paired_chain_estimate` on a CUDA device (raises on any other)."""
    require_cuda(device)
    return paired_chain_estimate(chain, K1, K2, **kw)


class GraphChain:
    """A chain x ← fn(x) on the card, `block` links per replay of one CUDA
    graph (utils/graphs.GraphSet: K1 to K7 count their launches per replay).
    Calling it with K runs K links from x0 and returns their seconds by CUDA
    events, ended by a synchronise; K is a multiple of `block`. The first
    call captures the graph (after an eager warm-up)."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                 block: int):
        from circulantpreconditioner_tpu_torch.utils.graphs import GraphSet

        self.fn, self.block = fn, int(block)
        self.x0, self.x = x0, x0.clone()
        self.graphs = GraphSet(x0.device)
        self.links = 0  # links run, warm-up and capture included

    def _block(self) -> None:
        v = self.x
        for _ in range(self.block):
            v = self.fn(v)
        self.x.copy_(v)

    def run(self, K: int) -> None:
        if K % self.block:
            raise ValueError(f"chain length {K} is not a multiple of the block {self.block}")
        self.x.copy_(self.x0)
        for _ in range(K // self.block):
            self.graphs.run("block", self._block)
        self.links += K

    def __call__(self, K: int) -> float:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        self.run(K)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / 1e3


def host_chain(link: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor
               ) -> Callable[[int], float]:
    """chain(K): K links x ← link(x) from x0, driven by the host (the Krylov
    solves read their flags), timed by the host clock from a synchronise to
    a synchronise."""
    def chain(K: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = x0
        for _ in range(K):
            v = link(v)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return chain


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate of their type (fp32 unless given) and the
    bytes (each input read once, each output written once) over the memory
    rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_counts() -> dict[str, int]:
    """K1 to K7's launch counters, by name."""
    from circulantpreconditioner_tpu_torch.utils.graphs import kernel_launches

    return dict(zip(("K1", "K2", "K3", "K4", "K5", "K6", "K7"), kernel_launches()))


def per_call(before: dict[str, int], calls: int) -> dict[str, float]:
    """Launches of K1 to K7 per call since the counts `before`."""
    return {k: (v - before[k]) / max(calls, 1) for k, v in kernel_counts().items()}


def device_info() -> dict:
    """The card: its name, the count, its power limit as nvidia-smi gives it,
    and the torch and CUDA versions."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    line = smi[0] if smi else ""
    return {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "power_limit": line.rsplit(",", 1)[-1].strip() if "," in line else "not read",
            "nvidia_smi": line or "not read", "torch": torch.__version__,
            "cuda": torch.version.cuda}


# --- the flagship problem ---------------------------------------------------

def flagship_lambdas(n: int = N) -> tuple[float, float, float]:
    h = 1.0 / n
    dt = (1e3 / 3) * (h / 6)  # cfl 1e3/3 times min vol/surf = h/6, a = (1, 0, 0)
    return (0.0, 0.0, dt / h)


@dataclass
class FlagshipCase:
    """The flagship problem and its solvers, built and solved once (no
    timing): `residuals` holds ‖C x − b‖/‖b‖ of one solve of u0 by each."""

    op: object
    u0: torch.Tensor
    solvers: dict
    states: dict
    residuals: dict


def rel_residual(op, x: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.linalg.norm(op.matvec(x) - b) / torch.linalg.norm(b)).item()


def flagship_case(n: int = N, *, device: torch.device, dtype: torch.dtype = torch.float32,
                  full3d: bool = True) -> FlagshipCase:
    """The JAX bench's problem at n³: the dense collapse ("flagship") and,
    with full3d, the staged DFT solver (use_kernel False and True) and the
    fused one, each solving u0 once."""
    from circulantpreconditioner_tpu_torch.ops.circulant import CirculantTransportOperator
    from circulantpreconditioner_tpu_torch.ops.dft_matmul import MatmulCirculantSolver
    from circulantpreconditioner_tpu_torch.ops.fused_circulant import FusedCirculantSolver
    from circulantpreconditioner_tpu_torch.ops.spectral_collapse import make_circulant_solver

    lams = flagship_lambdas(n)
    shape = (n, n, n)
    op = CirculantTransportOperator.create(shape, lams, device=device, dtype=dtype)
    rng = np.random.default_rng(1)
    u0 = torch.as_tensor(rng.random(shape).astype(np.float32) * 50 + 600).to(device=device,
                                                                            dtype=dtype)
    solvers = {"flagship": make_circulant_solver(shape, lams, device=device, dtype=dtype,
                                                 precision=PRECISION)}
    if full3d:
        solvers["staged_full3d"] = MatmulCirculantSolver.from_operator(op, precision=PRECISION)
        solvers["staged_full3d_k3"] = MatmulCirculantSolver.create(
            shape, lams, device=device, dtype=dtype, precision=PRECISION, use_kernel=True)
        solvers["fused_full3d"] = FusedCirculantSolver.from_operator(op, precision=PRECISION)
    states = {k: s.solve(u0) for k, s in solvers.items()}
    residuals = {k: rel_residual(op, x, u0) for k, x in states.items()}
    return FlagshipCase(op, u0, solvers, states, residuals)


def measure_scipy_baseline(n: int, lam: np.ndarray, steps: int = 20) -> float:
    """Solves/s of the SciPy CPU pipeline (rfftn → divide → irfftn)."""
    from scipy import fft as sfft

    rng = np.random.default_rng(0)
    u = rng.random((n, n, n)).astype(np.float32)
    lam_r = lam.astype(np.complex64)

    def solve(v):
        return sfft.irfftn(sfft.rfftn(v) / lam_r, s=v.shape).astype(np.float32)

    solve(u)  # warm up plan caches
    t0 = time.perf_counter()
    v = u
    for _ in range(steps):
        v = solve(v)
    return steps / (time.perf_counter() - t0)


# (K1, K2, block) per solver: the JAX bench's chain lengths (bench.py:145,
# 158 and 168); the staged solvers' block is smaller (a capture of a block
# holds its temporaries)
CHAINS = {"flagship": (2000, 20000, 100), "staged_full3d": (1000, 6000, 20),
          "staged_full3d_k3": (1000, 6000, 20), "fused_full3d": (500, 2500, 100)}


def flagship_bound(n: int = N, precision: str = PRECISION) -> tuple[float, str]:
    """The dense collapse's bound at n³ in the form `precision` runs on the
    card: its 2·n³·n flops at the fp32 peak ("highest"), or K4's passes of
    them (three at "high", one at "default") at the bf16 tensor-core peak;
    or b read, x written and the n×n matrix read, in float32."""
    from circulantpreconditioner_tpu_torch.ops.tier_matmul import PASSES

    nbytes = 4.0 * (2 * n**3 + n * n)
    if precision == "highest":
        return bound(2.0 * n**3 * n, nbytes)
    return bound(PASSES[precision] * 2.0 * n**3 * n, nbytes, PEAK_BF16)


def flagship_record(*, device: torch.device | str = "cuda", log=print) -> dict:
    """The flagship line: every solver of `flagship_case` at 100³ timed by
    paired graph chains against the flagship bound, its residual gated at
    1e-4 (TimingError or ArithmeticError on a miss), and the SciPy baseline."""
    from circulantpreconditioner_tpu_torch.ops.circulant import np_eigenvalue_diagonal

    dev = require_cuda(device)
    case = flagship_case(N, device=dev)
    b_ms, b_by = flagship_bound(N)
    sub: dict = {}
    rate = 0.0
    for name, solver in case.solvers.items():
        K1, K2, block = CHAINS[name]
        res = case.residuals[name]
        log(f"bench: {name} ({type(solver).__name__}), residual {res:.3e}, chains {K1} and "
            f"{K2} ...")
        if not res < TOL_RESIDUAL:
            raise ArithmeticError(f"RESIDUAL CHECK FAILED: {name} {res:.3e} "
                                  f"(gate {TOL_RESIDUAL:g})")
        chain = GraphChain(solver.solve, case.u0, block)
        chain.run(block)  # the warm-up and the capture
        torch.cuda.synchronize()
        before, links = kernel_counts(), chain.links
        t = paired_chain_time(chain, K1, K2, device=dev, bound_ms=b_ms)
        launches = per_call(before, chain.links - links)
        log(f"bench: {name} {1 / t.per_s:.1f} solves/s ({t.per_s * 1e3:.6f} ms; partner "
            f"{t.partner * 1e3:.6f} ms, {len(t.pairs)} pairs), K1 to K7 launches per solve "
            f"{launches}")
        if name == "flagship":
            rate = 1.0 / t.per_s
            sub["flagship_rel_residual"] = res
            sub["flagship_rep_spread"] = t.spread
            sub["flagship_chain"] = t.as_dict()
            sub["flagship_launches_per_solve"] = launches
        else:
            sub[f"{name}_solves_per_s"] = 1.0 / t.per_s
            sub[f"{name}_rel_residual"] = res
            sub[f"{name}_chain"] = t.as_dict()
            sub[f"{name}_launches_per_solve"] = launches
    lam = np_eigenvalue_diagonal((N,) * 3, flagship_lambdas(N), rfft=True)
    baseline = measure_scipy_baseline(N, lam)
    log(f"bench: scipy baseline {baseline:.1f} solves/s")
    sub["scipy_baseline_solves_per_s"] = baseline
    info = device_info()
    return {"metric": METRIC, "value": rate, "unit": UNIT, "vs_baseline": rate / baseline,
            "bound_ms": b_ms, "bound_by": b_by, "precision": PRECISION,
            "device": {k: info[k] for k in ("name", "power_limit", "torch", "cuda")},
            "submetrics": sub}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False; this benchmark runs on a GPU only",
              file=sys.stderr)
        return 1
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    try:
        rec = flagship_record(log=log)
    except (TimingError, ArithmeticError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
