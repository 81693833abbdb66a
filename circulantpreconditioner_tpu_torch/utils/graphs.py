"""CUDA graphs for the port's compiled programs: the counterpart of the JAX
package's `jax.jit` steps, its `jax.jit(lax.scan)` chunks of a time loop and
its jitted `lax.while_loop` Krylov solves (circulantpreconditioner_tpu/
models/runner.py, solvers/gmres.py, cg.py, bicgstab.py).

The JAX package traces each of these into one device program. Here each runs
as CUDA graphs captured from its plain PyTorch code:

- `GraphSet` runs named step functions. A step function takes no argument and
  returns nothing: it reads and writes tensors allocated before it first runs
  (static buffers), so an eager run and a replay are interchangeable. On the
  card, the first call of a name runs the function eagerly on the capture
  stream, which is its warm-up (cuFFT plans, cuBLAS workspaces, the
  kernel library, lazy tables, a communicator's first collective), and then
  captures it; every later call replays the graph on PyTorch's current
  stream. The graphs of one set share one memory pool: what they allocate
  lives only during a replay, and replays on one stream never overlap, so
  any order is safe. A capture that fails raises; nothing falls back to
  eager execution on the card. On the CPU, or while `CAPTURE` is false when
  the set is made, every call runs eagerly.
- `CapturedStep` is a time step U → (U_new, dnorm), the counterpart of a
  `@jax.jit` step impl. It keeps the state in one static buffer and runs n
  steps as one graph (one per n, as `make_runner(n)`'s cache holds one
  program per chunk length): the steps chain through the pool, and the last
  state is copied back into the buffer, one state copy per graph. Called as
  a function it stays functional, as a jitted impl is: the argument is
  copied in and the result copied out, so a state it returned is never
  overwritten by a later call. `models/runner.py` drives the buffer itself.
- `FlagRing` carries a few numbers per iteration to the host. After each
  iteration the solver enqueues an asynchronous copy of its device flags into
  a pinned slot and records an event; the host reads a slot after waiting on
  its event, L iterations behind the device (the lookahead), so the card
  always has work queued. On the CPU the flags are read directly.
- Kernel launch counts. K1 to K7 count their launches where their
  wrappers launch them, in Python, which a replay does not reach. A graph
  records how many launches of each it captured (the capture itself launches
  nothing and counts nothing), and every replay adds them. An iteration that
  a lookahead queued past the stop runs masked and launches its kernels all
  the same: they are counted, and `STATS.masked_launches` holds them apart.
  The V-cycle's level visits (`STATS.vcycle_levels_fused`, `_plain`), the
  point-block Jacobi applies (`STATS.block_jacobi_fused`, `_plain`) and the
  supercell SpMV's applies (`STATS.supercell_fused`, `_plain`) are counted
  in Python too, and a graph replays them the same way.
- `STATS` sums over all solves and steps: iterations kept and masked, the
  masked iterations' launches, graph replays, eager calls, host waits and
  the seconds they blocked, captures and the seconds they took; its
  snapshot adds the device spans' accumulators (utils/profiling.py).
- Device spans in a graph: a `GraphSet` captures their marker kernels as
  nodes and keeps the graph (`keep_graph`) to reach them; it enables them
  on a graph's first replay under an active profiler and disables them on
  its first replay after the profiler stops.

NCCL collectives (parallel/mesh_utils.py) are captured like any other work:
they issue on the capturing stream, with split sizes fixed when the step is
built, and the eager warm-up makes each communicator's first call before
any capture.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, fields
from typing import Callable, Hashable

import numpy as np
import torch

from circulantpreconditioner_tpu_torch.utils.profiling import (
    SPANS,
    host_span,
    host_spanned,
    tracing,
)


@functools.lru_cache(maxsize=1)  # imported once: every graph replay credits the counters
def _kernel_classes() -> tuple:
    from circulantpreconditioner_tpu_torch.ops.block_jacobi import BlockJacobiKernel
    from circulantpreconditioner_tpu_torch.ops.complex_matmul import ComplexMatmulKernel
    from circulantpreconditioner_tpu_torch.ops.fused_circulant import FusedCirculantSolver
    from circulantpreconditioner_tpu_torch.ops.plane_stencil import PlaneStencilMatvec
    from circulantpreconditioner_tpu_torch.ops.supercell_stencil import SupercellStencilKernel
    from circulantpreconditioner_tpu_torch.ops.tier_matmul import TierMatmulKernel
    from circulantpreconditioner_tpu_torch.ops.vcycle_sweep import VCycleSweepKernel

    return (FusedCirculantSolver, PlaneStencilMatvec, ComplexMatmulKernel, TierMatmulKernel,
            VCycleSweepKernel, BlockJacobiKernel, SupercellStencilKernel)


def kernel_launches() -> tuple[int, ...]:
    """The launch counters of K1 to K7, in that order."""
    return tuple(cls.launches for cls in _kernel_classes())


def credit(counts: tuple[int, ...], sign: int = 1) -> None:
    """Add (sign = 1) or take back (sign = −1) launches of K1 to K7."""
    for cls, n in zip(_kernel_classes(), counts):
        cls.launches += sign * n


# the STATS counters of the paths a step function took in Python (K5's level
# visits, K6's and K7's applies, and those their plain versions ran):
# replayed with it
_PATHS = ("vcycle_levels_fused", "vcycle_levels_plain", "block_jacobi_fused",
          "block_jacobi_plain", "supercell_fused", "supercell_plain")


def _path_counts() -> tuple[int, ...]:
    return tuple(getattr(STATS, name) for name in _PATHS)


def _credit_paths(counts: tuple[int, ...], sign: int = 1) -> None:
    for name, n in zip(_PATHS, counts):
        setattr(STATS, name, getattr(STATS, name) + sign * n)


def _diff(after: tuple[int, ...], before: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(a - b for a, b in zip(after, before))


@dataclass
class SolveStats:
    solves: int = 0
    iterations: int = 0  # iterations kept: the JAX while_loops' trips
    masked: int = 0  # iterations run past the stop, masked
    masked_launches: tuple[int, ...] = (0,) * 7  # K1 to K7 launched by the masked ones
    replays: int = 0  # graph replays
    eager_calls: int = 0  # step functions run eagerly (on the CPU, uncaptured, warm-ups)
    true_restarts: int = 0  # GMRES (true_residual) cycles run because ‖b − A x‖ missed
    # the tolerance that the previous cycle's estimate met
    waits: int = 0  # host waits on a flag event
    wait_seconds: float = 0.0  # host seconds blocked in those waits
    captures: int = 0
    capture_seconds: float = 0.0  # warm-up and capture of the graphs
    vcycle_levels_fused: int = 0  # V-cycle visits of levels below the fine one run by K5
    vcycle_levels_plain: int = 0  # ... run by the plain PyTorch stages
    block_jacobi_fused: int = 0  # field-major point-block Jacobi applies run by K6
    block_jacobi_plain: int = 0  # ... run by their plain versions (einsum)
    supercell_fused: int = 0  # supercell SpMV applies run by K7
    supercell_plain: int = 0  # ... by K7's plain version or the block-sparse stencil

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, f.default)
        SPANS.reset()

    def snapshot(self) -> dict:
        """The counters, and the device spans' (`span_*` keys, present with
        zeros before any span has run)."""
        return {**{f.name: getattr(self, f.name) for f in fields(self)}, **SPANS.snapshot()}


STATS = SolveStats()

# GraphSets made while this is false run every step function eagerly on the
# card too (a comparison of captured and uncaptured solves and steps)
CAPTURE = True

# one capture stream per device, shared by every GraphSet: the warm-ups run on
# it too, so the cuBLAS workspace it needs is made once, before any capture
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    key = torch.device("cuda", torch.cuda.current_device() if device.index is None
                       else device.index)
    if key not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[key] = torch.cuda.Stream(key)
    return _CAPTURE_STREAMS[key]


class _Graph:
    """A captured step function: its graph, the K1 to K7 launches and the
    path counts (`_PATHS`) it holds, and its device spans' marker nodes,
    enabled while `traced`."""

    __slots__ = ("graph", "counts", "paths", "markers", "traced")

    def __init__(self, graph: torch.cuda.CUDAGraph, counts: tuple[int, ...],
                 paths: tuple[int, ...], markers: list):
        self.graph, self.counts, self.paths = graph, counts, paths
        self.markers, self.traced = markers, True
        self.follow_profiler()

    def follow_profiler(self) -> None:
        """Enable the markers while a profiler runs, disable them after."""
        if self.markers and self.traced != tracing():
            self.traced = not self.traced
            SPANS.set_enabled(self.graph, self.markers, self.traced)


class GraphSet:
    """Named step functions of one solver, captured as CUDA graphs on the card
    (see the module docstring). `len()` is the number of graphs held."""

    def __init__(self, device: torch.device):
        self.capture = CAPTURE and device.type == "cuda"
        self.device = device
        self._graphs: dict[Hashable, _Graph] = {}
        self._pool = None

    def __len__(self) -> int:
        return len(self._graphs)

    def release(self) -> None:
        """Drop every graph (and with them their memory pool)."""
        self._graphs.clear()
        self._pool = None

    def run(self, key: Hashable, fn: Callable[[], None]) -> tuple[int, ...]:
        """Run the step function `fn`, saved under `key`; returns the K1 to K7
        launches it made, which the counters already hold."""
        if not self.capture:
            before = kernel_launches()
            fn()
            STATS.eager_calls += 1
            return _diff(kernel_launches(), before)
        entry = self._graphs.get(key)
        if entry is None:
            return self._warm_up_and_capture(key, fn)
        entry.follow_profiler()
        entry.graph.replay()
        STATS.replays += 1
        credit(entry.counts)
        _credit_paths(entry.paths)
        return entry.counts

    @host_spanned("port.capture")
    def _warm_up_and_capture(self, key: Hashable, fn: Callable[[], None]) -> tuple[int, ...]:
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        SPANS.buffer(self.device)  # the markers' buffer, made outside any capture
        current = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            before = kernel_launches()
            fn()  # this call's work, and the warm-up before capture
            ran, ran_paths = kernel_launches(), _path_counts()
            graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept: the markers are its nodes
            markers = []
            graph.capture_begin(pool=self._pool)
            SPANS.capture_nodes = markers
            try:
                fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated; the first error says why
                raise
            finally:
                SPANS.capture_nodes = None
            graph.capture_end()
            graph.instantiate()
            counts = _diff(kernel_launches(), ran)
            credit(counts, -1)  # a capture launches nothing
            paths = _diff(_path_counts(), ran_paths)
            _credit_paths(paths, -1)
        current.wait_stream(side)
        self._graphs[key] = _Graph(graph, counts, paths, markers)
        STATS.eager_calls += 1
        STATS.captures += 1
        STATS.capture_seconds += time.perf_counter() - t0
        return _diff(ran, before)


class CapturedStep:
    """A pure time step `fn`: U → (U_new, dnorm), run as CUDA graphs on the
    card (see the module docstring). `start(U0, norms)` loads the state
    buffer, `advance(n)` runs n steps as one graph and returns their dnorms,
    `state` is the buffer; calling the object is one functional step. With
    `norms` (a sharded state's global_norms: local dnorms → global ones) the
    reduction runs inside the graph. The graphs are kept while the state's
    shape, dtype and device and `norms` stay; `release()` drops them."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._key = None

    def release(self) -> None:
        if self._key is not None:
            self.graphs.release()
            del self.graphs, self._U, self._dn
        self._key = None

    def start(self, U0: torch.Tensor, norms: Callable | None = None) -> None:
        key = (tuple(U0.shape), U0.dtype, U0.device, norms)
        if key != self._key:
            self.release()
            self.graphs = GraphSet(U0.device)
            self._U = torch.empty_like(U0)
            self._dn: dict[int, torch.Tensor] = {}
            self._key = key
        self._U.copy_(U0)

    @property
    def state(self) -> torch.Tensor:
        """The state buffer, which the next `advance` overwrites."""
        return self._U

    def advance(self, n: int) -> torch.Tensor:
        """Run n steps from the state buffer into it; returns their dnorms, a
        buffer that the next `advance(n)` overwrites."""
        norms = self._key[3]
        if n not in self._dn:
            self._dn[n] = torch.empty(n, dtype=self._U.dtype, device=self._U.device)
        dn = self._dn[n]

        def chunk() -> None:
            U, ds = self._U, []
            for _ in range(n):
                U, d = self.fn(U)[:2]
                ds.append(d.reshape(()))
            d = torch.stack(ds)
            dn.copy_(d if norms is None else norms(d))
            self._U.copy_(U)  # the chunk's one state copy

        self.graphs.run(n, chunk)
        return dn

    def __call__(self, U: torch.Tensor):
        self.start(U)
        dn = self.advance(1)
        return self._U.clone(), dn[0].clone()


class FlagRing:
    """`slots` rows of `width` float64 flags on their way to the host. A step
    function writes `flags` (a device tensor); `post(slot)` enqueues its copy
    into the slot and, on the card, records the slot's event; `read(slot)`
    waits on that event (a host wait, counted in STATS with the seconds it
    blocked) and returns the row."""

    def __init__(self, slots: int, width: int, device: torch.device):
        self.on_card = device.type == "cuda"
        self.flags = torch.zeros(width, dtype=torch.float64, device=device)
        self.host = torch.zeros((slots, width), dtype=torch.float64, pin_memory=self.on_card)
        self.events = [torch.cuda.Event() for _ in range(slots)] if self.on_card else []

    def __len__(self) -> int:
        return self.host.shape[0]

    def post(self, slot: int) -> None:
        self.host[slot].copy_(self.flags, non_blocking=self.on_card)
        if self.on_card:
            self.events[slot].record()

    def read(self, slot: int) -> np.ndarray:
        if self.on_card:
            with host_span("port.flag_wait"):
                t0 = time.perf_counter()
                self.events[slot].synchronize()
                STATS.wait_seconds += time.perf_counter() - t0
            STATS.waits += 1
        return self.host[slot].numpy().copy()


def masked_update(active: torch.Tensor, *pairs) -> None:
    """dst ← new where `active` (a 0-d bool tensor), for each (dst, new):
    torch.where, so that a NaN in a discarded iteration cannot leak."""
    for dst, new in pairs:
        torch.where(active, new, dst, out=dst)
