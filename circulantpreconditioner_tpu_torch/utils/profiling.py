"""Profiling and observability, the reference's PetscTime/-log_view analog:
the counterpart of circulantpreconditioner_tpu/utils/profiling.py.

- `timed`: wall-clock context manager that waits for the device's queued
  work before it stops the clock (torch.cuda.synchronize once CUDA is in
  use; nothing on the CPU, whose work is done when the call returns).
- `trace`: a torch.profiler trace of a code block (the CPU and, where there
  is one, the GPU), exported as a Chrome trace (chrome://tracing, Perfetto)
  into `logdir`. Its traces carry the port's host spans.
- Spans. Tracing is on exactly while a torch.profiler session is active in
  the process (`tracing()`); nothing else switches it.

  `host_span(name)` marks host code for the profiler: a function-scope
  record (`_RecordFunctionFast`), which the profiler lists as a host op and
  never copies onto the device timeline, so it names the idle gaps of a
  trace without filling them. Off, it costs one check.

  `device_span(name, device)` accounts one of `DEVICE_SPANS` on the device
  clock: its entries, its inclusive time from entry to exit, and its self
  time, the inclusive less the spans nested inside it. A span opens and
  closes inside one step function (utils/graphs.py: one graph or one eager
  call). On the card a one-thread marker kernel (csrc/span_mark.cu) runs at
  the entry and at the exit, in stream order with the work, and keeps a
  stack and the accumulators in one device buffer. A graph captured by a
  `GraphSet` always holds its markers, as kernel nodes that stay disabled
  while no profiler runs, so a replay runs them only when traced and costs
  the host nothing either way; eager calls launch them only when traced;
  a graph captured outside a `GraphSet` holds none. On the CPU the same
  accounting runs on `time.perf_counter_ns`. `utils.graphs.STATS.snapshot()`
  returns the accumulators as `span_<name>_n`, `span_<name>_s` (self) and
  `span_<name>_incl_s`, the dots of the name written as `_`.

  PERF.md §3 names the metric that reads each span.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import tempfile
import time

import numpy as np
import torch

# the device spans, in the order of their ids on the device
DEVICE_SPANS = ("port.gmres.apply", "port.op", "port.pc", "port.pc.coarse",
                "port.gmres.ortho", "port.gmres.cycle", "port.supercell", "port.pc.site",
                "port.pc.circulant")
MAX_DEPTH = 16  # the device stack; deeper spans count their depth only
_OFF = contextlib.nullcontext()


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(result: dict, key: str):
    """`with timed(d, "solve"): ...` → d["solve"] = seconds, device work
    queued inside the block included."""
    _synchronize()  # work queued before the block is not the block's
    t0 = time.perf_counter()
    yield
    _synchronize()
    result[key] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block with torch.profiler and write its Chrome trace to
    `logdir` (default: torch_trace under the temporary directory) as
    trace_<pid>_<ms>.json. Yields logdir."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield logdir
        finally:
            _synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def tracing() -> bool:
    """True while a torch.profiler session is active in the process."""
    return torch.autograd._profiler_enabled()


def host_span(name: str):
    """A context manager that marks host code as `name` in the profiler's
    trace while tracing (see the module docstring)."""
    if not tracing():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def host_spanned(name: str):
    """Decorate a function to run inside `host_span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with host_span(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def _library():
    from circulantpreconditioner_tpu_torch.native.build import load_library

    return load_library()


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err} "
                           f"({lib.span_error_string(err).decode()})")


def _cuda_index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


class SpanAccounts:
    """The device spans' accumulators: on the host clock (CPU tensors) and in
    one int64 buffer per card (csrc/span_mark.cu's layout)."""

    def __init__(self, names=DEVICE_SPANS):
        self.names = tuple(names)
        self.ids = {n: i for i, n in enumerate(self.names)}
        self.host = np.zeros((len(self.names), 3), dtype=np.int64)  # entries, incl ns, self ns
        self._stack: list[list[int]] = []  # the host clock's: [id, entry ns, nested ns]
        self.buffers: dict[int, torch.Tensor] = {}
        self.device_ran = False  # a marker ran: snapshot() reads the buffers
        # the marker nodes of the graph a GraphSet is capturing, else None
        self.capture_nodes: list[int] | None = None

    def buffer(self, device: torch.device) -> torch.Tensor:
        """The card's buffer, made on first use: before any capture (a
        GraphSet makes it before it captures)."""
        i = _cuda_index(device)
        if i not in self.buffers:
            self.buffers[i] = torch.zeros(1 + 3 * MAX_DEPTH + 3 * len(self.names),
                                          dtype=torch.int64, device=torch.device("cuda", i))
        return self.buffers[i]

    def mark(self, i: int, enter: bool, device: torch.device) -> bool:
        """Mark span i's entry or exit; False where nothing is recorded (then
        its exit is not marked either)."""
        if device.type != "cuda":
            if not tracing():
                return False
            now = time.perf_counter_ns()
            if enter:
                self._stack.append([i, now, 0])
                self.host[i, 0] += 1
            elif self._stack:
                j, t0, nested = self._stack.pop()
                incl = now - t0
                self.host[j, 1] += incl
                self.host[j, 2] += incl - nested
                if self._stack:
                    self._stack[-1][2] += incl
            return True
        capturing = torch.cuda.is_current_stream_capturing()
        if capturing and self.capture_nodes is None:
            return False  # a graph no GraphSet manages: its markers could not be disabled
        if not capturing and not tracing():
            return False
        buf = self.buffer(device)
        lib = _library()
        node = ctypes.c_void_p()
        _check(lib, lib.span_mark(buf.data_ptr(), i, int(enter), MAX_DEPTH, _cuda_index(device),
                                  torch.cuda.current_stream(device).cuda_stream,
                                  ctypes.byref(node)), "span marker launch")
        if capturing:
            self.capture_nodes.append(node.value)
        else:
            self.device_ran = True
        return True

    def set_enabled(self, graph: torch.cuda.CUDAGraph, nodes, on: bool) -> None:
        """Enable or disable a graph's marker nodes from its next replay."""
        lib = _library()
        arr = (ctypes.c_void_p * len(nodes))(*nodes)
        _check(lib, lib.span_set_enabled(graph.raw_cuda_graph_exec(), arr, len(nodes), int(on)),
               "enabling span markers")
        if on:
            self.device_ran = True

    def totals(self) -> np.ndarray:
        """(entries, inclusive ns, self ns) per span, host and cards summed;
        the cards' buffers are read (one synchronise) once a marker ran."""
        out = self.host.copy()
        if self.device_ran:
            for buf in self.buffers.values():
                out += buf[1 + 3 * MAX_DEPTH:].view(-1, 3).cpu().numpy()
        return out

    def snapshot(self) -> dict:
        out = {}
        for name, (n, incl, own) in zip(self.names, self.totals()):
            key = "span_" + name.replace(".", "_")
            out[f"{key}_n"] = int(n)
            out[f"{key}_s"] = own * 1e-9
            out[f"{key}_incl_s"] = incl * 1e-9
        return out

    def reset(self) -> None:
        self.host[:] = 0
        self._stack.clear()
        for buf in self.buffers.values():
            buf.zero_()
        self.device_ran = False


SPANS = SpanAccounts()


class _DeviceSpan:
    __slots__ = ("i", "device", "on")

    def __init__(self, i: int, device: torch.device):
        self.i, self.device, self.on = i, device, False

    def __enter__(self):
        self.on = SPANS.mark(self.i, True, self.device)

    def __exit__(self, *exc):
        if self.on:
            SPANS.mark(self.i, False, self.device)


def device_span(name: str, device: torch.device):
    """A context manager that accounts the device work of its block as the
    device span `name` (see the module docstring)."""
    if SPANS.capture_nodes is None and not tracing():
        return _OFF
    return _DeviceSpan(SPANS.ids[name], device)
