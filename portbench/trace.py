"""The traced run's reading of torch.profiler (CUPTI) events.

The harness marks, from its own code, each request ("portbench.request")
and the call into the port inside it ("portbench.step") with
`record_function`. A device operation (kernel, copy or set) belongs to the
step when the host call that launched it (the runtime or driver call of the
same correlation id: a kernel launch, a copy, or the graph launch of a
replay) lies inside a "portbench.step" span. The traced window runs from the first
request's start to the last one's end.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

REQUEST, STEP = "portbench.request", "portbench.step"
SHORT_GAP_NS = 5_000  # idle gaps shorter than this are counted together


@dataclass
class Trace:
    window_s: float
    busy_s: float  # the union of device operations' intervals in the window
    steps: int  # time steps completed in the traced requests
    kernel_seconds: dict = field(default_factory=dict)  # kernel name → device seconds
    kernel_count: dict = field(default_factory=dict)  # kernel name → launches
    step_kernels: int = 0  # device kernels launched by the step calls
    step_device_s: float = 0.0  # device seconds of the step calls' operations
    gaps: dict = field(default_factory=dict)  # host activity → idle seconds
    kinds: dict = field(default_factory=dict)  # event kind → events read

    def top_ops(self, n: int = 10) -> list:
        return sorted(([k, v] for k, v in self.kernel_seconds.items()),
                      key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> list:
        return sorted(([k, v] for k, v in self.gaps.items()), key=lambda kv: -kv[1])[:n]


def _kind(e) -> str:
    try:
        return str(e.activity_type())
    except AttributeError:
        return ""


def _inside(spans: list[tuple[int, int]], starts: list[int], t: int) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and spans[i][1] >= t


def read(events, steps: int) -> Trace:
    """The Trace of a profiler's kineto events (`prof.profiler.kineto_results
    .events()`); `steps` is the time steps of the traced requests."""
    requests, step_spans, device, host = [], [], [], []
    launch_time, kinds = {}, defaultdict(int)
    for e in events:
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        kinds[_kind(e)] += 1
        if str(e.device_type()).endswith("CUDA"):
            if name not in (REQUEST, STEP):  # not the device-side copy of a host span
                device.append((start, start + dur, name, e.correlation_id(),
                               not name.startswith(("Memcpy", "Memset"))))
        elif name in (REQUEST, STEP):
            (requests if name == REQUEST else step_spans).append((start, start + dur))
        else:
            if name.startswith("cu") and e.correlation_id():  # a runtime or driver call
                launch_time[e.correlation_id()] = start
            host.append((start, start + dur, name))
    if not requests:
        raise RuntimeError(f"the trace holds no request span; event kinds: {dict(kinds)}")
    t0, t1 = min(s for s, _ in requests), max(e for _, e in requests)
    step_spans.sort()
    step_starts = [s for s, _ in step_spans]

    tr = Trace(window_s=(t1 - t0) * 1e-9, busy_s=0.0, steps=steps, kinds=dict(kinds))
    seconds, count = defaultdict(float), defaultdict(int)
    intervals = []
    for s, e, name, corr, is_kernel in device:
        if e <= t0 or s >= t1:
            continue
        intervals.append((max(s, t0), min(e, t1)))
        if is_kernel:
            seconds[name] += (e - s) * 1e-9
            count[name] += 1
        launched = launch_time.get(corr)
        if launched is not None and _inside(step_spans, step_starts, launched):
            tr.step_device_s += (e - s) * 1e-9
            tr.step_kernels += is_kernel
    tr.kernel_seconds, tr.kernel_count = dict(seconds), dict(count)

    intervals.sort()
    busy, gaps, cursor = 0, [], t0
    for s, e in intervals:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < t1:
        gaps.append((cursor, t1))
    tr.busy_s = busy * 1e-9
    tr.gaps = _label_gaps(gaps, host)
    return tr


def _label_gaps(gaps, host) -> dict:
    """Idle seconds by what the host was doing at each gap's middle: the
    innermost host event (runtime call, operator or annotation) covering it;
    gaps under SHORT_GAP_NS together."""
    host.sort()
    starts = [h[0] for h in host]
    out = defaultdict(float)
    for s, e in gaps:
        if e - s < SHORT_GAP_NS:
            out["gaps under 5 us between device ops"] += (e - s) * 1e-9
            continue
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "host outside any traced call"
        for j in range(i, max(i - 200, -1), -1):  # the latest-started that covers it
            if host[j][1] >= mid:
                label = host[j][2]
                break
        out[label] += (e - s) * 1e-9
    return dict(out)
