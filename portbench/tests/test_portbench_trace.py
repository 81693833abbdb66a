"""The trace reader on synthetic profiler events: the window, the device's
busy time as a union of intervals, the step's operations found through the
launching call's correlation id, and idle gaps labelled by the host's call."""

from __future__ import annotations

from dataclasses import dataclass

import pytest

from portbench import trace


@dataclass
class Ev:
    n: str
    s: int
    d: int
    dev: str = "CPU"
    corr: int = 0
    kind: str = "cpu_op"

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def device_type(self):
        return f"DeviceType.{self.dev}"

    def correlation_id(self):
        return self.corr

    def activity_type(self):
        return self.kind


EVENTS = [
    Ev(trace.REQUEST, 0, 100_000, kind="user_annotation"),
    Ev(trace.STEP, 10_000, 80_000, kind="user_annotation"),
    Ev(trace.STEP, 10_000, 80_000, dev="CUDA", kind="gpu_user_annotation"),
    Ev("cudaLaunchKernel", 2_000, 1_000, corr=1, kind="cuda_runtime"),  # the harness's
    Ev("cudaGraphLaunch", 12_000, 2_000, corr=2, kind="cuda_runtime"),  # the step's
    Ev("cudaEventSynchronize", 60_000, 30_000, corr=3, kind="cuda_runtime"),
    Ev("make_state", 4_000, 10_000, dev="CUDA", corr=1, kind="kernel"),
    Ev("k2_plane_stencil_kernel", 20_000, 20_000, dev="CUDA", corr=2, kind="kernel"),
    Ev("gemv", 30_000, 20_000, dev="CUDA", corr=2, kind="kernel"),
    Ev("Memcpy DtoH", 52_000, 1_000, dev="CUDA", corr=2, kind="gpu_memcpy"),
]


def test_busy_window_and_step_attribution():
    tr = trace.read(EVENTS, steps=2)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((10_000 + 30_000 + 1_000) * 1e-9)
    assert tr.step_kernels == 2
    assert tr.step_device_s == pytest.approx(41_000e-9)
    assert tr.kernel_count == {"make_state": 1, "k2_plane_stencil_kernel": 1, "gemv": 1}
    assert trace.REQUEST not in tr.kernel_seconds


def test_gaps_labelled_by_the_host_call():
    gaps = trace.read(EVENTS, steps=2).gaps
    assert gaps["cudaEventSynchronize"] == pytest.approx(47_000e-9)
    assert gaps["gaps under 5 us between device ops"] == pytest.approx(6_000e-9)
    assert gaps["host outside any traced call"] == pytest.approx(6_000e-9)
    assert sum(gaps.values()) == pytest.approx(59_000e-9)


def test_metrics_read_the_trace():
    from portbench.metrics import Context, device_idle_pct, k2_roofline, kernels_per_step

    tr = trace.read(EVENTS, steps=2)
    ctx = Context({"mesh": {"n": [64, 64, 64]}}, {}, 2, [], {}, tr, untraced_step_s=50e-6)
    # busy 41 us over 2 steps against 50 us of untraced wall a step
    assert device_idle_pct.read(ctx) == pytest.approx(59.0)
    assert device_idle_pct.read(Context({}, {}, 2, [], {}, tr)) is None
    assert kernels_per_step.read(ctx) == 1.0
    assert k2_roofline.read(ctx) == pytest.approx(100 * 50_331_648 / 3.35e12 / 20e-6)


def test_a_traced_run_keeps_its_check_and_trace_keys(tmp_path):
    """A --trace 1 run on the CPU at a tiny size: the check under its own name,
    last in the line, and the trace's keys."""
    import torch

    from portbench import run, spec
    from portbench.tests.conftest import tiny_root

    cell = spec.load_cell("transport100.direct_fft", tiny_root(tmp_path))
    result = run.run(cell, 2**34 + 5, 2.5, True, torch.device("cpu"))
    assert result["correct"] and list(result)[-1] == "checks"
    assert list(result["checks"]) == ["direct_error_max"]
    assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
