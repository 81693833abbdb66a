"""The port's profiling utilities on the CPU against the JAX package's:
`timed` records a duration, and `trace` writes a Chrome trace naming the ops
it saw. The spans are tested in test_torch_spans.py."""

import glob
import json
import time

import torch

from circulantpreconditioner_tpu.utils.profiling import timed as j_timed
from circulantpreconditioner_tpu_torch.utils.profiling import timed, trace


def test_timed_records_seconds():
    out, ref = {}, {}
    with timed(out, "solve"):
        time.sleep(0.02)
    with j_timed(ref, "solve"):
        time.sleep(0.02)
    assert set(out) == set(ref) == {"solve"}
    assert 0.02 <= out["solve"] < 5.0


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "tr")) as logdir:
        for _ in range(3):
            a = torch.mm(a, a) / 64
    files = glob.glob(f"{logdir}/trace_*.json")
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)

