"""The port's profiling utilities on the CPU against the JAX package's:
`timed` records a duration, `trace` writes a Chrome trace naming the ops it
saw, and `StepMetrics` logs JSON lines and summarises them in the same form
as the JAX package's."""

import glob
import json
import time

import numpy as np
import torch

from circulantpreconditioner_tpu.utils.profiling import StepMetrics as JStepMetrics
from circulantpreconditioner_tpu.utils.profiling import timed as j_timed
from circulantpreconditioner_tpu_torch.utils.profiling import StepMetrics, timed, trace


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


def test_step_metrics_summary_matches_jax(tmp_path):
    recs = [dict(solve_s=0.5 + i, iters=10 * i, resnorm=1e-6 / (i + 1), it=i) for i in range(5)]
    mt, mj = StepMetrics(str(tmp_path / "m.jsonl")), JStepMetrics()
    for r in recs:
        mt.log(**r)
        mj.log(**r)
    assert mt.summary() == mj.summary()
    assert mt.summary()["iters"] == {"median": 20.0, "max": 40.0}
    lines = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert [{k: v for k, v in r.items() if k != "ts"} for r in lines] == recs
    assert StepMetrics().summary() == JStepMetrics().summary() == {"steps": 0}
    assert np.isfinite(lines[0]["ts"])
