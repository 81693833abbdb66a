"""The roofline arithmetic at the cells' shapes, against the figures of
PERF.md's kernel table where the work is the same: K1's 12.08 MB at 100³
(state in, state out, half spectrum) and K2's 50.3 MB at Kershaw 64³."""

from __future__ import annotations

import pytest

from portbench import roofline


def test_direct_step_bytes_at_100_cubed():
    assert roofline.direct_step_bytes((100, 100, 100)) == 12_080_000


def test_direct_step_is_bytes_bound_at_3_6_us():
    t, what = roofline.bound(roofline.direct_step_flops((100, 100, 100)),
                             roofline.direct_step_bytes((100, 100, 100)))
    assert what == "bytes"
    assert t == pytest.approx(3.606e-6, rel=1e-3)


def test_k2_bytes_at_kershaw_64():
    assert roofline.k2_bytes(64 ** 3, 4, 6) == 50_331_648


def test_bound_takes_the_larger():
    assert roofline.bound(67e12, 1.0) == (1.0, "operations")
    assert roofline.bound(0.0, 3.35e12) == (1.0, "bytes")
