"""The request generator repeats exactly by seed, and makes the state on the
device from the configuration's levels."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import traffic
REPO = Path(__file__).resolve().parents[2]

CONFIG = json.loads((REPO / "portbench/configs/wave_kershaw64.json").read_text())
MIX = json.loads((REPO / "portbench/traffic/gmres_gridmg.json").read_text())


def draws(seed, stream, n=50):
    reqs = traffic.Requests(MIX, CONFIG, seed, stream)
    return [(tuple(c), r) for c, r in (reqs.next() for _ in range(n))]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_requests(seed):
    a, b = draws(seed, traffic.WINDOW), draws(seed, traffic.WINDOW)
    assert a == b


def test_seeds_and_streams_differ():
    a = draws(11, traffic.WINDOW)
    assert draws(12, traffic.WINDOW) != a
    assert draws(11, traffic.WARMUP) != a


def test_draws_stay_in_their_ranges():
    for centre, radius in draws(3, traffic.WINDOW, 500):
        assert np.all(np.abs(centre) <= MIX["centre_offset"])
        assert MIX["radius"][0] <= radius < MIX["radius"][1]


def test_state_levels_and_layout():
    centres = np.array([[0.0, 0.0, 0.0], [0.4, 0.4, 0.4]])
    make = traffic.StateMaker(CONFIG, centres, torch.device("cpu"), torch.float32)
    U = make(np.zeros(3), 0.3).reshape(2, 4).numpy()
    assert U[0].tolist() == CONFIG["initial_state"]["inside"]
    assert U[1].tolist() == CONFIG["initial_state"]["outside"]
