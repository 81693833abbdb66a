"""The one request generator. A request is the first implicit step (or the
first chunk of direct steps) of a simulation from a fresh initial state of
the reference's spherical-explosion family (WaveSystem.cxx:25-76 and the
transport drivers' spherical_explosion): the configuration's `inside` state
within a ball, its `outside` state elsewhere. The traffic mix draws each
ball's centre and radius from the seed:

    "centre_offset": c   the centre uniform in the domain centre ± c per axis
    "radius": [r0, r1]   the radius uniform in [r0, r1)

Streams: 0 is the measured window, 1 the warm-up, 2 the choice of the
requests whose answers are checked. The same seed gives the same requests.
The state is made on the device from the cells' centres (the reference
mesh's vertex means), so that both the port and the reference get it as is.
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW, WARMUP, SAMPLING = 0, 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, stream])


class Requests:
    """The stream of (centre, radius) of a traffic mix and a seed."""

    def __init__(self, mix: dict, config: dict, seed: int, stream: int):
        bounds = np.asarray(config["mesh"].get("bounds", ((-0.5, 0.5),) * 3), dtype=np.float64)
        self.middle = bounds.mean(axis=1)
        self.offset = float(mix["centre_offset"])
        self.r0, self.r1 = (float(v) for v in mix["radius"])
        self.rng = rng(seed, stream)

    def next(self) -> tuple[np.ndarray, float]:
        centre = self.middle + self.rng.uniform(-self.offset, self.offset, size=3)
        return centre, float(self.rng.uniform(self.r0, self.r1))


class StateMaker:
    """Makes a request's flat cell-major initial state on the device."""

    def __init__(self, config: dict, centres: np.ndarray, device: torch.device,
                 dtype: torch.dtype):
        state = config["initial_state"]
        self.centres = torch.as_tensor(centres, dtype=torch.float64, device=device)
        self.inside = torch.as_tensor(state["inside"], dtype=dtype, device=device)
        self.outside = torch.as_tensor(state["outside"], dtype=dtype, device=device)

    def __call__(self, centre: np.ndarray, radius: float) -> torch.Tensor:
        d2 = ((self.centres - torch.as_tensor(centre, device=self.centres.device)) ** 2).sum(1)
        inside = (d2 < radius * radius).unsqueeze(1)
        return torch.where(inside, self.inside, self.outside).reshape(-1)
