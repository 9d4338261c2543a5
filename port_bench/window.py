"""What a driver hands back from its measured window, and the sample of
outputs it keeps for the comparison."""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class Window:
    """``units``: frames whose output the window produced (``attempted``);
    ``timed_s``: the driver's own time of the work (the wall time of a
    stream, the summed event times of replays); ``e2e``: the end-to-end metrics the driver measures;
    ``samples``: (pool index, output) pairs kept for the comparison;
    ``pool``: the uint8 NHWC frames on the host; ``tier``: the numerics
    tier the port says it ran (the server's, or the process's in the
    window)."""

    units: int
    timed_s: float
    e2e: Dict[str, float]
    samples: List[Tuple[int, np.ndarray]]
    pool: np.ndarray
    tier: str


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    by ``rng`` (reservoir sampling): item ``i`` is copied (``take()``) only
    when it is kept."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng = k, rng
        self.items: List[Tuple[int, int, np.ndarray]] = []
        self.seen = 0

    def offer(self, key: int, take: Callable[[], np.ndarray]) -> None:
        i = self.seen
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((i, key, take()))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = (i, key, take())

    def sample(self) -> List[Tuple[int, np.ndarray]]:
        return [(key, out) for _, key, out in sorted(self.items, key=lambda t: t[0])]
