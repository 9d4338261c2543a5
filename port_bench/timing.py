"""Timing of device work: a copy of the port's ``harness/profiling.Timer``
(the protocol's own timer), kept here so that a change to the port cannot
change the yardstick."""

from __future__ import annotations

import math
import time

import torch


class Timer:
    """Time of the work queued between :meth:`start` and :meth:`stop`, in
    ms: CUDA events on the current stream of ``device`` when it is a CUDA
    device (``stop`` waits for the second event), the host clock on the
    CPU."""

    def __init__(self, device: torch.device):
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"

    def start(self) -> None:
        if self._cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._b = torch.cuda.Event(enable_timing=True)
            self._a.record(torch.cuda.current_stream(self._device))
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._cuda:
            self._b.record(torch.cuda.current_stream(self._device))
            self._b.synchronize()
            return self._a.elapsed_time(self._b)
        return (time.perf_counter() - self._t0) * 1000.0


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) of ``values`` by nearest rank: the
    smallest value with at least a share ``q`` of the values at or below it."""
    s = sorted(values)
    k = math.ceil(round(q * len(s), 9))
    return s[min(max(k, 1), len(s)) - 1]
