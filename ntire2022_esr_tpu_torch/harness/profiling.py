"""Timing helpers (counterpart of ``ntire2022_esr_tpu/harness/profiling.py``).

The JAX module fences with a device-to-host read because some of its
backends ignore ``block_until_ready``. Here a CUDA stream synchronises,
and a time on the card is taken with CUDA events, which measure the
device's work between them and not the host's dispatch.

``chain_timer`` and ``trace`` are not ported yet (ROADMAP).
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch


def fence(t: torch.Tensor) -> None:
    """Wait until the device work queued before now on ``t``'s device has
    finished (nothing to wait for on the CPU)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Timer:
    """Time of the work queued between :meth:`start` and :meth:`stop`, in
    ms: CUDA events on a CUDA device, the host clock on the CPU (where
    every op finishes before it returns)."""

    def __init__(self, device: torch.device):
        self._cuda = torch.device(device).type == "cuda"

    def start(self) -> None:
        if self._cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._b = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._cuda:
            self._b.record()
            self._b.synchronize()
            return self._a.elapsed_time(self._b)
        return (time.perf_counter() - self._t0) * 1000.0


def device_timer(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> Tuple[float, List[float]]:
    """Median and all per-call times (seconds) of ``fn(*args)``, on the
    device of the first tensor argument (the CPU if there is none)."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)), torch.device("cpu"))
    timer = Timer(device)
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        timer.start()
        fn(*args)
        times.append(timer.stop() / 1000.0)
    return sorted(times)[len(times) // 2], times
