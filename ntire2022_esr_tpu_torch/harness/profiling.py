"""Timing and tracing helpers (counterpart of ``ntire2022_esr_tpu/harness/profiling.py``).

The JAX module fences with a device-to-host read because some of its
backends ignore ``block_until_ready``. Here a CUDA stream synchronises,
and a time on the card is taken with CUDA events, which measure the
device's work between them and not the host's dispatch.

:func:`trace` is ``torch.profiler`` writing a Chrome trace, and
:func:`busy_share` reads such a trace: the share of a marked window in
which the device ran a kernel or a copy.

:func:`chain_timer` is the sustained timing of the JAX package's sweeps:
forwards queued back to back and fenced once, on the host clock, so the
gaps in which the device waits for the host count.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Iterator, List, Tuple

import torch

TRACE_FILE = "trace.json"
# Chrome-trace categories of the device's own work: kernels (graph
# replays included) and copies between or within memories
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def fence(t: torch.Tensor) -> None:
    """Wait until the device work queued before now on ``t``'s device has
    finished (nothing to wait for on the CPU)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Timer:
    """Time of the work queued between :meth:`start` and :meth:`stop`, in
    ms: CUDA events on the current stream of ``device`` when it is a CUDA
    device, the host clock on the CPU (where every op finishes before it
    returns)."""

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


class MeshTimer:
    """Time of the work queued on several devices between :meth:`start`
    and :meth:`stop`, in ms: every device is synchronised first, so the
    devices start together, then a :class:`Timer` runs on each distinct
    device, and the time is the largest of theirs (the last device to
    finish). On one device it reads as that device's :class:`Timer`."""

    def __init__(self, devices):
        self._devices = list(dict.fromkeys(torch.device(d) for d in devices))
        self._timers = [Timer(d) for d in self._devices]

    def start(self) -> None:
        for d in self._devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        for t in self._timers:
            t.start()

    def stop(self) -> float:
        return max(t.stop() for t in self._timers)


def chain_timer(model: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                reps: int = 8, iters: int = 3) -> float:
    """Median seconds of a chain of ``reps`` forwards of ``model`` on ``x``
    (JAX ``profiling.chain_timer``): forward ``i`` takes ``x * (1 +
    1e-6 * i)``, so no two are the same, and its whole output is summed;
    the chain is queued without waiting and fenced once, and the host clock
    times it. One untimed forward builds the kernels first; the median is
    over ``iters`` chains. Divide by ``reps`` (and the batch) for a time
    per forward (and per image)."""
    def step(i: int) -> torch.Tensor:
        return model(x * (1.0 + 1e-6 * i)).sum()

    with torch.inference_mode():
        fence(step(0))
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            for r in range(reps):
                acc = step(r)
            fence(acc)
            times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


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


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block, host and (where there is a card)
    CUDA activity; on a normal exit the Chrome trace is written to
    ``logdir/trace.json``. Mark a window inside the block with
    ``torch.profiler.record_function(name)`` for :func:`busy_share`."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _union_us(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def busy_share(trace_path: str, window: str) -> Tuple[float, int]:
    """``(share, windows)``: over every host-side ``record_function`` span
    named ``window`` in the Chrome trace at ``trace_path``, the time in
    which the device ran a kernel, a copy or a memset (the union of those
    intervals, clipped to the windows) divided by the windows' summed span.
    A window should end after its device work has finished (a timer's
    ``stop`` synchronises), or the share misses that work."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    wins = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == window]
    if not wins:
        raise ValueError(f"{trace_path}: no window named {window!r}")
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    busy = sum(_union_us([(max(a, w0), min(b, w1)) for a, b in dev if b > w0 and a < w1])
               for w0, w1 in wins)
    return busy / sum(w1 - w0 for w0, w1 in wins), len(wins)
