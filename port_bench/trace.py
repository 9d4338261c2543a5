"""Reading a ``torch.profiler`` Chrome trace: the reduction from a traced
window to per-layer metrics.

The benchmark marks its window with ``torch.profiler.record_function``
spans of one name (the whole stream, or each timed replay). Device work
is every event of the categories in :data:`DEVICE_CATS` (kernels, graph
replays' kernels included, copies and memsets), clipped to those spans.
The arithmetic of :func:`union_us` and :meth:`Trace.busy_us` is that of
the port's ``harness/profiling.busy_share``, copied so that the yardstick
stays fixed.

:class:`Reading` is what a metric's reader (``metrics/<name>.py``, a
``read(reading)`` that returns a number or None) sees: the trace, the
units (images or replays) in the window, the configuration and the tier,
and the work arithmetic of ``work.py``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from port_bench import work

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")

Span = Tuple[float, float]


def union_us(spans: Iterable[Span]) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _merged(spans: Iterable[Span]) -> List[Span]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """The device's work inside the spans named ``window`` of a trace."""

    def __init__(self, events: Sequence[Dict], window: str):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.windows: List[Span] = sorted(
            (e["ts"], e["ts"] + e["dur"]) for e in xs
            if e.get("cat") == "user_annotation" and e.get("name") == window)
        if not self.windows:
            raise ValueError(f"the trace has no span named {window!r}")
        # (name, cat, start, end), clipped to each window
        self.device: List[Tuple[str, str, float, float]] = []
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            a, b = e["ts"], e["ts"] + e["dur"]
            for w0, w1 in self.windows:
                if b > w0 and a < w1:
                    self.device.append((e.get("name", ""), e["cat"], max(a, w0), min(b, w1)))
        self.host: List[Tuple[str, float, float]] = [
            (e.get("name", ""), e["ts"], e["ts"] + e["dur"]) for e in xs
            if e.get("cat") in HOST_CATS and e.get("name") != window]

    @property
    def window_us(self) -> float:
        return sum(b - a for a, b in self.windows)

    def extent_us(self) -> float:
        """Summed, over the windows, time from the window's first device
        operation to its last one's end."""
        total = 0.0
        for w0, w1 in self.windows:
            inside = [(a, b) for _, _, a, b in self.device if a < w1 and b > w0]
            if inside:
                total += max(b for _, b in inside) - min(a for a, _ in inside)
        return total

    def busy_us(self, cats: Sequence[str] = DEVICE_CATS) -> float:
        """Time in which the device ran work of ``cats`` (the union)."""
        return union_us((a, b) for _, c, a, b in self.device if c in cats)

    def kernel_us(self, include: Optional[str] = None, exclude: Sequence[str] = ()) -> float:
        """Summed time of the kernels whose names match the regular
        expression ``include`` (all kernels when None) and none of
        ``exclude``."""
        inc = re.compile(include) if include else None
        exc = [re.compile(p) for p in exclude]
        return sum(b - a for n, c, a, b in self.device
                   if c == "kernel" and (inc is None or inc.search(n))
                   and not any(p.search(n) for p in exc))

    def top_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations that took most time: [name, seconds]."""
        by: Dict[str, float] = {}
        for name, _, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest stretches of a window in which the device ran
        nothing, each named by the innermost host event under its start:
        [name, seconds]."""
        gaps: List[Span] = []
        busy = _merged((a, b) for _, _, a, b in self.device)
        for w0, w1 in self.windows:
            t = w0
            for a, b in busy:
                if b <= w0 or a >= w1:
                    continue
                if a > t:
                    gaps.append((t, a))
                t = max(t, b)
            if w1 > t:
                gaps.append((t, w1))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for a, b in gaps[:n]:
            under = [(e1 - e0, name) for name, e0, e1 in self.host if e0 <= a < e1]
            out.append([min(under)[1][:160] if under else "host: no traced call", (b - a) / 1e6])
        return out


@dataclasses.dataclass
class Reading:
    """A traced window, for the metrics' readers.

    ``units``: frames (a serving window's images, or a protocol window's
    replays of one frame each) whose device work lies in the window; ``timed_s``: the driver's own
    time of that work (the stream's wall time, or the summed event times
    of the replays); ``frame_hw``: the LR frame shape; ``tier``: the
    numerics tier the port ran; ``flops_per_frame``: 2 x the reference's
    MACs for one frame."""

    trace: Trace
    units: int
    timed_s: float
    config: Dict
    tier: str
    frame_hw: Tuple[int, int]
    flops_per_frame: float = 0.0

    @property
    def window_s(self) -> float:
        return self.trace.window_us / 1e6

    @property
    def busy_s(self) -> float:
        return self.trace.busy_us() / 1e6

    def kernel_s(self, include: Optional[str] = None, exclude: Sequence[str] = ()) -> float:
        return self.trace.kernel_us(include, exclude) / 1e6

    def bound_s(self, kernel: str) -> float:
        """Least seconds the window's frames need in ``kernel``."""
        h, w = self.frame_hw
        return self.units * work.kernel_bound_s(self.config, kernel, self.tier, h, w)
