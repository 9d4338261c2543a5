"""device_idle.protocol: the share of the replays' device time in which the
device ran nothing, in %: 100 x (1 - busy / extent), where a replay's
extent runs from its first kernel, copy or memset to the end of its last,
inside its span (from its start event to its stop event), and busy is
the union of that work (the arithmetic of the port's
``harness/profiling.busy_share``). It reads the gaps between the graph's
operations. The span's edges are left out: under the profiler the launch
of a graph of this size takes several times longer than it does without
it, so the whole span's idle share would mostly read the profiler. Moves
``runtime_ms``.
"""


def read(r):
    extent = r.trace.extent_us()
    if extent <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_us() / extent)
