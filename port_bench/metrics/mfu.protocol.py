"""mfu.protocol: the whole forward's share of the card's peak over the traced
replays, in %: 2 x the plain reference's MACs a frame x the replays, over
(the replays' device time x 989 TFLOP/s, the dense 16-bit tensor peak).
A replay's device time is its extent in the trace, from its first kernel,
copy or memset to the end of its last (``trace.Trace.extent_us``): the
profiler slows the launch of a graph, not its kernels, so the event time
of a traced replay would read the profiler too. None without replays.
Moves ``runtime_ms``.
"""

from port_bench import work


def read(r):
    extent_s = r.trace.extent_us() / 1e6
    if extent_s <= 0 or r.flops_per_frame <= 0 or r.units <= 0:
        return None
    return 100.0 * r.flops_per_frame * r.units / (extent_s * work.PEAK_FLOPS)
