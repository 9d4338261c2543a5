"""device_idle.serve: the share of the stream window (one span around the
traced batches) in which the device ran no kernel, copy or memset, in %:
100 x (1 - busy / window), the arithmetic of the port's
``harness/profiling.busy_share``. Moves ``images_per_s``.
"""


def read(r):
    if r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
