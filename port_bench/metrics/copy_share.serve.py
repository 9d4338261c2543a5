"""copy_share.serve: the share of the device's busy time over the traced
stream window spent in copies (host to device and device to host), in %:
the union of the memcpy intervals over the union of all device work. None
where the device did nothing. Moves ``images_per_s``.
"""


def read(r):
    busy = r.trace.busy_us()
    if busy <= 0:
        return None
    return 100.0 * r.trace.busy_us(("gpu_memcpy",)) / busy
