"""tail_roofline.serve: the conv + PixelShuffle tail kernel's share of its
roofline, in %.

The least time the window's frames need in the tail (``work.py``: its
operations against the 16-bit tensor peak, or its bytes at the tier's
storage width against HBM, whichever is larger, for every call the
configuration lists) over the device time of the kernels whose names start
with ``conv3x3_pixelshuffle`` (in the namespace ``esr``) in the stream
window (one span around the traced batches). None where no such kernel
ran. Moves ``images_per_s``.
"""

PATTERN = r"^(void )?(esr::)?conv3x3_pixelshuffle"


def read(r):
    t = r.kernel_s(PATTERN)
    bound = r.bound_s("tail")
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
