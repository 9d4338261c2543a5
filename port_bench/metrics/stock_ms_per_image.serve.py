"""stock_ms_per_image.serve: device time of the kernels outside the port's
two hand-written kernels (cuDNN convolutions, elementwise, pooling,
resize, conversions), in ms a frame, over the stream window (one span
around the traced batches). Moves ``images_per_s``.
"""

PORT_KERNELS = (r"^(void )?(esr::)?conv3x3_chain",
                r"^(void )?(esr::)?conv3x3_pixelshuffle")


def read(r):
    if r.units <= 0:
        return None
    t = r.kernel_s(None, exclude=PORT_KERNELS)
    if t <= 0:
        return None
    return 1000.0 * t / r.units
