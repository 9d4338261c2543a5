"""mfu.serve: the whole forward's share of the card's peak over the traced
stream window, in %: 2 x the plain reference's MACs a frame x the frames
served in the window, over (the window's length x 989 TFLOP/s, the dense
16-bit tensor peak). None without a window. Moves ``images_per_s``.
"""

from port_bench import work


def read(r):
    if r.window_s <= 0 or r.flops_per_frame <= 0 or r.units <= 0:
        return None
    return 100.0 * r.flops_per_frame * r.units / (r.window_s * work.PEAK_FLOPS)
