"""Work of a forward and of each kernel call, and the card's peaks.

Whatever implements a layer, its work is counted the same way:

- **Operations.** A convolution of ``cin`` to ``cout`` channels with a
  ``k x k`` kernel over an ``H x W`` output does ``cin * cout * k * k * H * W``
  multiply-adds a frame, 2 operations each. A forward's MACs are counted
  on the plain reference (:func:`forward_macs`), by running it on meta
  tensors with a counting convolution: convolutions only, which is where
  these models do their work (the ESA's pooling, resize and gating and the
  residual adds are under 1% of it).
- **Bytes.** A kernel call reads each input and weight and writes each
  output once, at the tier's storage width (:data:`STORAGE_BYTES`): the
  least traffic any implementation needs.
  The conv chain (``widths`` c0 -> c1 -> ... -> cn, 3x3, + the input):
  ``H*W*(c0 + cn) + sum(9*ci*c(i+1) + c(i+1))`` values a frame. The conv +
  PixelShuffle tail (``cin -> cout = 3 * r * r``): ``H*W*(cin + cout) +
  9*cin*cout + cout`` values a frame (its output is the (rH, rW, 3) frame).
- **Bound.** A call's least time is the larger of operations over
  :data:`PEAK_FLOPS` and bytes over :data:`PEAK_BYTES`. The peak is the
  card's dense 16-bit tensor rate for every tier: no tier's contraction,
  in whatever arithmetic form, runs faster, so no kernel can read above
  100% of it.

The peaks are NVIDIA's data sheet for the H100 SXM at 700 W.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PEAK_FLOPS = 989e12  # dense f16/bf16 tensor-core rate, FLOP/s
PEAK_BYTES = 3.35e12  # HBM3 bandwidth, bytes/s

# the width in bytes of a stored activation under each tier of the port
STORAGE_BYTES = {"parity": 4, "high": 4, "mixed": 4,
                 "fasthi": 2, "fasthi16": 2, "fast": 2, "fast16": 2}


def storage_bytes(tier: str) -> int:
    if tier not in STORAGE_BYTES:
        raise KeyError(f"no storage width for tier {tier!r} (have {sorted(STORAGE_BYTES)})")
    return STORAGE_BYTES[tier]


def chain_work(widths, h: int, w: int, nbytes: int) -> Tuple[float, float]:
    """(operations, bytes) of one frame through a 3x3 conv chain."""
    pairs = list(zip(widths[:-1], widths[1:]))
    ops = 2.0 * h * w * 9 * sum(a * b for a, b in pairs)
    values = h * w * (widths[0] + widths[-1]) + sum(9 * a * b + b for a, b in pairs)
    return ops, float(values * nbytes)


def tail_work(cin: int, cout: int, h: int, w: int, nbytes: int) -> Tuple[float, float]:
    """(operations, bytes) of one frame through a 3x3 conv + PixelShuffle."""
    ops = 2.0 * h * w * 9 * cin * cout
    values = h * w * (cin + cout) + 9 * cin * cout + cout
    return ops, float(values * nbytes)


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def kernel_bound_s(config: Dict, kernel: str, tier: str, h: int, w: int) -> float:
    """Least seconds a frame of ``h x w`` spends in ``kernel`` ("chain" or
    "tail") over one forward, by the calls the configuration lists."""
    nb = storage_bytes(tier)
    total = 0.0
    for call in config["kernel_calls"].get(kernel, []):
        if kernel == "chain":
            ops, by = chain_work(call["widths"], h, w, nb)
        elif kernel == "tail":
            ops, by = tail_work(call["cin"], call["cout"], h, w, nb)
        else:
            raise KeyError(f"unknown kernel {kernel!r}")
        total += call["per_forward"] * bound_s(ops, by)
    return total


def forward_macs(reference, weights_path: str, h: int, w: int, channels: int = 3) -> int:
    """Multiply-adds of one (h, w) frame through ``reference.forward``,
    counted on meta tensors: convolutions only."""
    with np.load(weights_path) as z:
        params = {k: torch.empty(_oihw(z[k].shape), device="meta") for k in z.files}
    count = [0]

    def conv(x, wt, b, stride, padding):
        y = F.conv2d(x, wt, b, stride, padding)
        count[0] += int(wt.shape[0] * wt.shape[1] * wt.shape[2] * wt.shape[3]
                        * y.shape[0] * y.shape[2] * y.shape[3])
        return y

    reference.forward(params, torch.empty((1, channels, h, w), device="meta"), conv=conv)
    return count[0]


def _oihw(shape) -> Tuple[int, ...]:
    return (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else tuple(shape)


