"""Fused nearest-x2 upsample + 3x3 conv (counterpart of ``ntire2022_esr_tpu/ops/fused.py``).

``conv3x3(nearest_x2(x))``, the progressive upsampler of m_RFDN (33) and
LWFANet (27), is lowered exactly to a low-resolution conv and a
PixelShuffle(2):

    y[2i+a, 2j+b, o] = sum_{dy,dx} W[o, :, dy, dx] * x[:, floor((2i+a+dy)/2),
                                                          floor((2j+b+dx)/2)]

Each output parity (a, b) reads a fixed set of low-resolution taps, and the
weights of coincident taps are summed (in f32, once, when the weights are
loaded); the four parities stacked as output channels give one 3x3 conv to
``4 * cout`` channels in the order (o, a, b), which is PixelShuffle(2)'s
own ``c*r*r + i*r + j``. So the conv and the shuffle are the tail kernel
``fused_conv3x3_pixelshuffle`` at r = 2, and the (2H, 2W, C) upsampled
intermediate never exists. HR zero padding maps onto LR zero padding one to
one. Exact up to f32 reassociation: two or four weights are added ahead of
the conv. ``config.fuse_upsample_conv`` turns it on (AUTO: every tier but
parity); otherwise the reference-shaped graph runs.

The JAX package's ``parallel_conv_pair`` and ``parallel_conv_same`` are not
ported: their AUTO is off at every site of the conv zoo.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.ops import nn
from ntire2022_esr_tpu_torch.ops.kernels.tail import fused_conv3x3_pixelshuffle
from ntire2022_esr_tpu_torch.ops.resize import interpolate

# A[a, r, d]: the weight of the HR tap offset d (-1, 0, 1 as 0..2) on the LR
# tap offset r (the same indexing) for output parity a:
#   a = 0: floor((2i + d) / 2)     = i-1 (d = -1), i (d = 0), i (d = 1)
#   a = 1: floor((2i + 1 + d) / 2) = i (d = -1), i (d = 0), i+1 (d = 1)
_A = np.array([[[1, 0, 0], [0, 1, 1], [0, 0, 0]],
               [[0, 0, 0], [1, 1, 0], [0, 0, 1]]], dtype=np.float32)


def nearest2_conv_weights(w: torch.Tensor, b: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """OIHW (cout, cin, 3, 3) HR taps -> (4 * cout, cin, 3, 3) LR taps, and
    the bias repeated to (4 * cout,), in the channel order (o, a, b). The
    coincident taps are summed in f32, first over dy, then over dx."""
    cout, cin, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"nearest2_conv takes 3x3 kernels, not {kh}x{kw}")
    a = torch.from_numpy(_A).to(device=w.device)
    t = torch.einsum("ard,ocde->oarce", a, w.float())   # the rows of taps summed
    w4 = torch.einsum("bse,oarce->oabcrs", a, t)        # then the columns
    b4 = None if b is None else b.float().repeat_interleave(4)
    return w4.reshape(4 * cout, cin, 3, 3).contiguous(), b4


def conv_pixelshuffle(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                      r: int) -> torch.Tensor:
    """``pixel_shuffle(conv(x, w, b), r)`` of a 3x3 conv through the tail
    kernel, on ``x`` cast to the tier's activation dtype (saturating into
    f16), as the JAX conv casts its input: an HR tail's first conv takes
    the f32 output of a ``high`` body under the scope's 2-byte tier."""
    x = nn.cast_compute(x, config.numerics().activation_dtype).contiguous(memory_format=nn.CL)
    return fused_conv3x3_pixelshuffle(x, w, b, r=r)


def nearest2_conv(x: torch.Tensor, w4: torch.Tensor, b4: Optional[torch.Tensor]) -> torch.Tensor:
    """``conv(nearest_x2(x))`` from the weights of
    :func:`nearest2_conv_weights`: :func:`conv_pixelshuffle` at r = 2."""
    return conv_pixelshuffle(x, w4, b4, 2)


def upconv_nearest2(p: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The models' upsampler step: :func:`nearest2_conv` on ``p.w4`` and
    ``p.b4`` (``models.blocks.Nearest2Layer`` derives them when its weights
    are loaded) where ``config.fuse_upsample_conv()`` is on, else the
    reference-shaped graph, nearest x2 then the conv."""
    if config.fuse_upsample_conv() and tuple(p.weight.shape[2:]) == (3, 3):
        return nearest2_conv(x, p.w4, p.b4)
    return nn.conv(p, interpolate(x, scale_factor=2, mode="nearest"))
