"""PLAINRFDN, team05's "NEESR" in its deploy form (counterpart of
``ntire2022_esr_tpu/models/plainrfdn.py``; model 05).

RFDN-shaped but a plain chain: distillation 1x1s without residual adds,
3x3s that are collapsed ECB modules (cache key ``.conv3x3``), no fusion of
the block outputs, and its own ESA (max-pool k7 s7 p1, two parallel 3x3
branches fused by a third). On stock ops but the x4 upsampler, which runs
as the tail kernel (``blocks.conv_shuffle``); widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer, conv_lrelu


class ESAPlain(nn.Module):
    """JAX ``esa_plain``."""

    def __init__(self):
        super().__init__()
        for name in ("conv1", "conv_f", "conv_2", "conv_3", "conv_23", "conv4"):
            self.add_module(name, Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1_ = ops.conv(self.conv1, x, padding=0)
        v_max = ops.max_pool2d(c1_, 7, 7, padding=1)
        c2 = ops.relu(ops.conv(self.conv_2, v_max))
        c3 = ops.relu(ops.conv(self.conv_3, v_max))
        c3 = ops.conv(self.conv_23, ops.cat([c2, c3]))
        c3 = ops.interpolate(c3, size=(x.shape[2], x.shape[3]), mode="bilinear")
        cf = ops.conv(self.conv_f, c1_, padding=0)
        return x * ops.sigmoid(ops.conv(self.conv4, c3 + cf, padding=0))


class _Conv3x3(nn.Module):
    """A collapsed ECB module: its one conv under ``conv3x3``."""

    def __init__(self):
        super().__init__()
        self.conv3x3 = Layer()


class RFDBPlain(nn.Module):
    """JAX ``_rfdb_plain``."""

    def __init__(self, slope: float = 0.05):
        super().__init__()
        self.slope = slope
        for i in (1, 2, 3):
            self.add_module(f"c{i}_d", Layer())
            self.add_module(f"c{i}_r", _Conv3x3())
        self.c4 = _Conv3x3()
        self.c5 = Layer()
        self.esa = ESAPlain()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, h, parts = self.slope, x, []
        for i in (1, 2, 3):
            parts.append(conv_lrelu(getattr(self, f"c{i}_d"), h, s, padding=0))
            h = conv_lrelu(getattr(self, f"c{i}_r").conv3x3, h, s)
        parts.append(conv_lrelu(self.c4.conv3x3, h, s))
        return self.esa(ops.conv(self.c5, ops.cat(parts), padding=0))


class PlainRFDN(nn.Module):
    """JAX ``plainrfdn_apply``; NHWC in, NHWC out."""

    def __init__(self, num_modules: int = 4, upscale: int = 4):
        super().__init__()
        self.num_modules, self.upscale = num_modules, upscale
        self.fea_conv = Layer()
        for i in range(1, num_modules + 1):
            self.add_module(f"B{i}", RFDBPlain())
        self.LR_conv = Layer()
        self.upsampler = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = ops.conv(self.fea_conv, ops.from_nhwc(x))
        h = fea
        for i in range(1, self.num_modules + 1):
            h = getattr(self, f"B{i}")(h)
        h = ops.conv(self.LR_conv, h) + fea
        return blocks.upsample(self.upsampler, h, self.upscale)
