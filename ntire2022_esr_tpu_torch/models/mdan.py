"""MDAN, team23 (counterpart of ``ntire2022_esr_tpu/models/mdan.py``; model
23).

Multi-dilation blocks, weight norm folded into the cache: ConvBlock is a
grouped 1x1, a depthwise 3x3 (dilated in the D variant) and a pointwise
1x1; MIRBs are two-branch dense ladders; three MMFB groups, each read out
by an MDAB head (a channel softmax and a spatial softmax) scaled by a
learned factor, the heads summed through a 1x1; mean shift in and out as
1x1 convs, and a global bicubic x4 residual of the mean-shifted input. On
stock ops; widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models.blocks import Layer

SLOPE = 0.2


class ConvBlock(nn.Module):
    """JAX ``_conv_block``: grouped 1x1 (3 groups), depthwise 3x3, 1x1."""

    def __init__(self, dilation: int = 1, groups: int = 3):
        super().__init__()
        self.dilation, self.groups = dilation, groups
        self.group_conv = Layer()
        self.depth_conv = Layer()
        self.point_conv = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ops.conv(self.group_conv, x, padding=0, groups=self.groups)
        h = ops.conv(self.depth_conv, h, dilation=self.dilation, groups=h.shape[1])
        return ops.conv(self.point_conv, h, padding=0)


class MIRB(nn.Module):
    """JAX ``_mirb``: three (plain, dilated) ConvBlock pairs, each pair's
    outputs concatenated, then a 1x1 and + x."""

    def __init__(self, dilation: int):
        super().__init__()
        for i in (1, 2, 3):
            self.add_module(f"conv3_{i}", ConvBlock())
            self.add_module(f"convd_{i}", ConvBlock(dilation))
        self.conv_last = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in (1, 2, 3):
            a = ops.leaky_relu(getattr(self, f"conv3_{i}")(h), SLOPE)
            b = ops.leaky_relu(getattr(self, f"convd_{i}")(h), SLOPE)
            h = ops.cat([a, b])
        return ops.conv(self.conv_last, h, padding=0) + x


class MMFB(nn.Module):
    """JAX ``_mmfb``: six MIRBs at dilations 1, 1, 2, 2, 3, 3, then + x."""

    NAMES = (("bs1", 1), ("bs11", 1), ("bs2", 2), ("bs22", 2), ("bs3", 3), ("bs33", 3))

    def __init__(self):
        super().__init__()
        for name, dilation in self.NAMES:
            self.add_module(name, MIRB(dilation))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for name, _ in self.NAMES:
            h = getattr(self, name)(h)
        return h + x


class MDAB(nn.Module):
    """JAX ``_mdab``: ``xr * softmax over channels + xr * softmax over
    pixels`` of a ConvBlock's output, then a 1x1."""

    def __init__(self):
        super().__init__()
        self.tail1 = Layer()
        self.tail2 = ConvBlock()
        self.conv = Layer()
        self.conv3 = ConvBlock()
        self.conv_end = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = ops.cat([ops.conv(self.tail1, x, padding=0), self.tail2(x)])
        xr = ops.conv(self.conv, xc, padding=0)
        xa = self.conv3(xc)
        n, c, h, w = xa.shape
        a1 = ops.softmax(xa, dim=1)
        a2 = ops.softmax(xa.reshape(n, c, h * w), dim=2).reshape(n, c, h, w)
        return ops.conv(self.conv_end, xr * a1 + xr * a2, padding=0)


class MDAN(nn.Module):
    """JAX ``mdan_apply``; NHWC in, NHWC out."""

    def __init__(self, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.sub_mean = Layer()
        self.conv_first = Layer()
        for i in (1, 2, 3):
            self.add_module(f"BS{i}", MMFB())
            self.add_module(f"upb{i}", MDAB())
            self.add_module(f"scale{i}", Layer(("scale",)))
        self.conv_add = Layer()
        self.out1 = Layer()
        self.add_mean = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.conv(self.sub_mean, ops.from_nhwc(x), padding=0)
        x_id = ops.interpolate(x, scale_factor=self.upscale, mode="bicubic")
        h = ops.leaky_relu(ops.conv(self.conv_first, x), SLOPE)
        r, heads = h, []
        for i in (1, 2, 3):
            r = getattr(self, f"BS{i}")(r)
            # an f32 (1,) factor: the product is f32 under every tier, as in JAX
            heads.append(getattr(self, f"upb{i}")(r) * getattr(self, f"scale{i}").scale)
        out = ops.conv(self.conv_add, ops.cat(heads), padding=0) + h
        out = ops.pixel_shuffle(ops.conv(self.out1, out), self.upscale) + x_id
        return ops.to_nhwc(ops.conv(self.add_mean, out, padding=0))
