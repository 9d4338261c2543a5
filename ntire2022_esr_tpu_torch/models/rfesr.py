"""RFESR, team36 (counterpart of ``ntire2022_esr_tpu/models/rfesr.py``;
model 36).

Weight-normed (folded into the cache) attention-gated residual units
(AAWRU) with learned scale pairs, the EFSA gate (a dilated conv and a
hard-sigmoid), and a channel-shuffle fusion through one reduction conv
shared by the three steps. The reference defines ``c``, ``conv3_`` and
``conv_f`` without using them; they are in the cache and held here unused,
as in JAX. The scales are f32 (1,) tensors: their products are f32 under
every tier, as in JAX. On stock ops; widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer


def _hsigmoid(x: torch.Tensor) -> torch.Tensor:
    return ops.relu6(x + 3.0) / 6.0


def _scales(m: nn.Module) -> None:
    m.res_scale = Layer(("scale",))
    m.x_scale = Layer(("scale",))


class EFSA(nn.Module):
    """JAX ``_efsa``."""

    def __init__(self, slope: float = 0.05):
        super().__init__()
        self.slope = slope
        for name in ("conv1", "conv_f", "conv2", "conv3_", "conv4"):
            self.add_module(name, Layer())
        self.conv_max = nn.Sequential(Layer())
        self.conv3 = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1_ = ops.conv(self.conv1, x, padding=0)
        c1 = ops.conv(self.conv2, c1_, stride=2, padding=0)
        v_max = ops.max_pool2d(c1, 7, 3)
        v_range = ops.leaky_relu(ops.conv(self.conv_max[0], v_max), self.slope)
        c3 = ops.leaky_relu(ops.conv(self.conv3[0], v_max, dilation=2), self.slope) + v_range
        c3 = ops.interpolate(c3, size=(x.shape[2], x.shape[3]), mode="bilinear")
        c4 = ops.conv(self.conv4, c3 + c1_, padding=0)
        return x * _hsigmoid(c4)


class AAWRU(nn.Module):
    """JAX ``_aawru``: conv, LeakyReLU(0.01), conv, EFSA, then the scaled
    sum with the scaled input."""

    def __init__(self, slope: float = 0.01):
        super().__init__()
        self.slope = slope
        _scales(self)
        self.body = nn.Sequential(Layer(), nn.Identity(), Layer(), EFSA())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ops.leaky_relu(ops.conv(self.body[0], x), self.slope)
        h = self.body[3](ops.conv(self.body[2], h))
        return h * self.res_scale.scale + x * self.x_scale.scale


class LRFFB(nn.Module):
    """JAX ``_lrffb``: four AAWRUs, three of them with a skip, then three
    channel-shuffle reductions through the shared ``reduction`` conv."""

    def __init__(self):
        super().__init__()
        for i in range(4):
            self.add_module(f"b{i}", AAWRU())
        self.reduction = Layer()
        _scales(self)

    def _reduce(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return ops.conv(self.reduction, ops.channel_shuffle(ops.cat([a, b]), 2), padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.b0(x)
        x1 = self.b1(x0) + x0
        x2 = self.b2(x1) + x1
        x3 = self.b3(x2)
        res = self._reduce(self._reduce(self._reduce(x3, x2), x1), x0)
        return res * self.res_scale.scale + x * self.x_scale.scale


class RFESR(nn.Module):
    """JAX ``rfesr_apply``; NHWC in, NHWC out."""

    def __init__(self, num_modules: int = 4, upscale: int = 4):
        super().__init__()
        self.num_modules, self.upscale = num_modules, upscale
        self.fea_conv = Layer()
        for i in range(1, num_modules + 1):
            self.add_module(f"B{i}", LRFFB())
        self.c = nn.Sequential(Layer())
        self.LR_conv = Layer()
        self.upsampler = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = ops.conv(self.fea_conv, ops.from_nhwc(x))
        h = fea
        for i in range(1, self.num_modules + 1):
            h = getattr(self, f"B{i}")(h)
        h = ops.conv(self.LR_conv, h) + fea
        return blocks.upsample(self.upsampler, h, self.upscale)
