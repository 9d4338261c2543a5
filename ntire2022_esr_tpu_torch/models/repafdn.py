"""RePAFDN, team10 (counterpart of ``ntire2022_esr_tpu/models/repafdn.py``;
model 10).

An RFDN variant in deploy form: three slim 2-stage distillation blocks and
one 3-stage block (no residual adds in the 3x3 branch), an ESA each, the
1x1 fusion, ``LR_conv``, pixel attention before the long skip, and the
pixel-shuffle tail. On stock ops; widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer

SLOPE = 0.05


class PA(nn.Module):
    """Pixel attention: x times sigmoid of a 1x1 conv of x (JAX ``pa``)."""

    def __init__(self):
        super().__init__()
        self.conv = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * ops.sigmoid(ops.conv(self.conv, x, padding=0))


class FDB(nn.Module):
    """A ``stages``-stage distillation block (JAX ``_fdb``)."""

    def __init__(self, stages: int):
        super().__init__()
        self.stages = stages
        for i in range(1, stages + 1):
            self.add_module(f"c{i}_d", Layer())
            self.add_module(f"c{i}_r", Layer())
        self.c4 = Layer()
        self.c5 = Layer()
        self.esa = blocks.ESA()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, distilled = x, []
        for i in range(1, self.stages + 1):
            distilled.append(blocks.conv_lrelu(getattr(self, f"c{i}_d"), h, SLOPE, padding=0))
            h = blocks.conv_lrelu(getattr(self, f"c{i}_r"), h, SLOPE)
        r4 = blocks.conv_lrelu(self.c4, h, SLOPE)
        return self.esa(ops.conv(self.c5, ops.cat(distilled + [r4]), padding=0))


class RePAFDN(nn.Module):
    """JAX ``repafdn_apply``; NHWC in, NHWC out."""

    def __init__(self, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.fea_conv = Layer()
        for i, stages in enumerate((2, 2, 2, 3), start=1):
            self.add_module(f"B{i}", FDB(stages))
        self.c = nn.Sequential(Layer())
        self.LR_conv = Layer()
        self.pa = PA()
        self.upsampler = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = ops.conv(self.fea_conv, ops.from_nhwc(x))
        h, outs = fea, []
        for i in range(1, 5):
            h = getattr(self, f"B{i}")(h)
            outs.append(h)
        h = blocks.conv_lrelu(self.c[0], ops.cat(outs), SLOPE, padding=0)
        h = self.pa(ops.conv(self.LR_conv, h)) + fea
        return blocks.upsample(self.upsampler, h, self.upscale)
