"""EFDN, team01's "NKU-ESR" in its deploy form (counterpart of
``ntire2022_esr_tpu/models/efdn.py``; model 01).

Edge-enhanced blocks collapsed to a plain 3x3 + PReLU; cells with a
4-branch 1x1 distill-and-fuse and an ESA; fusion 1x1s across cells; the
output clamped to [0, 1]. On stock ops but the x4 upsampler, which runs as
the tail kernel (``blocks.conv_shuffle``); widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer


class _ConvPReLU(nn.Module):
    """A same-padded conv (under the cache name ``conv``) then PReLU
    (``act.weight``): JAX ``_edbb`` with ``rep_conv`` (3x3) and
    ``_conv1x1_prelu`` with ``conv1x1``."""

    def __init__(self, conv: str):
        super().__init__()
        self.conv_name = conv
        self.add_module(conv, Layer())
        self.act = Layer(("weight",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.prelu(ops.conv(getattr(self, self.conv_name), x), self.act.weight)


class Cell(nn.Module):
    """JAX ``_cell``."""

    def __init__(self):
        super().__init__()
        self.conv1 = _ConvPReLU("conv1x1")
        self.conv2 = _ConvPReLU("rep_conv")
        self.conv3 = _ConvPReLU("rep_conv")
        self.branch = nn.ModuleList([Layer() for _ in range(4)])
        self.fuse = Layer()
        self.att = blocks.ESA()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(x)
        out2 = self.conv2(out1)
        out3 = self.conv3(out2)
        cat = ops.cat([ops.conv(b, v, padding=0) for b, v in zip(self.branch, (x, out1, out2, out3))])
        return self.att(ops.conv(self.fuse, cat, padding=0)) + x


class EFDN(nn.Module):
    """JAX ``efdn_apply``; NHWC in, NHWC out."""

    def __init__(self, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.head = Layer()
        self.cells = nn.ModuleList([Cell() for _ in range(4)])
        self.local_fuse = nn.ModuleList([Layer() for _ in range(3)])
        self.tail = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out0 = ops.conv(self.head, ops.from_nhwc(x))
        fuse = self.local_fuse
        out1 = self.cells[0](out0)
        out2 = self.cells[1](out1)
        out3 = self.cells[2](ops.conv(fuse[0], ops.cat([out1, out2]), padding=0))
        out4 = self.cells[3](ops.conv(fuse[1], ops.cat([out2, out3]), padding=0))
        out = ops.conv(fuse[2], ops.cat([out2, out4]), padding=0) + out0
        return blocks.upsample(self.tail, out, self.upscale).clamp(0.0, 1.0)
