"""FMEN, team03's runtime-track second (counterpart of
``ntire2022_esr_tpu/models/fmen.py``; model 03).

The deploy form (re-parameterized) plain net: head conv, a warm-up conv
and HFAB, four BasicBlock + HFAB pairs, ``lr_conv`` and the long skip,
then the pixel-shuffle tail. One LeakyReLU(0.1) throughout. On stock ops;
widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer

SLOPE = 0.1


class _RepConv(nn.Module):
    """A re-parameterized conv under the cache name ``rep_conv``."""

    def __init__(self):
        super().__init__()
        self.rep_conv = Layer()


class BasicBlock(nn.Module):
    """RepConv, LeakyReLU, RepConv (JAX ``_basic_block``)."""

    def __init__(self):
        super().__init__()
        self.conv1 = _RepConv()
        self.conv2 = _RepConv()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ops.leaky_relu(ops.conv(self.conv1.rep_conv, x), SLOPE)
        return ops.conv(self.conv2.rep_conv, h)


class HFAB(nn.Module):
    """Squeeze, BasicBlocks, excite, sigmoid gate on x (JAX ``_hfab``)."""

    def __init__(self, up_blocks: int):
        super().__init__()
        self.squeeze = Layer()
        self.convs = nn.ModuleList([BasicBlock() for _ in range(up_blocks)])
        self.excitate = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = ops.leaky_relu(ops.conv(self.squeeze, x), SLOPE)
        for block in self.convs:
            out = block(out)
        out = ops.conv(self.excitate, ops.leaky_relu(out, SLOPE))
        return ops.sigmoid(out) * x


class FMEN(nn.Module):
    """JAX ``fmen_apply``; NHWC in, NHWC out."""

    def __init__(self, down_blocks: int = 4, up_blocks=(2, 1, 1, 1, 1), upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.head = Layer()
        self.warmup = nn.Sequential(Layer(), HFAB(up_blocks[0]))
        self.basic_blocks = nn.ModuleList([BasicBlock() for _ in range(down_blocks)])
        self.hfabs = nn.ModuleList([HFAB(up_blocks[i + 1]) for i in range(down_blocks)])
        self.lr_conv = Layer()
        self.tail = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = ops.conv(self.head, ops.from_nhwc(x))
        h = self.warmup[1](ops.conv(self.warmup[0], h0))
        for block, hfab in zip(self.basic_blocks, self.hfabs):
            h = hfab(block(h))
        h = ops.conv(self.lr_conv, h) + h0
        return blocks.upsample(self.tail, h, self.upscale)
