"""AFDN, team15 (counterpart of ``ntire2022_esr_tpu/models/afdn.py``;
model 15).

The RFDN skeleton whose blocks end in ATB instead of ESA: the features
split in half, each half gated by sigmoid(conv(LeakyReLU(conv(.)))). The
blocks' convs carry no bias. On stock ops but the x4 upsampler, which runs
as the tail kernel (``blocks.conv_shuffle``); widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer

SLOPE = 0.05
W = ("weight",)


class ATB(nn.Module):
    """JAX ``_atb``: the upper half through ATB_11 and ATB_12, the lower
    through ATB_22 and ATB_21."""

    def __init__(self):
        super().__init__()
        for name in ("ATB_11", "ATB_12", "ATB_21", "ATB_22"):
            self.add_module(name, Layer())

    def _gate(self, x: torch.Tensor, a: Layer, b: Layer) -> torch.Tensor:
        return x * ops.sigmoid(ops.conv(b, ops.leaky_relu(ops.conv(a, x), 0.1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = x.shape[1] // 2
        up, down = x[:, :half], x[:, half:]
        return ops.cat([self._gate(up, self.ATB_11, self.ATB_12),
                        self._gate(down, self.ATB_22, self.ATB_21)])


class AFDB(nn.Module):
    """JAX ``_afdb``."""

    def __init__(self):
        super().__init__()
        for i in (1, 2, 3):
            self.add_module(f"c{i}_d", Layer(W))
            self.add_module(f"c{i}_r", Layer(W))
        self.c4 = Layer(W)
        self.c5 = Layer(W)
        self.ATB = ATB()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, distilled = x, []
        for i in (1, 2, 3):
            distilled.append(blocks.conv_lrelu(getattr(self, f"c{i}_d"), h, SLOPE, padding=0))
            h = ops.leaky_relu(ops.conv(getattr(self, f"c{i}_r"), h) + h, SLOPE)
        r4 = blocks.conv_lrelu(self.c4, h, SLOPE)
        return self.ATB(ops.conv(self.c5, ops.cat(distilled + [r4]), padding=0))


class AFDN(blocks.RFDNSkeleton):
    """JAX ``afdn_apply``: the RFDN skeleton over four AFDBs, with
    bias-free ``fea_conv``, ``LR_conv`` and upsampler."""

    def __init__(self):
        super().__init__(AFDB)
        self.fea_conv = Layer(W)
        self.LR_conv = Layer(W)
        self.upsampler = nn.Sequential(Layer(W))
