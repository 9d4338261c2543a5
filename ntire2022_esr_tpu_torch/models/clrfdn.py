"""CLRFDN, team29 (counterpart of ``ntire2022_esr_tpu/models/clrfdn.py``;
model 29).

Contrastive-loss RFDN in deploy form: the cache ships the collapsed Conv3X3
weights (under a ``conv3x3`` sub-layer), SiLU activations, no residual adds
in the distillation chain, no LR_conv (the fused features plus ``fea`` go
straight to the upsampler), a PReLU on the fusion conv. The reference
applies SiLU twice to ``c4``'s output; so does this. On stock ops but the
x4 upsampler, which runs as the tail kernel (``blocks.conv_shuffle``);
widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer


class RFDB29(nn.Module):
    """JAX ``_rfdb29``."""

    def __init__(self):
        super().__init__()
        for i in (1, 2, 3):
            self.add_module(f"c{i}_d", Layer())
            self.add_module(f"c{i}_r", blocks.wrapped("conv3x3"))
        self.c4 = blocks.wrapped("conv3x3")
        self.c5 = Layer()
        self.esa = blocks.ESA()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, distilled = x, []
        for i in (1, 2, 3):
            distilled.append(ops.silu(ops.conv(getattr(self, f"c{i}_d"), h, padding=0)))
            h = ops.silu(ops.conv(getattr(self, f"c{i}_r").conv3x3, h))
        r4 = ops.silu(ops.silu(ops.conv(self.c4.conv3x3, h)))
        return self.esa(ops.conv(self.c5, ops.cat(distilled + [r4]), padding=0))


class CLRFDN(nn.Module):
    """JAX ``clrfdn_apply``; NHWC in, NHWC out."""

    def __init__(self, num_modules: int = 4, upscale: int = 4):
        super().__init__()
        self.num_modules, self.upscale = num_modules, upscale
        self.fea_conv = blocks.wrapped("conv3x3")
        for i in range(1, num_modules + 1):
            self.add_module(f"B{i}", RFDB29())
        self.c = nn.Sequential(Layer(), Layer(("weight",)))
        self.upsampler = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = ops.conv(self.fea_conv.conv3x3, ops.from_nhwc(x))
        h, outs = fea, []
        for i in range(1, self.num_modules + 1):
            h = getattr(self, f"B{i}")(h)
            outs.append(h)
        h = ops.conv(self.c[0], ops.cat(outs), padding=0)
        h = ops.prelu(h, self.c[1].weight) + fea
        return blocks.upsample(self.upsampler, h, self.upscale)
