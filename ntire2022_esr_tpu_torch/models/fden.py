"""FDEN, team17 (counterpart of ``ntire2022_esr_tpu/models/fden.py``; model
17).

The RFDN skeleton (blocks named ``IMDB1``..``IMDB4``) over FDEBs:
inverted-bottleneck residual branches (1x1 expand, LeakyReLU, 1x1, 3x3, +
input), bias-free distill convs, and a Laplacian-pyramid spatial attention
(LapSA) whose pyramid is max-pooled down and bilinearly resized up. On
stock ops but the x4 upsampler, which runs as the tail kernel
(``blocks.conv_shuffle``); widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer

SLOPE = 0.05


def _resize(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return ops.interpolate(x, size=(like.shape[2], like.shape[3]), mode="bilinear")


class LapSA(nn.Module):
    """JAX ``_lap_sa``."""

    def __init__(self):
        super().__init__()
        self.squeeze = Layer()
        for name in ("down1", "down2", "down3"):  # cache keys down*.1: a pool, then the conv
            self.add_module(name, nn.Sequential(nn.Identity(), Layer()))
        self.excite = Layer()
        self.fuse = Layer()

    @staticmethod
    def _down(p: nn.Sequential, h: torch.Tensor) -> torch.Tensor:
        return ops.relu(ops.conv(p[1], ops.max_pool2d(h, 2, 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = ops.relu(ops.conv(self.squeeze, x, padding=0))
        d1 = self._down(self.down1, s)
        h1 = s - _resize(d1, s)
        d2 = self._down(self.down2, d1)
        h2 = _resize(d1 - _resize(d2, d1), x)
        d3 = self._down(self.down3, d2)
        h3 = _resize(d2 - _resize(d3, d2), x)
        m = ops.sigmoid(ops.conv(self.excite, ops.cat([h1, h2, h3]), padding=0))
        return ops.conv(self.fuse, ops.cat([x * m, h1]), padding=0)


class FDEB(nn.Module):
    """JAX ``_fdeb``."""

    def __init__(self):
        super().__init__()
        for i in (1, 2, 3):
            self.add_module(f"c{i}_d", Layer(("weight",)))
            # 1x1 expand, LeakyReLU (no weights: key 1), 1x1, 3x3
            self.add_module(f"c{i}_r", nn.Sequential(Layer(), nn.Identity(), Layer(), Layer()))
        self.c4 = Layer()
        self.c5 = Layer()
        self.sa = LapSA()

    @staticmethod
    def _expand(p: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        h = blocks.conv_lrelu(p[0], x, SLOPE, padding=0)
        return ops.conv(p[3], ops.conv(p[2], h, padding=0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, distilled = x, []
        for i in (1, 2, 3):
            distilled.append(blocks.conv_lrelu(getattr(self, f"c{i}_d"), h, SLOPE, padding=0))
            h = self._expand(getattr(self, f"c{i}_r"), h) + h
        r4 = ops.conv(self.c4, h)
        return self.sa(ops.conv(self.c5, ops.cat(distilled + [r4]), padding=0))


def FDEN() -> blocks.RFDNSkeleton:
    """JAX ``fden_apply``: the RFDN skeleton over four FDEBs, named
    ``IMDB1``..``IMDB4`` as the cache names them."""
    return blocks.RFDNSkeleton(FDEB, prefix="IMDB")
