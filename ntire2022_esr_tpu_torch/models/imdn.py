"""IMDN baseline (counterpart of ``ntire2022_esr_tpu/models/imdn.py``; model ids -1, 26).

Head 3x3 conv -> shortcut(``nb`` IMD blocks + 3x3 conv) -> 3x3 conv to 48
channels + PixelShuffle(4), on stock ops but the x4 upsampler, which runs
as the tail kernel (``blocks.conv_shuffle``). The module tree mirrors the
torch ``Sequential`` naming of the weight cache: ``model.0`` (head),
``model.1.sub.{0..nb-1}`` (IMD blocks), ``model.1.sub.{nb}`` (body tail
conv), ``model.2`` (upsampling conv).
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks


class _Body(nn.Module):
    def __init__(self, nc: int, nb: int, slope: float):
        super().__init__()
        self.sub = nn.Sequential(*[blocks.IMDBlock(nc // 4, slope) for _ in range(nb)],
                                 blocks.Layer())


class IMDN(nn.Module):
    """JAX ``imdn_apply``; NHWC in, NHWC out."""

    def __init__(self, nc: int = 64, nb: int = 8, upscale: int = 4, negative_slope: float = 0.05):
        super().__init__()
        self.nb, self.upscale = nb, upscale
        self.model = nn.Sequential(blocks.Layer(), _Body(nc, nb, negative_slope), blocks.Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = ops.conv(self.model[0], ops.from_nhwc(x))
        sub = self.model[1].sub
        h = head
        for i in range(self.nb):
            h = sub[i](h)
        h = head + ops.conv(sub[self.nb], h)
        return ops.to_nhwc(blocks.conv_shuffle(self.model[2], h, self.upscale))
