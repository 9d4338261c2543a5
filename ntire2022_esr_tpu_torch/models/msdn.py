"""MSDN, team44 (counterpart of ``ntire2022_esr_tpu/models/msdn.py``; model
44).

Multi-scale distillation blocks (grouped and dilated convs, SiLU), each
gated by a large-kernel VisionAttention: a depthwise k7 d3 and a k5 conv
and a 1x1 on a max-pooled map, bilinear back up. The input is scaled by 255
on the way in and the output by 1/255 on the way out. On stock ops but the
x4 upsampler, which runs as the tail kernel (``blocks.conv_shuffle``);
widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer


def _cb() -> nn.Sequential:
    """conv_block(act='silu') = Sequential(conv, SiLU)."""
    return nn.Sequential(Layer())


def _apply_cb(p: nn.Sequential, x: torch.Tensor, **kw) -> torch.Tensor:
    return ops.silu(ops.conv(p[0], x, **kw))


class VisionAttention(nn.Module):
    """JAX ``_vision_attention``."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale
        self.head = Layer()
        self.LKA = nn.Sequential(Layer(), Layer(), Layer())
        self.tail = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.scale
        c1 = ops.conv(self.head, x, padding=0)
        c2 = ops.gelu(ops.max_pool2d(c1, 2 * s + 1, s))
        f = c2.shape[1]
        c2 = ops.conv(self.LKA[0], c2, dilation=3, groups=f)   # k7 d3 depthwise
        c2 = ops.conv(self.LKA[1], c2, groups=f)               # k5 depthwise
        c2 = ops.conv(self.LKA[2], c2, padding=0)
        c3 = ops.interpolate(c2, size=(x.shape[2], x.shape[3]), mode="bilinear")
        return x * ops.sigmoid(ops.conv(self.tail, c3 + c1, padding=0))


class MSDB(nn.Module):
    """JAX ``_msdb``."""

    def __init__(self, scale: int):
        super().__init__()
        self.c1_d = _cb()
        self.c1_r = nn.Sequential(_cb(), _cb())
        self.c2_d = _cb()
        self.c2_r = _cb()
        self.c3 = _cb()
        self.c4 = Layer()
        self.attention = VisionAttention(scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = _apply_cb(self.c1_d, x, padding=0)
        r1 = _apply_cb(self.c1_r[0], x, padding=0)
        r1 = _apply_cb(self.c1_r[1], r1, groups=2)
        d2 = _apply_cb(self.c2_d, r1, padding=0)
        r2 = _apply_cb(self.c2_r, r1)
        r3 = _apply_cb(self.c3, r2, dilation=2)
        return self.attention(ops.conv(self.c4, ops.cat([d1, d2, r3]), padding=0))


class MSDN(nn.Module):
    """JAX ``msdn_apply``; NHWC in, NHWC out."""

    def __init__(self, num_modules: int = 3, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.fea_conv = Layer()
        self.B = nn.Sequential(*[MSDB(num_modules - i + 1) for i in range(num_modules)])
        self.C = nn.Sequential(_cb(), Layer())
        self.upsampler = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = ops.conv(self.fea_conv, ops.from_nhwc(x) * 255.0)
        h, outs = fea, []
        for block in self.B:
            h = block(h)
            outs.append(h)
        hc = _apply_cb(self.C[0], ops.cat(outs), padding=0)
        hc = ops.conv(self.C[1], hc) + fea
        return blocks.upsample(self.upsampler, hc, self.upscale) / 255.0
