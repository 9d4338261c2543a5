"""BSRN, team18's params/FLOPs-track winner (counterpart of
``ntire2022_esr_tpu/models/bsrn.py``; model 18, "18_RFDNFINALB5").

Blueprint-separable convs: every BSConvU is a pointwise linear over the
channels (the cache stores its weight (in, out), ``ops.linear``) and then a
depthwise 3x3; GELU activations; learned channel weights ``cw`` (a raw
parameter of each block); the input replicated 4x along the channels; an
ESA with linears for its 1x1s and GELU for ReLU. On stock ops but the x4
upsampler, which runs as the tail kernel (``blocks.conv_shuffle``); widths
from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer


class BSConv(nn.Module):
    """BSConvU: linear ``pw``, then the depthwise 3x3 ``dw``."""

    def __init__(self):
        super().__init__()
        self.pw = Layer()
        self.dw = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ops.linear(self.pw, x)
        return ops.conv(self.dw, h, groups=h.shape[1])


class ESA18(nn.Module):
    """JAX ``_esa18``."""

    def __init__(self):
        super().__init__()
        for name in ("conv1", "conv_f", "conv2", "conv4"):
            self.add_module(name, Layer())
        for name in ("conv_max", "conv3", "conv3_"):
            self.add_module(name, BSConv())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1_ = ops.linear(self.conv1, x)
        c1 = ops.conv(self.conv2, c1_, stride=2, padding=0)
        v_max = ops.max_pool2d(c1, 7, 3)
        c3 = ops.gelu(self.conv3(ops.gelu(self.conv_max(v_max))))
        c3 = ops.interpolate(self.conv3_(c3), size=(x.shape[2], x.shape[3]), mode="bilinear")
        cf = ops.linear(self.conv_f, c1_)
        return x * ops.sigmoid(ops.linear(self.conv4, c3 + cf))


class RFDB18(Layer):
    """JAX ``_rfdb18``; its own parameter is ``cw``, the channel weights."""

    def __init__(self):
        super().__init__(("cw",))
        for i in (1, 2, 3):
            self.add_module(f"c{i}_d", Layer())
            self.add_module(f"c{i}_r", BSConv())
        self.c4 = BSConv()
        self.c5 = Layer()
        self.esa = ESA18()
        self.conv_out = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, distilled = x, []
        for i in (1, 2, 3):
            distilled.append(ops.gelu(ops.linear(getattr(self, f"c{i}_d"), h)))
            h = ops.gelu(getattr(self, f"c{i}_r")(h) + h)
        r4 = ops.gelu(self.c4(h))
        out = self.esa(ops.linear(self.c5, ops.cat(distilled + [r4])))
        # an f32 (C,) weight: the product is f32 under every tier, as in JAX
        out = out * self.cw[0].reshape(1, -1, 1, 1)
        return ops.linear(self.conv_out, out) + x


class BSRN(nn.Module):
    """JAX ``bsrn_apply``; NHWC in, NHWC out."""

    def __init__(self, num_block: int = 5, upscale: int = 4):
        super().__init__()
        self.num_block, self.upscale = num_block, upscale
        self.fea_conv = BSConv()
        for i in range(1, num_block + 1):
            self.add_module(f"B{i}", RFDB18())
        self.c1 = Layer()
        self.c2 = BSConv()
        self.upsampler = nn.Module()
        self.upsampler.upsampleOneStep = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.from_nhwc(x)
        fea = self.fea_conv(ops.cat([x, x, x, x]))
        h, outs = fea, []
        for i in range(1, self.num_block + 1):
            h = getattr(self, f"B{i}")(h)
            outs.append(h)
        out_b = ops.gelu(ops.linear(self.c1, ops.cat(outs)))
        out_lr = self.c2(out_b) + fea
        return blocks.upsample(self.upsampler.upsampleOneStep, out_lr, self.upscale)
