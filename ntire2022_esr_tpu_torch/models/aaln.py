"""AALN, team11 (counterpart of ``ntire2022_esr_tpu/models/aaln.py``; model
11).

Dual-scale attention blocks (DSAB1, then a depthwise light attention),
NCA contrast channel attention on a biased spatial standard deviation,
mean shift in and out as 1x1 convs whose frozen weights are in the cache,
and a global bicubic x4 residual of the mean-shifted input. On stock ops;
widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models.blocks import Layer

W = ("weight",)


def _stdv_biased(x: torch.Tensor) -> torch.Tensor:
    """JAX ``_stdv_biased``: f32 statistics under f16 (``(x - mean) ** 2``
    of activations at data range 255 overflows f16), the tensor's own dtype
    otherwise."""
    return ops.nn.spatial_std(x, 0, torch.float32 if x.dtype == torch.float16 else x.dtype)


def _conv_prelu(p: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    return ops.prelu(ops.conv(p[0], x), p[1].weight)


class NCA(nn.Module):
    """JAX ``_nca``: ReLU'd 1x1s of the global mean and of the standard
    deviation, summed, 1x1, sigmoid gate. ``upper_branch.0`` is the pool."""

    def __init__(self):
        super().__init__()
        self.upper_branch = nn.Sequential(nn.Identity(), Layer())
        self.lower_branch = nn.Sequential(Layer())
        self.fuse = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        upper = ops.relu(ops.conv(self.upper_branch[1], ops.global_avg_pool(x), padding=0))
        lower = ops.relu(ops.conv(self.lower_branch[0], _stdv_biased(x), padding=0))
        return ops.sigmoid(ops.conv(self.fuse[0], upper + lower, padding=0)) * x


class DSAB1(nn.Module):
    """JAX ``_dsab1``."""

    def __init__(self):
        super().__init__()
        self.conv_3 = nn.Sequential(Layer(), Layer(W))
        self.conv_5 = nn.Sequential(Layer(), Layer(W))
        self.att = NCA()
        self.conv_1 = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o3 = _conv_prelu(self.conv_3, x)
        o5 = _conv_prelu(self.conv_5, o3)
        return ops.conv(self.conv_1, self.att(ops.cat([o3, o5])), padding=0) + x


class LightSAAtt(nn.Module):
    """JAX ``_lightsaatt``: depthwise 3x3, PReLU, depthwise 3x3, sigmoid gate."""

    def __init__(self):
        super().__init__()
        self.d_conv = Layer()
        self.act = Layer(W)
        self.p_conv = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        h = ops.prelu(ops.conv(self.d_conv, x, groups=c), self.act.weight)
        return ops.sigmoid(ops.conv(self.p_conv, h, groups=c)) * x


class AttBlock(nn.Module):
    """JAX ``_att_block``."""

    def __init__(self):
        super().__init__()
        self.conv_block0 = DSAB1()
        self.conv_block1 = DSAB1()
        self.compress = Layer()
        self.att = LightSAAtt()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.conv_block0(x)
        out = ops.conv(self.compress, ops.cat([s, self.conv_block1(s)]), padding=0)
        return self.att(out) + x


class AALN(nn.Module):
    """JAX ``aaln_apply``; NHWC in, NHWC out."""

    def __init__(self, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.sub_mean = Layer()
        self.add_mean = Layer()
        self.input = nn.Sequential(Layer(), Layer(W), Layer(), Layer(W))
        for i in range(1, 5):
            self.add_module(f"B{i}", AttBlock())
        self.tail_conv = Layer()
        self.upsample = nn.Sequential(Layer(), Layer(W), Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.conv(self.sub_mean, ops.from_nhwc(x), padding=0)
        h = _conv_prelu(self.input[2:], _conv_prelu(self.input[:2], x))
        b, outs = h, []
        for i in range(1, 5):
            b = getattr(self, f"B{i}")(b)
            outs.append(b)
        lr = ops.conv(self.tail_conv, ops.cat(outs), padding=0) + h
        o = _conv_prelu(self.upsample[:2], lr)
        o = ops.pixel_shuffle(ops.conv(self.upsample[2], o, padding=0), self.upscale)
        sr = ops.conv(self.add_mean, o, padding=0)
        return ops.to_nhwc(sr + ops.interpolate(x, scale_factor=self.upscale, mode="bicubic"))
