"""RLFN_cut, team04's NTIRE 2022 runtime-track winner (counterpart of ``ntire2022_esr_tpu/models/rlfn.py``).

Four RLFBs (3x conv3x3 + LeakyReLU(0.05) chain + residual, 1x1, trimmed
ESA) in an RFDN-style skeleton. Submodule names are the weight cache's
keys (``fea_conv``, ``B1.c1_r``, ..., ``upsampler.0``), so the cache
loads with ``load_state_dict``.

The RLFB body always runs through ``fused_conv3x3_chain`` and the
upsampler through ``fused_conv3x3_pixelshuffle``: on the card those are
the hand-written CUDA kernels, on the CPU their plain PyTorch versions.
Under w8 both take the int8 weights with their scales.
``forward`` takes and returns NHWC tensors; inside, activations are
channels_last NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.ops.kernels import fused_conv3x3_chain, fused_conv3x3_pixelshuffle


class ESA(nn.Module):
    """Trimmed ESA (JAX ``esa_rlfn``): conv_max and conv3_ removed."""

    def __init__(self, n_feats: int, esa_channels: int = 16):
        super().__init__()
        f = esa_channels
        self.conv1 = nn.Conv2d(n_feats, f, 1)
        self.conv_f = nn.Conv2d(f, f, 1)
        self.conv2 = nn.Conv2d(f, f, 3, stride=2, padding=0)
        self.conv3 = nn.Conv2d(f, f, 3, padding=1)
        self.conv4 = nn.Conv2d(f, n_feats, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1_ = ops.conv(self.conv1, x, padding=0)
        c1 = ops.conv(self.conv2, c1_, stride=2, padding=0)
        v_max = ops.max_pool2d(c1, 7, 3)
        c3 = ops.conv(self.conv3, v_max)
        c3 = ops.interpolate(c3, size=(x.shape[2], x.shape[3]), mode="bilinear")
        cf = ops.conv(self.conv_f, c1_, padding=0)
        c4 = ops.conv(self.conv4, c3 + cf, padding=0)
        return x * ops.sigmoid(c4)


class RLFB(nn.Module):
    """Residual local feature block (JAX ``rlfb``)."""

    def __init__(self, in_channels: int, mid_channels: int, esa_channels: int = 16,
                 slope: float = 0.05):
        super().__init__()
        self.slope = slope
        self.c1_r = nn.Conv2d(in_channels, mid_channels, 3, padding=1)
        self.c2_r = nn.Conv2d(mid_channels, mid_channels, 3, padding=1)
        self.c3_r = nn.Conv2d(mid_channels, in_channels, 3, padding=1)
        self.c5 = nn.Conv2d(in_channels, in_channels, 1)
        self.esa = ESA(in_channels, esa_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = (self.c1_r, self.c2_r, self.c3_r)
        out = fused_conv3x3_chain(x, [c.weight for c in convs], [c.bias for c in convs],
                                  slope=self.slope, residual=True,
                                  scales=[ops.nn.weight_scale(c) for c in convs])
        return self.esa(ops.conv(self.c5, out, padding=0))


class RLFN(nn.Module):
    """RLFN_cut x4 (JAX ``rlfn_apply``); NHWC in, NHWC out."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, feature_channels: int = 46,
                 mid_channels: int = 48, num_modules: int = 4, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.num_modules = num_modules
        self.fea_conv = nn.Conv2d(in_channels, feature_channels, 3, padding=1)
        for i in range(1, num_modules + 1):
            self.add_module(f"B{i}", RLFB(feature_channels, mid_channels))
        self.LR_conv = nn.Conv2d(feature_channels, feature_channels, 3, padding=1)
        self.upsampler = nn.Sequential(
            nn.Conv2d(feature_channels, out_channels * upscale * upscale, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.from_nhwc(x)
        fea = ops.conv(self.fea_conv, x)
        h = fea
        for i in range(1, self.num_modules + 1):
            h = getattr(self, f"B{i}")(h)
        h = ops.conv(self.LR_conv, h) + fea
        up = blocks.seq(self.upsampler, 0)
        return ops.to_nhwc(fused_conv3x3_pixelshuffle(h, up.weight, up.bias, r=self.upscale,
                                                      scale=ops.nn.weight_scale(up)))
