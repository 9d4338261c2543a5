"""NASNetBN, team28 (counterpart of ``ntire2022_esr_tpu/models/nasnetbn.py``;
model 28).

A NAS-searched SRResNet: each of the 16 trunk layers is the block its
``ARCH_LIST`` entry picks, an inverted residual (1x1, depthwise 3x3, 1x1,
each with an inference-mode BatchNorm; expansion 3 or 6), a residual block
with BatchNorm, or its LeakyReLU variant. The tail grows the image by two
3x3 convs to 4 * 32 channels + PixelShuffle(2), the tail kernel at r = 2
under every tier (``ops.fused.conv_pixelshuffle``), then ``HRconv``, all
inside ``config.hr_tail_scope("nasnetbn")`` (``fast`` under ``high`` and
``mixed``); ``conv_last`` and the global bilinear x4 residual of the LR
input run outside it, at the active tier. Widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import config, ops
from ntire2022_esr_tpu_torch.models.blocks import Layer
from ntire2022_esr_tpu_torch.ops.fused import conv_pixelshuffle

ARCH_LIST = (3, 1, 2, 3, 3, 0, 1, 2, 0, 0, 0, 0, 2, 3, 3, 1)
BN = ("weight", "bias", "running_mean", "running_var")


class InvertedResidual(nn.Module):
    """JAX ``_inverted_residual``: 1x1-BN-ReLU6, depthwise 3x3-BN-ReLU6,
    1x1-BN, + x. The convs have no bias."""

    def __init__(self):
        super().__init__()
        w = ("weight",)
        self.conv = nn.Sequential(Layer(w), Layer(BN), nn.Identity(), Layer(w), Layer(BN),
                                  nn.Identity(), Layer(w), Layer(BN))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        h = ops.relu6(ops.batch_norm(c[1], ops.conv(c[0], x, padding=0)))
        h = ops.relu6(ops.batch_norm(c[4], ops.conv(c[3], h, groups=h.shape[1])))
        return x + ops.batch_norm(c[7], ops.conv(c[6], h, padding=0))


class ResidualBlockBN(nn.Module):
    """JAX ``_res_bn`` (``leaky=False``) and ``_res_leaky_bn``: conv-BN-act,
    conv-BN, + x."""

    def __init__(self, leaky: bool):
        super().__init__()
        self.leaky = leaky
        self.conv1, self.bn1 = Layer(), Layer(BN)
        self.conv2, self.bn2 = Layer(), Layer(BN)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = ops.batch_norm(self.bn1, ops.conv(self.conv1, x))
        out = ops.leaky_relu(out, 0.2) if self.leaky else ops.relu(out)
        return x + ops.batch_norm(self.bn2, ops.conv(self.conv2, out))


class NASNetBN(nn.Module):
    """JAX ``nasnetbn_apply``: :meth:`nasnetbn_body` (LR domain) and
    :meth:`nasnetbn_tail` (the HR tail, which reads the LR input for the
    residual), the seam JAX's stage-split runner dispatches at. NHWC in,
    NHWC out."""

    def __init__(self, arch_list=ARCH_LIST, upscale: int = 4, slope: float = 0.1):
        super().__init__()
        self.upscale, self.slope = upscale, slope
        self.conv_first = Layer()
        self.recon_trunk = nn.Sequential(*[
            InvertedResidual() if idx in (0, 1) else ResidualBlockBN(leaky=idx == 3)
            for idx in arch_list])
        for name in ("upconv1", "upconv2", "HRconv", "conv_last"):
            self.add_module(name, Layer())

    def nasnetbn_body(self, x: torch.Tensor) -> torch.Tensor:
        """conv_first + LeakyReLU, then the NAS trunk."""
        return self.recon_trunk(ops.leaky_relu(ops.conv(self.conv_first, x), self.slope))

    def nasnetbn_tail(self, h: torch.Tensor, x_lr: torch.Tensor) -> torch.Tensor:
        """Two conv + PixelShuffle(2) steps and HRconv inside the HR-tail
        scope; conv_last and the global bilinear residual (which stays at
        the active tier: it carries the base image) outside it."""
        s = self.slope
        with config.hr_tail_scope("nasnetbn"):
            for up in (self.upconv1, self.upconv2):
                h = ops.leaky_relu(conv_pixelshuffle(h, up.weight, up.bias, 2,
                                                     ops.nn.weight_scale(up)), s)
            h2 = ops.leaky_relu(ops.conv(self.HRconv, h), s)
        out = ops.conv(self.conv_last, h2)
        return out + ops.interpolate(x_lr, scale_factor=self.upscale, mode="bilinear")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.from_nhwc(x)
        return ops.to_nhwc(self.nasnetbn_tail(self.nasnetbn_body(x), x))
