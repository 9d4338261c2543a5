"""IMDTN, team09 (counterpart of ``ntire2022_esr_tpu/models/imdtn.py``;
model 09).

Three IMDT blocks: grouped (groups=4) distillation convs with a channel
shuffle, and a SwinIR residual Swin block (window 6, 2 heads, pre-norm,
a relative-position bias and shift masks). The input is flip-padded by 1
to 6 rows and columns (never 0) and the x4 output cropped back. The
grouped convs keep the stock layout (the JAX zoo densifies them at load
for the TPU's matrix unit, the same sums in another order). On stock ops;
widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models.blocks import Layer
from ntire2022_esr_tpu_torch.models.swin import SwinBlock

SLOPE = 0.05


class RSTB(nn.Module):
    """JAX ``_rstb``: the Swin blocks on the NHWC tokens, + x."""

    def __init__(self, num_heads: int = 2, ws: int = 6, depth: int = 2):
        super().__init__()
        self.residual_group = nn.Module()
        self.residual_group.blocks = nn.ModuleList([
            SwinBlock(num_heads, ws, 0 if i % 2 == 0 else ws // 2, pre_norm=True, site="imdtn")
            for i in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.permute(0, 2, 3, 1)
        for blk in self.residual_group.blocks:
            t = blk(t)
        return t.permute(0, 3, 1, 2) + x


class IMDTB(nn.Module):
    """JAX ``_imdtb``. The reference's LeakyReLU works in place, so each
    residual add sees the activated tensor: ``a2 = lrelu(shuffle(c2(r1) +
    a1))``."""

    def __init__(self):
        super().__init__()
        for name in ("c1", "c2", "c3", "c4"):
            self.add_module(name, Layer())
        self.transformer = RSTB()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dc = x.shape[1] // 4
        a, parts, r = x, [], x
        for c in (self.c1, self.c2, self.c3):
            a = ops.leaky_relu(ops.channel_shuffle(ops.conv(c, r, groups=4) + a, 4), SLOPE)
            parts.append(a[:, :dc])
            r = a[:, dc:]
        parts.append(ops.conv(self.c4, r))
        return self.transformer(ops.cat(parts)) + x


class IMDTN(nn.Module):
    """JAX ``imdtn_apply``: :meth:`imdtn_body` (flip-pad, the LR trunk) and
    :meth:`imdtn_tail` (upsampler, x4 shuffle, crop), the seam JAX's stage-split
    runner dispatches at. NHWC in, NHWC out."""

    def __init__(self, num_modules: int = 3, upscale: int = 4):
        super().__init__()
        self.num_modules, self.upscale = num_modules, upscale
        self.fea_conv = Layer()
        for i in range(1, num_modules + 1):
            self.add_module(f"IMDTB{i}", IMDTB())
        self.c = nn.Sequential(Layer())
        self.LR_conv = Layer()
        self.upsampler = nn.Sequential(Layer())

    def imdtn_body(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        h_pad, w_pad = (h // 6 + 1) * 6 - h, (w // 6 + 1) * 6 - w
        x = torch.cat([x, x.flip(2)], dim=2)[:, :, :h + h_pad]
        x = torch.cat([x, x.flip(3)], dim=3)[:, :, :, :w + w_pad]
        fea = ops.conv(self.fea_conv, x.contiguous(memory_format=ops.nn.CL))
        h, outs = fea, []
        for i in range(1, self.num_modules + 1):
            h = getattr(self, f"IMDTB{i}")(h)
            outs.append(h)
        h = ops.leaky_relu(ops.conv(self.c[0], ops.cat(outs), padding=0), SLOPE)
        return ops.conv(self.LR_conv, h) + fea

    def imdtn_tail(self, h: torch.Tensor, x_lr: torch.Tensor) -> torch.Tensor:
        """NHWC out, cropped to ``upscale`` times the unpadded ``x_lr``."""
        out = ops.pixel_shuffle(ops.conv(self.upsampler[0], h), self.upscale)
        return ops.to_nhwc(out[:, :, :x_lr.shape[2] * 4, :x_lr.shape[3] * 4])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.from_nhwc(x)
        return self.imdtn_tail(self.imdtn_body(x), x)
