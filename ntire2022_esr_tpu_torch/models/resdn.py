"""ResDN, team43 (counterpart of ``ntire2022_esr_tpu/models/resdn.py``;
model 43).

Expansion/compression blocks (a PReLU then a 1x1 up, a PReLU then a 3x3
down) that hand distilled features on to the later stages of the block, a
top-down fusion pyramid (``T_tdm``/``L_tdm``), and MeanShift in and out as
1x1 convs whose frozen weights are in the cache. On stock ops but the x4
upsampler, which runs as the tail kernel (``blocks.conv_shuffle``); widths
from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer


def _prelu_conv() -> nn.Sequential:
    """Sequential(PReLU, Conv2d)."""
    return nn.Sequential(Layer(("weight",)), Layer())


def _apply_prelu_conv(p: nn.Sequential, x: torch.Tensor, **kw) -> torch.Tensor:
    return ops.conv(p[1], ops.prelu(x, p[0].weight), **kw)


class ResDB(nn.Module):
    """JAX ``_resdb``: three expansion/compression stages, each splitting
    distilled channels off its expansion, a 1x1 tail over the last state
    and the distilled parts, an ESA, + x."""

    def __init__(self, n_feats: int = 48, n_dist: int = 16):
        super().__init__()
        self.n_feats, self.n_dist = n_feats, n_dist
        for i in (1, 2, 3):
            self.add_module(f"expansion{i}", _prelu_conv())
            self.add_module(f"compression{i}", _prelu_conv())
        self.conv_tail = _prelu_conv()
        self.attention = blocks.ESA()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f, d = self.n_feats, self.n_dist
        inp = x
        res = _apply_prelu_conv(self.expansion1, x, padding=0)
        res, d11, d12, d13 = (res[:, :f], res[:, f:f + d], res[:, f + d:f + 2 * d],
                              res[:, f + 2 * d:])
        x = x + _apply_prelu_conv(self.compression1, res)
        res = _apply_prelu_conv(self.expansion2, ops.cat([x, d11]), padding=0)
        res, d21, d22 = res[:, :f], res[:, f:f + d], res[:, f + d:]
        x = x + _apply_prelu_conv(self.compression2, res)
        res = _apply_prelu_conv(self.expansion3, ops.cat([x, d12, d21]), padding=0)
        res, d31 = res[:, :f], res[:, f:]
        x = x + _apply_prelu_conv(self.compression3, res)
        res = _apply_prelu_conv(self.conv_tail, ops.cat([x, d13, d22, d31]), padding=0)
        return self.attention(res) + inp


class ResDN(nn.Module):
    """JAX ``resdn_apply``; NHWC in, NHWC out."""

    def __init__(self, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.sub_mean = Layer()
        self.add_mean = Layer()
        self.fea_conv = Layer()
        for i in (1, 2, 3, 4):
            self.add_module(f"body_unit{i}", ResDB())
        for i in (1, 2, 3):
            self.add_module(f"T_tdm{i}", nn.Sequential(Layer()))
            self.add_module(f"L_tdm{i}", nn.Sequential(Layer()))
        self.tail = nn.Sequential(Layer(), Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def relu_1x1(p, v):
            return ops.relu(ops.conv(p[0], v, padding=0))

        x = ops.conv(self.sub_mean, ops.from_nhwc(x), padding=0)
        x = ops.conv(self.fea_conv, x)
        r = [x]
        for i in (1, 2, 3, 4):
            r.append(getattr(self, f"body_unit{i}")(r[-1]))
        t = r[4]
        for i in (1, 2, 3):
            t = ops.cat([relu_1x1(getattr(self, f"T_tdm{i}"), t),
                         relu_1x1(getattr(self, f"L_tdm{i}"), r[4 - i])])
        out = blocks.conv_shuffle(self.tail[1], ops.conv(self.tail[0], t + x), self.upscale)
        return ops.to_nhwc(ops.conv(self.add_mean, out, padding=0))
