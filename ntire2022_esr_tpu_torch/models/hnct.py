"""HNCT, team12 (counterpart of ``ntire2022_esr_tpu/models/hnct.py``;
model 12).

The RFDN skeleton around four hybrid blocks: a spatial attention (a 7x7
conv on the channel mean and max, sigmoid), a two-block Swin layer (5
heads, window 8, the second block shifted by 4; reflect-padded to a
multiple of 8, a LayerNorm patch embed, no norms in the blocks; cropped
back), a 3x3 conv and an ESA. On stock ops; widths from the weight cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer
from ntire2022_esr_tpu_torch.models.swin import SwinBlock

# the reference's private attribute, as Python mangled its name
_SA_LAYER = "_Spartial_Attention__layer"


class SpartialAttention(nn.Module):
    """x times sigmoid of a 7x7 conv of the channel mean and max."""

    def __init__(self):
        super().__init__()
        self.add_module(_SA_LAYER, nn.Sequential(Layer()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(1, keepdim=True, dtype=torch.float32).to(x.dtype)
        mx = x.amax(1, keepdim=True)
        layer = getattr(self, _SA_LAYER)[0]
        return x * ops.sigmoid(ops.conv(layer, ops.cat([avg, mx])))


class SwinLayer(nn.Module):
    def __init__(self, num_heads: int, ws: int, depth: int):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.norm = Layer()
        self.blocks = nn.ModuleList([
            SwinBlock(num_heads, ws, 0 if i % 2 == 0 else ws // 2, site="hnct")
            for i in range(depth)])


class SwinT(nn.Module):
    """JAX ``_swin_t``: reflect-pad to a multiple of ``ws``, LayerNorm,
    the blocks, crop back. NCHW (channels_last) in and out."""

    def __init__(self, num_heads: int = 5, ws: int = 8, depth: int = 2):
        super().__init__()
        self.ws = ws
        self.transformer_body = nn.Sequential(SwinLayer(num_heads, ws, depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        ws = self.ws
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
        layer = self.transformer_body[0]
        t = ops.layer_norm(layer.patch_embed.norm, x.permute(0, 2, 3, 1))
        for blk in layer.blocks:
            t = blk(t)
        return t[:, :h, :w].permute(0, 3, 1, 2).contiguous(memory_format=ops.nn.CL)


class STB(nn.Module):
    """JAX ``_stb``: spatial attention, Swin layer, 3x3 conv, ESA."""

    def __init__(self):
        super().__init__()
        self.sparatt = SpartialAttention()
        self.swinT = SwinT()
        self.c1_r = Layer()
        self.esa = blocks.ESA()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.esa(ops.conv(self.c1_r, self.swinT(self.sparatt(x))))


def HNCT() -> nn.Module:
    """JAX ``hnct_apply``: the RFDN skeleton with four :class:`STB` blocks."""
    return blocks.RFDNSkeleton(STB)
