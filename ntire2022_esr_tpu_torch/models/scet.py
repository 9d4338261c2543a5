"""SCET, team30 (counterpart of ``ntire2022_esr_tpu/models/scet.py``;
model 30).

A 3x3 conv, 16 self-calibrated SCPA blocks, one Restormer transformer block
(WithBias LayerNorm, MDTA channel attention with 8 heads, the gated
depthwise FFN), and two PixelShuffle(4) heads summed: one on the body's
output, one on the first conv's (recomputed in the tail from the input, as
the JAX package does). On stock ops but the two x4 upsamplers, which run as
the tail kernel (``blocks.conv_shuffle``); widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer
from ntire2022_esr_tpu_torch.ops import attention as attn_ops

SLOPE = 0.2
W = ("weight",)


class PAConv(nn.Module):
    def __init__(self):
        super().__init__()
        self.k2 = Layer()
        self.k3 = Layer(W)
        self.k4 = Layer(W)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ops.sigmoid(ops.conv(self.k2, x, padding=0))
        return ops.conv(self.k4, ops.conv(self.k3, x) * y)


class SCPA(nn.Module):
    """JAX ``_scpa``: a plain and a pixel-attention branch, a 1x1 over both, + x."""

    def __init__(self):
        super().__init__()
        self.conv1_a = Layer(W)
        self.conv1_b = Layer(W)
        self.k1 = nn.Sequential(Layer(W))
        self.PAConv = PAConv()
        self.conv3 = Layer(W)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = ops.leaky_relu(ops.conv(self.conv1_a, x, padding=0), SLOPE)
        b = ops.leaky_relu(ops.conv(self.conv1_b, x, padding=0), SLOPE)
        a = ops.leaky_relu(ops.conv(self.k1[0], a), SLOPE)
        b = ops.leaky_relu(self.PAConv(b), SLOPE)
        return ops.conv(self.conv3, ops.cat([a, b]), padding=0) + x


class WithBiasLayerNorm(nn.Module):
    """LayerNorm over channels (eps 1e-5) of an NCHW (channels_last) tensor."""

    def __init__(self):
        super().__init__()
        self.body = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = ops.layer_norm(self.body, x.permute(0, 2, 3, 1), eps=1e-5)
        return out.permute(0, 3, 1, 2).contiguous(memory_format=ops.nn.CL)


class MDTA(Layer):
    """The MDTA layers and its learned ``temperature`` (one per head)."""

    def __init__(self, num_heads: int):
        super().__init__(("temperature",))
        self.num_heads = num_heads
        self.qkv = Layer(W)
        self.qkv_dwconv = Layer(W)
        self.project_out = Layer(W)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return attn_ops.mdta_channel_attention(self, x, self.num_heads, self.temperature)


class GDFN(nn.Module):
    """JAX ``_gdfn``: 1x1, depthwise 3x3, ``gelu(x1) * x2``, 1x1."""

    def __init__(self):
        super().__init__()
        self.project_in = Layer(W)
        self.dwconv = Layer(W)
        self.project_out = Layer(W)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ops.conv(self.project_in, x, padding=0)
        h = ops.conv(self.dwconv, h, groups=h.shape[1])
        x1, x2 = h.chunk(2, dim=1)
        return ops.conv(self.project_out, ops.gelu(x1) * x2, padding=0)


class TransformerBlock(nn.Module):
    """JAX ``_transformer_block``."""

    def __init__(self, num_heads: int = 8):
        super().__init__()
        self.norm1 = WithBiasLayerNorm()
        self.attn = MDTA(num_heads)
        self.norm2 = WithBiasLayerNorm()
        self.ffn = GDFN()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


def _arr(mods) -> nn.Module:
    """The reference's wrapper that holds its blocks under ``arr``."""
    m = nn.Module()
    m.arr = nn.ModuleList(mods)
    return m


class SCET(nn.Module):
    """JAX ``scet_apply``: :meth:`scet_body` (LR domain) and
    :meth:`scet_tail` (both heads), the seam JAX's stage-split runner
    dispatches at. NHWC in, NHWC out."""

    def __init__(self, n_scpa: int = 16, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.conv3 = Layer()
        self.path1 = nn.ModuleDict({
            "0": _arr([SCPA() for _ in range(n_scpa)]), "1": _arr([TransformerBlock()]),
            "2": Layer(), "4": Layer()})
        self.path2 = nn.ModuleDict({"1": Layer()})

    def scet_body(self, x: torch.Tensor) -> torch.Tensor:
        """conv3, the SCPA blocks, the transformer block."""
        h = ops.conv(self.conv3, x)
        for blk in self.path1["0"].arr:
            h = blk(h)
        return self.path1["1"].arr[0](h)

    def scet_tail(self, h1: torch.Tensor, x_lr: torch.Tensor) -> torch.Tensor:
        """Both PixelShuffle heads, summed; the second head's input is
        conv3 of ``x_lr``, computed again here. NHWC out."""
        p1, r = self.path1, self.upscale
        h1 = ops.conv(p1["4"], blocks.conv_shuffle(p1["2"], h1, r))
        h2 = ops.conv(self.path2["1"], blocks.conv_shuffle(self.conv3, x_lr, r))
        return ops.to_nhwc(h1 + h2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.from_nhwc(x)
        return self.scet_tail(self.scet_body(x), x)
