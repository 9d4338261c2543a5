"""MobileSR, team20 (counterpart of ``ntire2022_esr_tpu/models/mobilesr.py``;
model 20).

Five pairs of a windowed-MHSA transformer (a depthwise positional conv,
LayerNorm over channels, zero-padded to windows of 8, 8 heads; an MLP)
and an inverted-residual conv block; a 3x3 fuse over the head and the
body; two 1x1 + PixelShuffle(2) stages under ``config.hr_tail_scope
("mobilesr")``, a 3x3 tail conv outside it, and the f32 bilinear x4 of the
input added. On stock ops; widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import config, ops
from ntire2022_esr_tpu_torch.models.blocks import Layer
from ntire2022_esr_tpu_torch.ops import attention as attn_ops

SLOPE = 0.2


class SelfAttention(nn.Module):
    """JAX ``_self_attn`` on (B_, N, C) window tokens. The softmax scale is
    the reference's head width, from ``proj_out``'s out-features:
    ``(40 // 8) ** -0.5``."""

    def __init__(self, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Layer(("weight",))
        self.proj_out = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        q, k, v = ops.linear_tokens(self.qkv, x).split(c, dim=-1)
        scale = (self.proj_out.weight.shape[1] // self.num_heads) ** -0.5
        out = attn_ops.multi_head_attention(q, k, v, self.num_heads, scale=scale,
                                            site="mobilesr")
        return ops.linear_tokens(self.proj_out, out)


class Transformer(nn.Module):
    """JAX ``_transformer``. NCHW (channels_last) in and out; the attention
    and the MLP work on the NHWC view."""

    def __init__(self, num_heads: int = 8, ws: int = 8):
        super().__init__()
        self.ws = ws
        self.pos_embed = Layer()
        self.norm1 = Layer()
        self.attn = SelfAttention(num_heads)
        self.norm2 = Layer()
        self.mlp = nn.Module()
        self.mlp.fc = nn.ModuleDict({"0": Layer(), "2": Layer()})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = self.ws
        x = x + ops.conv(self.pos_embed, x, groups=x.shape[1])
        _, _, h, w = x.shape
        shortcut = x.permute(0, 2, 3, 1)
        hp, _, _ = attn_ops.pad_to_multiple(ops.layer_norm(self.norm1, shortcut), ws)
        hp_h, hp_w = hp.shape[1], hp.shape[2]
        windows = self.attn(attn_ops.window_partition(hp, ws))
        t = shortcut + attn_ops.window_reverse(windows, ws, hp_h, hp_w)[:, :h, :w]
        fc = self.mlp.fc
        t = t + ops.linear_tokens(
            fc["2"], ops.gelu(ops.linear_tokens(fc["0"], ops.layer_norm(self.norm2, t))))
        return t.permute(0, 3, 1, 2).contiguous(memory_format=ops.nn.CL)


class ResBlock(nn.Module):
    """JAX ``_res_block``: 1x1, depthwise 3x3, 1x1 (LeakyReLU(0.2) after the
    first two), + x."""

    def __init__(self):
        super().__init__()
        self.net = nn.ModuleDict({"0": Layer(), "2": Layer(), "4": Layer()})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.net
        h = ops.leaky_relu(ops.conv(net["0"], x, padding=0), SLOPE)
        h = ops.leaky_relu(ops.conv(net["2"], h, groups=h.shape[1]), SLOPE)
        return ops.conv(net["4"], h, padding=0) + x


class MobileSR(nn.Module):
    """JAX ``mobilesr_apply``: :meth:`mobilesr_body` (LR domain) and
    :meth:`mobilesr_tail` (the upsampler and the global residual), the seam
    JAX's stage-split runner dispatches at. NHWC in, NHWC out."""

    def __init__(self, n_blocks: int = 5, num_heads: int = 8, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.head = Layer()
        self.body = nn.Module()
        self.body.layers = nn.ModuleList([
            nn.ModuleDict({"0": Transformer(num_heads), "1": ResBlock()}) for _ in range(n_blocks)])
        self.fuse = Layer()
        self.upsapling = nn.ModuleDict({"0": Layer(), "2": Layer()})
        self.tail = Layer()

    def mobilesr_body(self, x: torch.Tensor) -> torch.Tensor:
        """head, the transformer/resblock pairs, the fuse over head and body."""
        x0 = ops.conv(self.head, x)
        h = x0
        for pair in self.body.layers:
            h = pair["1"](pair["0"](h))
        return ops.conv(self.fuse, ops.cat([x0, h]))

    def mobilesr_tail(self, h: torch.Tensor, x_lr: torch.Tensor) -> torch.Tensor:
        """The two x2 shuffle stages in the HR-tail scope, the tail conv
        outside it (its output pixels keep the active tier's precision),
        and the bilinear x4 of ``x_lr`` in f32. NHWC out."""
        up = self.upsapling
        with config.hr_tail_scope("mobilesr"):
            h = ops.pixel_shuffle(ops.conv(up["0"], h, padding=0), 2)
            h = ops.pixel_shuffle(ops.conv(up["2"], h, padding=0), 2)
            h = ops.leaky_relu(h, SLOPE)
        out = ops.conv(self.tail, h) + ops.interpolate(x_lr, scale_factor=self.upscale,
                                                       mode="bilinear")
        return ops.to_nhwc(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.from_nhwc(x)
        return self.mobilesr_tail(self.mobilesr_body(x), x)
