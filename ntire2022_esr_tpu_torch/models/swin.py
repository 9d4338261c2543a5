"""The Swin transformer layer of the hybrid zoo models 09 and 12
(counterpart of ``ntire2022_esr_tpu/models/swin.py``).

Window attention with a relative-position bias, a cyclic shift with its
masks, and token MLPs, on NHWC views of the port's channels-last
activations. The relative-position index is a buffer made when the module
is built; the shift masks are device tensors cached per shape
(``ops.attention.shift_mask``), so a forward copies nothing from the host.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models.blocks import Layer
from ntire2022_esr_tpu_torch.ops import attention as attn_ops


class WindowAttention(Layer):
    """JAX ``window_attention``: ``qkv`` and ``proj`` linears and the
    relative-position bias table, on (B_, N, C) window tokens."""

    def __init__(self, num_heads: int, ws: int, site: str = "swin"):
        super().__init__(("relative_position_bias_table",))
        self.num_heads, self.ws, self.site = num_heads, ws, site
        self.qkv = Layer()
        self.proj = Layer()
        idx = torch.from_numpy(attn_ops.relative_position_index(ws).reshape(-1))
        self.register_buffer("relative_position_index", idx, persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        _, n, c = x.shape
        q, k, v = ops.linear_tokens(self.qkv, x).split(c, dim=-1)
        table = self.relative_position_bias_table
        rel_bias = table[self.relative_position_index].reshape(n, n, self.num_heads)
        out = attn_ops.multi_head_attention(q, k, v, self.num_heads,
                                            rel_bias=rel_bias.permute(2, 0, 1), mask=mask,
                                            site=self.site)
        return ops.linear_tokens(self.proj, out)


class Mlp(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = Layer()
        self.fc2 = Layer()


class SwinBlock(nn.Module):
    """JAX ``swin_block``: one (S)W-MSA block on (B, H, W, C) tokens.
    ``pre_norm=False`` is HNCT's variant, whose norms are commented out in
    the reference; SwinIR (model 09) has ``pre_norm=True``."""

    def __init__(self, num_heads: int, ws: int, shift: int, pre_norm: bool = False,
                 site: str = "swin"):
        super().__init__()
        self.num_heads, self.ws, self.shift, self.pre_norm = num_heads, ws, shift, pre_norm
        if pre_norm:
            self.norm1 = Layer()
            self.norm2 = Layer()
        self.attn = WindowAttention(num_heads, ws, site)
        self.mlp = Mlp()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, h, w, c = tokens.shape
        ws, shift = self.ws, self.shift
        x = ops.layer_norm(self.norm1, tokens) if self.pre_norm else tokens
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = attn_ops.shift_mask(h, w, ws, shift, x.device)
        windows = self.attn(attn_ops.window_partition(x, ws), mask)
        x = attn_ops.window_reverse(windows, ws, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = tokens + x
        mlp_in = ops.layer_norm(self.norm2, x) if self.pre_norm else x
        mlp = self.mlp
        return x + ops.linear_tokens(mlp.fc2, ops.gelu(ops.linear_tokens(mlp.fc1, mlp_in)))
