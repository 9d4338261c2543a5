"""IMDeception, team19 (counterpart of ``ntire2022_esr_tpu/models/imdeception.py``;
model 19).

Grouped-conv information distillation (each group's conv its own layer)
with a block self-attention: the features are padded to the next multiple
of 64 rows and columns (one more block even when they divide), pixel-
unshuffled by 4, cut into 8x8 blocks, and each 64-token block runs a
softmax attention (two batched matmuls, f32 under the f32 tiers with TF32
off). On stock ops; widths from the weight cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models.blocks import Layer

SLOPE = 0.05


class GConv(nn.Module):
    """A 3x3 conv per channel group (``conv2d_block.{i}``), concatenated."""

    def __init__(self, groups: int = 4):
        super().__init__()
        self.conv2d_block = nn.ModuleList([Layer() for _ in range(groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.chunk(x, len(self.conv2d_block), dim=1)
        return ops.cat([ops.conv(p, c) for p, c in zip(self.conv2d_block, chunks)])


class GBlock(nn.Module):
    """JAX ``_gblock``: grouped 3x3s, ReLU, 1x1."""

    def __init__(self):
        super().__init__()
        self.conv0 = GConv()
        self.conv1 = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv(self.conv1, ops.relu(self.conv0(x)), padding=0)


class GIDB(nn.Module):
    """JAX ``_gidb``: three GBlocks each splitting off ``shal`` channels, a
    fourth on the rest, and a 1x1 over the parts and x."""

    def __init__(self, shal: int = 16):
        super().__init__()
        self.shal = shal
        for name in ("conv0", "conv1", "conv2", "conv3_shal"):
            self.add_module(name, GBlock())
        self.conv_fuse0 = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shals, h = [], x
        for block in (self.conv0, self.conv1, self.conv2):
            out = ops.leaky_relu(block(h), SLOPE)
            shals.append(out[:, :self.shal])
            h = out[:, self.shal:]
        shals.append(ops.leaky_relu(self.conv3_shal(h), SLOPE))
        return ops.conv(self.conv_fuse0, ops.cat(shals + [x]), padding=0)


class BlockSelfAttention(nn.Module):
    """JAX ``_block_self_attention`` (local 4, area 32: 8x8 blocks of the
    4x-unshuffled grid)."""

    def __init__(self, local: int = 4, area: int = 32):
        super().__init__()
        self.local, self.bs = local, area // local
        self.conv_phi_theta_g = Layer()
        self.conv_out = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bs, m = self.bs, self.bs * self.bs
        t = ops.conv(self.conv_phi_theta_g, x, padding=0)
        n, _, h8, w8 = t.shape
        # the reference pads to the next multiple of bs^2 even when it divides
        t = F.pad(t, (0, (w8 // m + 1) * m - w8, 0, (h8 // m + 1) * m - h8))
        t = ops.pixel_unshuffle(t, self.local)
        c3, hh, ww = t.shape[1], t.shape[2], t.shape[3]
        hb, wb = hh // bs, ww // bs
        # token i * bs + j of block (hb, wb) is pixel (hb * bs + i, wb * bs + j)
        blk = t.reshape(n, c3, hb, bs, wb, bs).permute(0, 2, 4, 3, 5, 1).reshape(-1, m, c3)
        oc = c3 // 3
        q, k, v = blk[..., :oc], blk[..., oc:2 * oc], blk[..., 2 * oc:]
        sa = ops.softmax(torch.matmul(q, k.transpose(1, 2)), dim=-1)
        o = torch.matmul(sa, v)
        o = o.reshape(n, hb, wb, bs, bs, oc).permute(0, 5, 1, 3, 2, 4).reshape(n, oc, hh, ww)
        o = ops.pixel_shuffle(o, self.local)[:, :, :h8, :w8]
        return ops.conv(self.conv_out, o.contiguous(memory_format=ops.nn.CL), padding=0) + x


class IMDeception(nn.Module):
    """JAX ``imdeception_apply``; NHWC in, NHWC out."""

    def __init__(self, core: int = 16, upscale: int = 4):
        super().__init__()
        self.core, self.upscale = core, upscale
        self.feat_conv0 = Layer()
        for i in range(1, 6):
            self.add_module(f"block{i}", GIDB(core))
        self.block6_shal = GIDB(core)
        self.self_attention1 = BlockSelfAttention()
        self.self_attention2 = BlockSelfAttention()
        self.conv_fuse0 = Layer()
        self.conv_fuse1 = Layer()
        self.conv_out = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.core
        h = ops.conv(self.feat_conv0, ops.from_nhwc(x))
        parts, hi = [], h
        for i in range(1, 6):
            out = getattr(self, f"block{i}")(hi)
            parts.append(out[:, :c])
            hi = out[:, c:]
            if i in (2, 4):
                hi = getattr(self, f"self_attention{i // 2}")(hi)
        parts.append(self.block6_shal(hi))
        hc = ops.leaky_relu(ops.conv(self.conv_fuse0, ops.cat(parts), padding=0), SLOPE)
        hc = ops.leaky_relu(ops.conv(self.conv_fuse1, hc), SLOPE) + h
        y = ops.conv(self.conv_out, hc)
        return ops.to_nhwc(ops.pixel_shuffle(y, self.upscale))
