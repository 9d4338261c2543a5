"""PRRN, team16 (counterpart of ``ntire2022_esr_tpu/models/prrn.py``;
model 16).

16 two-branch PRRBs (a pixel-attention branch and a plain conv branch,
SiLU) with a second channel attention, each followed by a 1x1 over the
block's output and the stem. On stock ops; widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer

W = ("weight",)


class _PA(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * ops.sigmoid(ops.conv(self.conv, x, padding=0))


class _CA(nn.Module):
    """x times sigmoid of a 1x1 conv of its global average (JAX ``_ca_tf``)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * ops.sigmoid(ops.conv(self.conv1, ops.global_avg_pool(x), padding=0))


class PATF(nn.Module):
    """JAX ``_pa_tf``."""

    def __init__(self):
        super().__init__()
        self.pa = _PA()
        self.ca = _CA()
        self.conv1 = Layer()
        self.conv2 = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = ops.sigmoid(ops.conv(self.conv1, self.pa(x) + self.ca(x), padding=0))
        return y1 * ops.conv(self.conv2, x)


class PRRB(nn.Module):
    """JAX ``_prrb``."""

    def __init__(self):
        super().__init__()
        self.conv1_1 = Layer(W)
        self.conv1_2 = Layer(W)
        self.pgam_1 = PATF()
        self.conv3_1 = Layer()
        self.conv3_2 = Layer()
        self.conv3_3 = Layer()
        self.conv1_end = Layer(W)
        self.sca = _CA()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = ops.silu(ops.conv(self.conv1_1, x, padding=0))
        b = ops.silu(ops.conv(self.conv1_2, x, padding=0))
        attn = ops.sigmoid(self.pgam_1(a))
        a_end = ops.silu(ops.conv(self.conv3_2, attn * ops.conv(self.conv3_1, a)))
        b_end = ops.silu(ops.conv(self.conv3_3, b))
        mid = ops.silu(ops.conv(self.conv1_end, ops.cat([a_end, b_end]), padding=0))
        return self.sca(mid) + x


class PRRN(nn.Module):
    """JAX ``prrn_apply``; NHWC in, NHWC out."""

    def __init__(self, n_blocks: int = 16, upscale: int = 4):
        super().__init__()
        self.n_blocks, self.upscale = n_blocks, upscale
        self.conv_first = Layer()
        for i in range(1, n_blocks + 1):
            self.add_module(f"scpa_v{i}", PRRB())
            self.add_module(f"conv1_mid_{i}", Layer())
        self.conv3_end = Layer()
        self.upsampler = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stem = ops.conv(self.conv_first, ops.from_nhwc(x))
        h = stem
        for i in range(1, self.n_blocks + 1):
            fea = getattr(self, f"scpa_v{i}")(h)
            h = ops.conv(getattr(self, f"conv1_mid_{i}"), ops.cat([stem, fea]), padding=0)
        h = ops.conv(self.conv3_end, h) + stem
        return blocks.upsample(self.upsampler, h, self.upscale)
