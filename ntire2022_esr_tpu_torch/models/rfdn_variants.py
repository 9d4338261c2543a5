"""RFDN-skeleton zoo variants with their own blocks (counterpart of
``ntire2022_esr_tpu/models/rfdn_variants.py``).

- FasterRFDN (25): progressive channel-halving distillation.
- BMDN (37): back-projection convs feeding the distilled features into the
  residual path; ReLU activations, the fusion conv's included.
- RFDNext (38): a slim RFDB with a ConvNeXt-style gate (depthwise 7x7 and
  an MLP of 1x1s) in place of the ESA.
- team35 RFDN (35): factorised residual branches (depthwise 3x3 + x, then
  a 1x1, twice) and a pixel-unshuffle ESA that floor-crops odd sizes.

All on stock ops but the x4 upsampler, which runs as the tail kernel
(``blocks.conv_shuffle``); the widths come from the weight cache
(``blocks.Layer``).
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer, conv_lrelu


def _layers(module: nn.Module, names) -> None:
    for name in names:
        module.add_module(name, Layer())


# -- FasterRFDN (25) ---------------------------------------------------------

class FRFDB(nn.Module):
    """JAX ``_frfdb``."""

    def __init__(self, slope: float = 0.05):
        super().__init__()
        self.slope = slope
        _layers(self, ("c1_d", "c1_r", "c2_d", "c2_r", "c3_d", "c3_r", "c4", "c5"))
        self.esa = blocks.ESA()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.slope
        d1 = conv_lrelu(self.c1_d, x, s, padding=0)
        r1 = ops.leaky_relu(ops.conv(self.c1_r, x) + x, s)
        d2 = conv_lrelu(self.c2_d, r1, s, padding=0)
        r2 = ops.leaky_relu(ops.conv(self.c2_r, d2) + d2, s)
        d3 = conv_lrelu(self.c3_d, r2, s, padding=0)
        r3 = ops.leaky_relu(ops.conv(self.c3_r, d3) + d3, s)
        r4 = ops.leaky_relu(ops.conv(self.c4, r3) + r3, s)
        return self.esa(ops.conv(self.c5, ops.cat([d1, d2, d3, r4]), padding=0))


def FasterRFDN() -> blocks.RFDNSkeleton:
    """JAX ``frfdn_apply``."""
    return blocks.RFDNSkeleton(FRFDB)


# -- BMDN (37) ---------------------------------------------------------------

class BMDB(nn.Module):
    """JAX ``_bmdb``."""

    def __init__(self):
        super().__init__()
        _layers(self, ("c1_d", "c1_b", "c1_r", "c2_d", "c2_b", "c2_r", "c3_d", "c3_b", "c3_r",
                       "c4", "c5"))
        self.esa = blocks.ESA()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = ops.relu(ops.conv(self.c1_d, x, padding=0))
        r1 = ops.relu(ops.conv(self.c1_r, x) + ops.conv(self.c1_b, d1))
        d2 = ops.relu(ops.conv(self.c2_d, r1, padding=0))
        r2 = ops.relu(ops.conv(self.c2_r, r1) + r1 + ops.conv(self.c2_b, d2))
        d3 = ops.relu(ops.conv(self.c3_d, r2, padding=0))
        r3 = ops.relu(ops.conv(self.c3_r, r2) + r2 + ops.conv(self.c3_b, d3))
        r4 = ops.relu(ops.conv(self.c4, r3))
        return self.esa(ops.conv(self.c5, ops.cat([d1, d2, d3, r4]), padding=0))


def BMDN() -> blocks.RFDNSkeleton:
    """JAX ``bmdn_apply``: the skeleton with BMDBs and a ReLU after the
    fusion conv."""
    return blocks.RFDNSkeleton(BMDB, fuse_act=ops.relu)


# -- RFDNext (38) ------------------------------------------------------------

class CX(nn.Module):
    """JAX ``_cx``: depthwise 7x7, 1x1 up, LeakyReLU, 1x1 down, + x. The
    weight cache numbers the layers 0, 1 and 3 (2 is the activation)."""

    def __init__(self, slope: float = 0.05):
        super().__init__()
        self.slope = slope
        self.conv = nn.ModuleDict({"0": Layer(), "1": Layer(), "3": Layer()})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ops.conv(self.conv["0"], x, groups=x.shape[1])
        h = conv_lrelu(self.conv["1"], h, self.slope, padding=0)
        return ops.conv(self.conv["3"], h, padding=0) + x


class RFDNextBlock(nn.Module):
    """JAX ``_rfdnext_block``."""

    def __init__(self, slope: float = 0.05):
        super().__init__()
        self.slope = slope
        _layers(self, ("c1_d", "c1_r", "c2_d", "c2_r", "c3_d", "c3_r", "c4", "c5"))
        self.esa = CX(slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = ops.conv(self.c1_d, x, padding=0)
        r1 = ops.conv(self.c1_r, x) + d1
        d2 = ops.conv(self.c2_d, r1, padding=0)
        r2 = ops.conv(self.c2_r, r1) + r1
        d3 = ops.conv(self.c3_d, r2, padding=0)
        r3 = ops.leaky_relu(ops.conv(self.c3_r, r2) + r2, self.slope)
        r4 = ops.conv(self.c4, r3)
        out = ops.leaky_relu(ops.cat([d1, d2, d3, r4]), self.slope)
        return self.esa(ops.conv(self.c5, out, padding=0))


def RFDNext() -> blocks.RFDNSkeleton:
    """JAX ``rfdnext_apply``."""
    return blocks.RFDNSkeleton(RFDNextBlock)


# -- team35 (35) -------------------------------------------------------------

class ESAUnshuffle(nn.Module):
    """JAX ``_esa_unshuffle``: the strided 3x3 becomes a floor-crop to even
    sizes and a pixel-unshuffle by 2. The cache also holds a ``conv_max``
    that the graph never reads; it is kept so that every key loads."""

    def __init__(self):
        super().__init__()
        _layers(self, ("conv1", "conv_f", "conv_max", "con_", "conv4"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1_ = ops.conv(self.conv1, x, padding=0)
        h, w = c1_.shape[2], c1_.shape[3]
        c1 = ops.pixel_unshuffle(c1_[:, :, : h // 2 * 2, : w // 2 * 2], 2)
        c1p = ops.relu(ops.max_pool2d(c1, 7, 3))
        c2 = ops.relu(ops.conv(self.con_, c1p, padding=1))
        c3 = ops.interpolate(c2, size=(x.shape[2], x.shape[3]), mode="bilinear")
        cf = ops.conv(self.conv_f, c1_, padding=0)
        return x * ops.sigmoid(ops.conv(self.conv4, c3 + cf, padding=0))


class _DepthwiseResidual(nn.Module):
    """``fn`` (depthwise 3x3) + x, the first half of JAX ``_conv_two``."""

    def __init__(self):
        super().__init__()
        self.fn = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv(self.fn, x, groups=x.shape[1]) + x


class _ConvTwo(nn.ModuleDict):
    """JAX ``_conv_two``: depthwise residual, then a 1x1."""

    def __init__(self):
        super().__init__({"0": _DepthwiseResidual(), "1": Layer()})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv(self["1"], self["0"](x), padding=0)


class _ConvFour(nn.ModuleDict):
    """JAX ``_conv_four``: two ``_conv_two`` with a ReLU between (cache
    keys 0 and 2)."""

    def __init__(self):
        super().__init__({"0": _ConvTwo(), "2": _ConvTwo()})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self["2"](ops.relu(self["0"](x)))


class RFDB35(nn.Module):
    """JAX ``_rfdb35``."""

    def __init__(self, slope: float = 0.05):
        super().__init__()
        self.slope = slope
        for i in (1, 2, 3):
            self.add_module(f"c{i}_d", Layer())
            self.add_module(f"c{i}_r", _ConvFour())
        _layers(self, ("c4", "c5"))
        self.esa = ESAUnshuffle()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, distilled = x, []
        for i in (1, 2, 3):
            distilled.append(conv_lrelu(getattr(self, f"c{i}_d"), h, self.slope, padding=0))
            h = ops.leaky_relu(getattr(self, f"c{i}_r")(h) + h, self.slope)
        r4 = conv_lrelu(self.c4, h, self.slope)
        return self.esa(ops.conv(self.c5, ops.cat(distilled + [r4]), padding=0))


def RFDN35() -> blocks.RFDNSkeleton:
    """JAX ``rfdn35_apply``."""
    return blocks.RFDNSkeleton(RFDB35)
