"""Conv-only zoo entries (counterpart of ``ntire2022_esr_tpu/models/misc_conv.py``):
SR_model (31), ESAN (34), MDGN (24), IMDN_plus (39) and LWFANet (27).

- SR_model: four BuildingBlocks, each three (3x3 + x, LeakyReLU, ESA)
  stages whose outputs are concatenated with the input, a 1x1 and an ESA.
  Convs sit under a ``conv`` sub-layer in the cache.
- ESAN (level 1): a conv + PixelShuffle base path plus one trunk of 16
  residual blocks gated by an ESA of three chained 3x3s (no ``conv_f``,
  no ``conv_max``).
- MDGN: four blocks of three conv + PReLU stages, a 1x1 fusion + PReLU,
  and a sigmoid gate of a 1x1 on the block's input.
- IMDN_plus: IMD blocks that split a sixth of the channels off at each of
  five stages (SiLU), inside a long skip.
- LWFANet: ten LWFA blocks (four branch chains of 1x1 and 3x3 convs with
  LeakyReLU(0.2), channel and spatial attention) in the body; the tail
  grows the image by two nearest-x2 upsample + conv steps
  (``ops.fused.upconv_nearest2``), ``conv_hr`` and ``conv_last``. The tail
  runs inside ``config.hr_tail_scope("lwfanet")`` (``fast`` under ``high``
  and ``mixed``), ``conv_last`` outside it. The JAX package can merge the
  four 1x1 heads into one conv (``fuse_parallel_branches("lwfanet")``);
  that setting is off in every tier, so it is not ported.

On stock ops but the tail's upsamplers (the tail kernel at r = 2 where the
fused form is on); widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import config, ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer, Nearest2Layer
from ntire2022_esr_tpu_torch.ops.fused import upconv_nearest2


# -- SR_model (31) -------------------------------------------------------------

class BuildingBlock(nn.Module):
    """JAX ``_building_block``."""

    def __init__(self, n_convs: int = 3, slope: float = 0.05):
        super().__init__()
        self.slope = slope
        self.convs = nn.ModuleList([blocks.wrapped("conv") for _ in range(n_convs)])
        self.esa = nn.ModuleList([blocks.ESA() for _ in range(n_convs)])
        self.conv_last = blocks.wrapped("conv")
        self.esa_last = blocks.ESA()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cat_list, h = [x], x
        for conv, esa in zip(self.convs, self.esa):
            h = esa(ops.leaky_relu(ops.conv(conv.conv, h) + h, self.slope))
            cat_list.append(h)
        return self.esa_last(ops.conv(self.conv_last.conv, ops.cat(cat_list), padding=0))


class SRModel(nn.Module):
    """JAX ``sr_model_apply``; NHWC in, NHWC out."""

    def __init__(self, n_modules: int = 4, upscale: int = 4, slope: float = 0.05):
        super().__init__()
        self.upscale, self.slope = upscale, slope
        self.fea_conv = blocks.wrapped("conv")
        self.mods = nn.ModuleList([BuildingBlock() for _ in range(n_modules)])
        self.c = blocks.wrapped("conv")
        self.LR_conv = blocks.wrapped("conv")
        self.upsampler = nn.Sequential(blocks.wrapped("conv"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = ops.conv(self.fea_conv.conv, ops.from_nhwc(x))
        h, outs = fea, []
        for mod in self.mods:
            h = mod(h)
            outs.append(h)
        h = ops.leaky_relu(ops.conv(self.c.conv, ops.cat(outs), padding=0), self.slope)
        h = ops.conv(self.LR_conv.conv, h) + fea
        up = ops.conv(self.upsampler[0].conv, h)
        return ops.to_nhwc(ops.pixel_shuffle(up, self.upscale))


# -- ESAN (34) -----------------------------------------------------------------

class ESA34(nn.Module):
    """JAX ``_esa34``."""

    def __init__(self):
        super().__init__()
        for name in ("conv1", "conv2", "conv3_1", "conv3_2", "conv3_3", "conv4"):
            self.add_module(name, Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1_ = ops.conv(self.conv1, x, padding=0)
        c1 = ops.max_pool2d(ops.conv(self.conv2, c1_, stride=2, padding=0), 7, 3)
        c3 = ops.relu(ops.conv(self.conv3_1, c1))
        c3 = ops.relu(ops.conv(self.conv3_2, c3))
        c3 = ops.conv(self.conv3_3, c3)
        c3 = ops.interpolate(c3, size=(x.shape[2], x.shape[3]), mode="bilinear")
        return x * ops.sigmoid(ops.conv(self.conv4, c3 + c1_, padding=0))


class ResidualBlockESA(nn.Module):
    """JAX ``_res_esa``."""

    def __init__(self):
        super().__init__()
        self.conv1 = Layer()
        self.conv2 = Layer()
        self.ESA = ESA34()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = ops.conv(self.conv2, ops.relu(ops.conv(self.conv1, x)))
        return x + self.ESA(out)


class ESAN(nn.Module):
    """JAX ``esan_apply``; NHWC in, NHWC out."""

    def __init__(self, level: int = 1, trunk_len: int = 16, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.upconv0 = Layer()
        self.conv_first = nn.ModuleList([Layer() for _ in range(level)])
        self.recon_trunk = nn.ModuleList([
            nn.Sequential(*[ResidualBlockESA() for _ in range(trunk_len)]) for _ in range(level)])
        self.upconv = nn.ModuleList([Layer() for _ in range(level)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.from_nhwc(x)
        result = ops.pixel_shuffle(ops.conv(self.upconv0, x), self.upscale)
        for first, trunk, up in zip(self.conv_first, self.recon_trunk, self.upconv):
            h = trunk(ops.conv(first, x))
            result = result + ops.pixel_shuffle(ops.conv(up, h), self.upscale)
        return ops.to_nhwc(result)


# -- MDGN (24) -----------------------------------------------------------------

def _conv_prelu() -> nn.Sequential:
    return nn.Sequential(Layer(), Layer(("weight",)))


def _apply_conv_prelu(p: nn.Sequential, x: torch.Tensor, **kw) -> torch.Tensor:
    return ops.prelu(ops.conv(p[0], x, **kw), p[1].weight)


class MDSA(nn.Module):
    """JAX ``_mdsa``."""

    def __init__(self):
        super().__init__()
        for name in ("f1", "f2", "f3", "conv_fuse"):
            self.add_module(name, _conv_prelu())
        self.sa = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f1 = _apply_conv_prelu(self.f1, x)
        f2 = _apply_conv_prelu(self.f2, f1)
        f3 = _apply_conv_prelu(self.f3, f2)
        f = _apply_conv_prelu(self.conv_fuse, ops.cat([f1, f2, f3]), padding=0)
        return f * ops.sigmoid(ops.conv(self.sa[0], x, padding=0))


class MDGN(nn.Module):
    """JAX ``mdgn_apply``; NHWC in, NHWC out."""

    def __init__(self, num_modules: int = 4, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.fea_conv = Layer()
        self.B = nn.Sequential(*[MDSA() for _ in range(num_modules)])
        self.LR_conv = Layer()
        self.upsampler = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = ops.conv(self.fea_conv, ops.from_nhwc(x))
        h = ops.conv(self.LR_conv, self.B(fea)) + fea
        return blocks.upsample(self.upsampler, h, self.upscale)


# -- IMDN_plus (39) ------------------------------------------------------------

class IMDBPlus(nn.Module):
    """JAX ``_imdb_plus``: at each of five stages a sixth of the channels
    (``d``) is split off, the rest goes through a 3x3 + SiLU; a 1x1 over
    the parts, + x."""

    def __init__(self, d: int):
        super().__init__()
        self.d = d
        for i in range(1, 8):
            self.add_module(f"c{i}", Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ops.silu(ops.conv(self.c1, x))
        distilled = []
        for i in range(2, 7):
            distilled.append(h[:, :self.d])
            h = ops.silu(ops.conv(getattr(self, f"c{i}"), h[:, self.d:]))
        return ops.conv(self.c7, ops.cat(distilled + [h]), padding=0) + x


class IMDNPlus(nn.Module):
    """JAX ``imdn_plus_apply``; NHWC in, NHWC out."""

    def __init__(self, nf: int = 36, nb: int = 8, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        body = nn.Module()
        body.sub = nn.Sequential(*[IMDBPlus(nf // 6) for _ in range(nb)], Layer())
        self.FEM = nn.Sequential(Layer(), body)
        self.RM = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = ops.conv(self.FEM[0], ops.from_nhwc(x))
        sub = self.FEM[1].sub
        h = head
        for block in sub[:-1]:
            h = block(h)
        h = head + ops.conv(sub[-1], h)
        return blocks.upsample(self.RM, h, self.upscale)


# -- LWFANet (27) --------------------------------------------------------------

BRANCHES = (("conv1_1", "conv1_2"), ("conv2_1", "conv2_2", "conv2_3"),
            ("conv3_1", "conv3_2", "conv3_3", "conv3_4"),
            ("conv4_1", "conv4_2", "conv4_3", "conv4_4", "conv4_5"))


class LWFA(nn.Module):
    """JAX ``_lwfa``: four branch chains (a 1x1, then 3x3s, each with
    LeakyReLU) concatenated, then ``ca * out + sa1 * out + sa2 * x``, with a
    bias-free CBAM channel gate and two 1x1 spatial gates."""

    def __init__(self, slope: float = 0.2):
        super().__init__()
        self.slope = slope
        for branch in BRANCHES:
            for name in branch:
                self.add_module(name, Layer())
        self.ca = nn.Module()
        self.ca.fc1 = Layer(("weight",))
        self.ca.fc2 = Layer(("weight",))
        self.sa1 = blocks.wrapped("sa_conv")
        self.sa2 = blocks.wrapped("sa_conv")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for branch in BRANCHES:
            h = x
            for name in branch:
                h = ops.leaky_relu(ops.conv(getattr(self, name), h,
                                            padding=0 if name.endswith("_1") else None), self.slope)
            outs.append(h)
        out = ops.cat(outs)

        def mlp(v):
            return ops.conv(self.ca.fc2, ops.relu(ops.conv(self.ca.fc1, v, padding=0)), padding=0)

        ca = ops.sigmoid(mlp(ops.global_avg_pool(out)) + mlp(ops.global_max_pool(out)))
        sa1 = ops.sigmoid(ops.conv(self.sa1.sa_conv, out, padding=0))
        sa2 = ops.sigmoid(ops.conv(self.sa2.sa_conv, x, padding=0))
        return ca * out + sa1 * out + sa2 * x


class LWFANet(nn.Module):
    """JAX ``lwfanet_apply``: :meth:`lwfanet_body` (LR domain) and
    :meth:`lwfanet_tail` (the HR tail), the seam JAX's stage-split runner
    dispatches at. NHWC in, NHWC out."""

    def __init__(self, num_block: int = 10, slope: float = 0.2):
        super().__init__()
        self.slope = slope
        self.conv_first = Layer()
        self.body = nn.Sequential(*[LWFA(slope) for _ in range(num_block)])
        self.conv_body = Layer()
        self.conv_L = Layer()
        self.conv_up1 = Nearest2Layer()
        self.conv_up2 = Nearest2Layer()
        self.conv_hr = Layer()
        self.conv_last = Layer()

    def lwfanet_body(self, x: torch.Tensor) -> torch.Tensor:
        """conv_first, the LWFA blocks, conv_body + the skip, conv_L."""
        feat = ops.conv(self.conv_first, x)
        feat = feat + ops.conv(self.conv_body, self.body(feat))
        return ops.conv(self.conv_L, feat, padding=0)

    def lwfanet_tail(self, feat: torch.Tensor, x_lr: torch.Tensor) -> torch.Tensor:
        """Two fused nearest-x2 upsample + convs, conv_hr inside the HR-tail
        scope, then conv_last outside it: its input keeps the tail's 2-byte
        dtype, its output the active tier's precision (``x_lr`` unused: the
        tails share one signature)."""
        del x_lr
        s = self.slope
        with config.hr_tail_scope("lwfanet"):
            feat2 = ops.leaky_relu(upconv_nearest2(self.conv_up1, feat), s)
            feat2 = ops.leaky_relu(upconv_nearest2(self.conv_up2, feat2), s)
            feat2 = ops.leaky_relu(ops.conv(self.conv_hr, feat2), s)
        return ops.conv(self.conv_last, feat2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.from_nhwc(x)
        return ops.to_nhwc(self.lwfanet_tail(self.lwfanet_body(x), x))
