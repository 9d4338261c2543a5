"""m_RFDN, team33 (counterpart of ``ntire2022_esr_tpu/models/m_rfdn.py``;
model 33).

An RFDN whose convs are Multiception blocks (parallel depthwise convs of
kernel 1, 3 and 5 on cuDNN, BatchNorm, a pointwise 1x1, BatchNorm), and a
progressive x4 upsampler: twice a nearest-x2 upsample + conv
(``ops.fused.upconv_nearest2``: the tail kernel at r = 2 where the fused
form is on), a pixel-attention gate and a conv, with LeakyReLU(0.2). The
upsampler runs inside ``config.hr_tail_scope("m_rfdn")`` (``fast`` under
``high`` and ``mixed``), ``conv_last`` outside it: its input (the largest
HR buffer) keeps the tail's 2-byte dtype, the image it makes the active
tier's precision. Widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import config, ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer, Nearest2Layer
from ntire2022_esr_tpu_torch.ops.fused import upconv_nearest2

BN = ("weight", "bias", "running_mean", "running_var")
SLOPE = 0.05


class Multiception(nn.Module):
    """JAX ``_multiception``: ``n_kernels`` depthwise convs (kernels 1, 3,
    5) concatenated, BatchNorm, a pointwise 1x1, BatchNorm."""

    def __init__(self, n_kernels: int):
        super().__init__()
        self.seps = nn.ModuleList([Layer() for _ in range(n_kernels)])
        self.bn1 = Layer(BN)
        self.pointwise = Layer()
        self.bn2 = Layer(BN)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        out = ops.cat([ops.conv(sep, x, groups=c) for sep in self.seps])
        out = ops.conv(self.pointwise, ops.batch_norm(self.bn1, out), padding=0)
        return ops.batch_norm(self.bn2, out)


class MRFDB(nn.Module):
    """JAX ``_m_rfdb``: the RFDB with Multiception convs."""

    def __init__(self):
        super().__init__()
        for i in (1, 2, 3):
            self.add_module(f"c{i}_d", Multiception(1))
            self.add_module(f"c{i}_r", Multiception(3))
        self.c4 = Multiception(3)
        self.c5 = Layer()
        self.esa = blocks.ESA()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, distilled = x, []
        for i in (1, 2, 3):
            distilled.append(ops.leaky_relu(getattr(self, f"c{i}_d")(h), SLOPE))
            h = ops.leaky_relu(getattr(self, f"c{i}_r")(h) + h, SLOPE)
        r4 = ops.leaky_relu(self.c4(h), SLOPE)
        return self.esa(ops.conv(self.c5, ops.cat(distilled + [r4]), padding=0))


class MRFDN(nn.Module):
    """JAX ``m_rfdn_apply``: :meth:`m_rfdn_body` (LR domain) and
    :meth:`m_rfdn_tail` (the HR tail), the seam JAX's stage-split runner
    dispatches at. NHWC in, NHWC out."""

    def __init__(self, num_modules: int = 4):
        super().__init__()
        self.num_modules = num_modules
        self.fea_conv = Layer()
        for i in range(1, num_modules + 1):
            self.add_module(f"B{i}", MRFDB())
        self.c = nn.Sequential(Layer())
        self.LR_conv = Layer()
        self.upconv1 = Nearest2Layer()
        self.att1 = blocks.wrapped("conv")
        self.HRconv1 = Layer()
        self.upconv2 = Nearest2Layer()
        self.att2 = blocks.wrapped("conv")
        self.HRconv2 = Layer()
        self.conv_last = Layer()

    def m_rfdn_body(self, x: torch.Tensor) -> torch.Tensor:
        """fea_conv, the blocks, the 1x1 fusion, LR_conv + fea."""
        fea = ops.conv(self.fea_conv, x)
        h, outs = fea, []
        for i in range(1, self.num_modules + 1):
            h = getattr(self, f"B{i}")(h)
            outs.append(h)
        h = ops.leaky_relu(ops.conv(self.c[0], ops.cat(outs), padding=0), SLOPE)
        return ops.conv(self.LR_conv, h) + fea

    def m_rfdn_tail(self, h: torch.Tensor, x_lr: torch.Tensor) -> torch.Tensor:
        """The progressive x4 upsampler inside the HR-tail scope, then
        conv_last outside it (``x_lr`` unused: the tails share one
        signature)."""
        del x_lr

        def pa(p, v):
            return v * ops.sigmoid(ops.conv(p.conv, v, padding=0))

        with config.hr_tail_scope("m_rfdn"):
            for up, att, hr in ((self.upconv1, self.att1, self.HRconv1),
                                (self.upconv2, self.att2, self.HRconv2)):
                h = ops.leaky_relu(pa(att, upconv_nearest2(up, h)), 0.2)
                h = ops.leaky_relu(ops.conv(hr, h), 0.2)
        return ops.conv(self.conv_last, h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.from_nhwc(x)
        return ops.to_nhwc(self.m_rfdn_tail(self.m_rfdn_body(x), x))
