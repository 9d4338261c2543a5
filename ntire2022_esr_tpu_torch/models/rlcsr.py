"""RLCSR, team42 (counterpart of ``ntire2022_esr_tpu/models/rlcsr.py``;
model 42).

Six weight-normed RFDBs (folded into the cache) chained with residuals,
an ESA with SiLU and extra residuals inside, layer attention over one layer
(a softmax over one element: ``(1 + gamma) * x``), a BAM channel and
spatial gate, a channel-shuffle reduction chain, three-branch asymmetric
convs (1x3, 3x1, 3x3) for the stem and the tails, and a global bicubic x4
residual. The reference's ``activation('silu')`` builds SELU, so the blocks'
activation is SELU while the ESA's is SiLU. The cache also holds layers the
forward never reads (``last_conv``, ``last``, ``outconv``, two scales);
they are held here unused, as in JAX. On stock ops; widths from the weight
cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models.blocks import Layer

W = ("weight",)  # a conv without a bias


class ESA42(nn.Module):
    """JAX ``_esa42``."""

    def __init__(self):
        super().__init__()
        for name in ("conv1", "conv_f", "conv_max", "conv2", "conv3", "conv3_", "conv4"):
            self.add_module(name, Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1_ = ops.conv(self.conv1, x, padding=0)
        c1 = ops.conv(self.conv2, c1_, stride=2, padding=0)
        v_max = ops.max_pool2d(c1, 7, 3)
        v_range = ops.silu(ops.conv(self.conv_max, v_max)) + v_max
        c3 = ops.silu(ops.conv(self.conv3, v_range)) + v_range
        c3 = ops.conv(self.conv3_, c3) + c3
        c3 = ops.interpolate(c3, size=(x.shape[2], x.shape[3]), mode="bilinear")
        cf = ops.conv(self.conv_f, c1_, padding=0)
        return x * ops.sigmoid(ops.conv(self.conv4, c3 + cf, padding=0))


class RFDB42(nn.Module):
    """JAX ``_rfdb42``."""

    def __init__(self):
        super().__init__()
        for i in (1, 2, 3):
            self.add_module(f"c{i}_d", Layer())
            self.add_module(f"c{i}_r", Layer())
        self.c4 = Layer()
        self.c5 = Layer()
        self.esa = ESA42()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, distilled = x, []
        for i in (1, 2, 3):
            distilled.append(F.selu(ops.conv(getattr(self, f"c{i}_d"), h, padding=0)))
            h = F.selu(ops.conv(getattr(self, f"c{i}_r"), h) + h)
        r4 = F.selu(ops.conv(self.c4, h))
        return self.esa(ops.conv(self.c5, ops.cat(distilled + [r4]), padding=0))


def _tri(convs, x: torch.Tensor) -> torch.Tensor:
    """The three-branch conv: the sum of the branches in the given order."""
    out = ops.conv(convs[0], x)
    for p in convs[1:]:
        out = out + ops.conv(p, x)
    return out


class BAM(nn.Module):
    """JAX ``_bam``: a channel gate (a bias-free MLP of 1x1s on the average
    and the max pool) times a spatial gate (a 7x7 on the channel mean and
    max), times x. The channel mean of a 2-byte tensor sums in f32."""

    def __init__(self):
        super().__init__()
        self.ca = nn.Module()
        self.ca.fc1 = Layer(W)
        self.ca.fc2 = Layer(W)
        self.sa = nn.Module()
        self.sa.conv1 = Layer(W)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(v):
            return ops.conv(self.ca.fc2, ops.relu(ops.conv(self.ca.fc1, v, padding=0)), padding=0)

        ca = ops.sigmoid(mlp(ops.global_avg_pool(x)) + mlp(ops.global_max_pool(x)))
        avg = x.mean(dim=1, keepdim=True, dtype=torch.float32).to(x.dtype)
        mx = x.amax(dim=1, keepdim=True)
        sa = ops.sigmoid(ops.conv(self.sa.conv1, ops.cat([avg, mx])))
        return ca * sa * x


class RLCSR(nn.Module):
    """JAX ``rlcsr_apply``; NHWC in, NHWC out."""

    def __init__(self, num_modules: int = 6, upscale: int = 4):
        super().__init__()
        self.num_modules, self.upscale = num_modules, upscale
        for name in ("conv1_1", "conv1_2", "conv1_3", "convl11", "convl22", "convl33",
                     "convl1", "convl2", "convl3"):
            self.add_module(name, Layer(W))
        for i in range(1, num_modules + 1):
            self.add_module(f"B{i}", RFDB42())
        for i in range(1, num_modules):
            self.add_module(f"reduction{i}", Layer())
        self.c = nn.Sequential(Layer())
        self.la = Layer(("gamma",))
        self.BAM = BAM()
        up = nn.Module()
        for name in ("conv1_1", "conv1_2", "conv1_3"):
            up.add_module(name, Layer())
        self.upsampler = nn.Sequential(up)
        # in the cache, never read by the forward
        for name in ("LR_conv", "last_conv", "last", "outconv"):
            self.add_module(name, Layer())
        self.res_scale = Layer(("scale",))
        self.in_scale = Layer(("scale",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.from_nhwc(x)
        fea = _tri([self.conv1_2, self.conv1_1, self.conv1_3], x)
        h, outs = fea, []
        for i in range(1, self.num_modules + 1):
            b = getattr(self, f"B{i}")(h)
            h = b if i == 1 else b + h
            outs.append(h)
        out_b = F.selu(ops.conv(self.c[0], ops.cat(outs), padding=0))
        # layer attention over one layer: the softmax of one element is 1,
        # so out2 = (1 + gamma) * out_b (gamma an f32 (1,) tensor)
        out2 = (1.0 + self.la.gamma) * out_b
        out2 = _tri([self.convl11, self.convl22, self.convl33], out2)
        res = outs[0]
        for i in range(1, self.num_modules):
            res = ops.conv(getattr(self, f"reduction{i}"),
                           ops.channel_shuffle(ops.cat([res, outs[i]]), 2), padding=0)
        out = self.BAM(ops.cat([out2, res]))
        res = _tri([self.convl1, self.convl2, self.convl3], out)
        u = self.upsampler[0]
        up = _tri([u.conv1_3, u.conv1_1, u.conv1_2], res)
        output = ops.pixel_shuffle(up, self.upscale)
        return ops.to_nhwc(output + ops.interpolate(x, scale_factor=4, mode="bicubic"))
