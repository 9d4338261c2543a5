"""Shared blocks of the zoo (counterpart of ``ntire2022_esr_tpu/models/blocks.py``).

Ported so far: ``seq`` and ``conv_lrelu`` (RLFN), and the RFDN family's
``imd_block`` (IMDN), the ESA gates ``esa`` and ``esa_no_f``, and ``rfdb``
as modules (:class:`IMDBlock`, :class:`ESA`, :class:`RFDB`). The port's
own: :class:`Nearest2Layer` (an upsampler conv with its fused nearest-x2
weights) and :func:`wrapped` (a conv nested in a wrapper module).

:class:`Layer` holds one layer's parameters under the weight cache's
names. Its tensors take their shapes from the state dict loaded into
them, so a model's module tree fixes its graph and the cache fixes its
widths, as the JAX package infers the widths from its params; the
registry loads with ``strict=True``, so every cached key must land in a
``Layer`` and every ``Layer`` must be filled.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.ops.fused import nearest2_conv_weights


class Layer(nn.Module):
    """The parameters ``names`` of one layer (a conv's OIHW ``weight`` and
    ``bias``, a PReLU's ``weight``), each sized by the state dict loaded
    into it."""

    def __init__(self, names: Sequence[str] = ("weight", "bias")):
        super().__init__()
        for name in names:
            self.register_parameter(name, nn.Parameter(torch.empty(0), requires_grad=False))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name, p in self._parameters.items():
            t = state_dict.get(prefix + name)
            if t is not None and p is not None and t.shape != p.shape:
                self._parameters[name] = nn.Parameter(
                    torch.empty(t.shape, dtype=t.dtype, device=p.device),
                    requires_grad=p.requires_grad)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class Nearest2Layer(Layer):
    """A 3x3 conv layer that upsamples by nearest x2 first
    (``ops.fused.upconv_nearest2``). When its weights are loaded it derives
    the fused form's low-resolution weights ``w4`` and bias ``b4``
    (``ops.fused.nearest2_conv_weights``) once and holds them as buffers
    outside the state dict, so every forward hands the tail kernel the same
    tensors and their packing is cached; loading another weight set makes
    new ones."""

    def __init__(self):
        super().__init__()
        self.register_buffer("w4", None, persistent=False)
        self.register_buffer("b4", None, persistent=False)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        if self.weight.dim() == 4 and tuple(self.weight.shape[2:]) == (3, 3):
            with torch.no_grad():
                self.w4, self.b4 = nearest2_conv_weights(self.weight, self.bias)


def wrapped(name: str) -> nn.Module:
    """A wrapper module that holds one :class:`Layer` under ``name``, as the
    cache nests some models' convs (``fea_conv.conv3x3.weight``)."""
    m = nn.Module()
    m.add_module(name, Layer())
    return m


def seq(p: nn.Sequential, i: int) -> nn.Module:
    """Index into an ``nn.Sequential`` (state-dict keys '0', '1', ...)."""
    return p[i]


def conv_lrelu(p, x: torch.Tensor, slope: float = 0.05, **kw) -> torch.Tensor:
    return ops.leaky_relu(ops.conv(p, x, **kw), slope)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.05), the RFDN family's activation."""
    return ops.leaky_relu(x, 0.05)


class IMDBlock(nn.Module):
    """IMD block (JAX ``imd_block``): three 3x3 conv + LeakyReLU stages, each
    splitting off ``d_nc`` distilled channels, a 3x3 on the rest, a 1x1
    over the four distilled parts, + x."""

    def __init__(self, d_nc: int, slope: float = 0.05):
        super().__init__()
        self.d_nc, self.slope = d_nc, slope
        for name in ("conv1", "conv2", "conv3"):
            self.add_module(name, nn.Sequential(Layer()))
        self.conv4 = Layer()
        self.conv1x1 = Layer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, parts, h = self.d_nc, [], x
        for p in (self.conv1, self.conv2, self.conv3):
            c = conv_lrelu(seq(p, 0), h, self.slope)
            parts.append(c[:, :d])
            h = c[:, d:]
        parts.append(ops.conv(self.conv4, h))
        return x + ops.conv(self.conv1x1, ops.cat(parts), padding=0)


class ESA(nn.Module):
    """RFDN's enhanced spatial attention (JAX ``esa``): 1x1 down, strided
    3x3, max-pool 7/3, three 3x3s, bilinear back, + ``conv_f`` of the 1x1's
    output, 1x1 up, sigmoid gate. ``conv_f=False`` is JAX ``esa_no_f``
    (team08), which adds the 1x1's output itself."""

    def __init__(self, conv_f: bool = True):
        super().__init__()
        self.conv1 = Layer()
        self.conv_f = Layer() if conv_f else None
        for name in ("conv_max", "conv2", "conv3", "conv3_", "conv4"):
            self.add_module(name, Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1_ = ops.conv(self.conv1, x, padding=0)
        c1 = ops.conv(self.conv2, c1_, stride=2, padding=0)
        v_max = ops.max_pool2d(c1, 7, 3)
        v_range = ops.relu(ops.conv(self.conv_max, v_max))
        c3 = ops.relu(ops.conv(self.conv3, v_range))
        c3 = ops.conv(self.conv3_, c3)
        c3 = ops.interpolate(c3, size=(x.shape[2], x.shape[3]), mode="bilinear")
        cf = c1_ if self.conv_f is None else ops.conv(self.conv_f, c1_, padding=0)
        c4 = ops.conv(self.conv4, c3 + cf, padding=0)
        return x * ops.sigmoid(c4)


class RFDB(nn.Module):
    """Residual feature distillation block (JAX ``rfdb``).

    ``residual=False`` is the pruned variant (models 8, 40) whose 3x3
    branch drops its ``+ h``; ``dilations=(1, 2, 5)`` is model 13's. Only
    the default path is ported: the JAX package can fuse each 1x1/3x3
    sibling pair into one conv (``fuse_parallel_branches("rfdb")``), but
    that setting is off in every tier (it measured a regression there), so
    nothing is lost.
    """

    def __init__(self, esa: Optional[nn.Module] = None, residual: bool = True,
                 dilations=(1, 1, 1), slope: float = 0.05):
        super().__init__()
        self.residual, self.dilations, self.slope = residual, tuple(dilations), slope
        for i in (1, 2, 3):
            self.add_module(f"c{i}_d", Layer())
            self.add_module(f"c{i}_r", Layer())
        self.c4 = Layer()
        self.c5 = Layer()
        self.esa = ESA() if esa is None else esa

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, distilled = x, []
        for i, dil in zip((1, 2, 3), self.dilations):
            distilled.append(conv_lrelu(getattr(self, f"c{i}_d"), h, self.slope, padding=0))
            r = ops.conv(getattr(self, f"c{i}_r"), h, dilation=dil)
            h = ops.leaky_relu(r + h if self.residual else r, self.slope)
        r4 = conv_lrelu(self.c4, h, self.slope)
        return self.esa(ops.conv(self.c5, ops.cat(distilled + [r4]), padding=0))


class RFDNSkeleton(nn.Module):
    """The RFDN skeleton (JAX ``rfdn_apply``): ``fea_conv``, ``num_modules``
    blocks, a 1x1 fusing their outputs (``c.0``, then ``fuse_act``),
    ``LR_conv`` + the long skip, 3x3 to 3 * ``upscale``**2 channels and
    PixelShuffle. NHWC in, NHWC out; ``block()`` makes one block, named
    ``{prefix}1``, ``{prefix}2``, ... as the cache names them."""

    def __init__(self, block: Callable[[], nn.Module], num_modules: int = 4, upscale: int = 4,
                 fuse_act: Callable[[torch.Tensor], torch.Tensor] = lrelu, prefix: str = "B"):
        super().__init__()
        self.num_modules, self.upscale, self.fuse_act = num_modules, upscale, fuse_act
        self.prefix = prefix
        self.fea_conv = Layer()
        for i in range(1, num_modules + 1):
            self.add_module(f"{prefix}{i}", block())
        self.c = nn.Sequential(Layer())
        self.LR_conv = Layer()
        self.upsampler = nn.Sequential(Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = ops.conv(self.fea_conv, ops.from_nhwc(x))
        h, outs = fea, []
        for i in range(1, self.num_modules + 1):
            h = getattr(self, f"{self.prefix}{i}")(h)
            outs.append(h)
        h = self.fuse_act(ops.conv(seq(self.c, 0), ops.cat(outs), padding=0))
        h = ops.conv(self.LR_conv, h) + fea
        return upsample(self.upsampler, h, self.upscale)


def upsample(p: nn.Sequential, h: torch.Tensor, upscale: int) -> torch.Tensor:
    """The pixel-shuffle tail on stock ops, NHWC out: 3x3 conv ``p[0]``,
    then PixelShuffle(``upscale``)."""
    return ops.to_nhwc(ops.pixel_shuffle(ops.conv(seq(p, 0), h), upscale))
