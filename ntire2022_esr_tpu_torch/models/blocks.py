"""Shared blocks of the zoo and the reference block library (counterpart of
``ntire2022_esr_tpu/models/blocks.py``).

The zoo's: ``seq`` and ``conv_lrelu`` (RLFN), and the RFDN family's
``imd_block`` (IMDN), the ESA gates ``esa`` and ``esa_no_f``, and ``rfdb``
as modules (:class:`IMDBlock`, :class:`ESA`, :class:`RFDB`). The port's
own: :class:`Nearest2Layer` (an upsampler conv with its fused nearest-x2
weights) and :func:`wrapped` (a conv nested in a wrapper module).

The library (the reference ``basicblock.py``, which no zoo model calls):
the JAX package's functions under its names, each ``fn(p, x, ...)`` with
``p`` a module that holds the block's layers, and a module per block whose
``forward`` calls it and whose state-dict keys are the torch reference's
(:class:`ModeConv`, :class:`ResBlock`, :class:`RCABlock`, ...; KAIR's
``upsample_*``/``downsample_*`` factories are :class:`Resampler`). The
mode strings follow KAIR's ``conv`` factory, whose ``sequential`` numbers
every layer, the parameter-free ones too, and unwraps a single one: a
one-character mode holds its parameters itself (``weight``), a longer one
under each layer's index (``0.weight``). Where a mode meets ``C`` and then
``2`` or ``4`` at a same-padded 3x3 conv of stride 1, the pair runs as the
tail kernel (:func:`conv_shuffle`).

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
from ntire2022_esr_tpu_torch.ops.fused import conv_pixelshuffle, nearest2_conv_weights


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


# the buffers of Nearest2Layer's fused weights under w8, by compute dtype
_W4 = {torch.float32: "w4", torch.bfloat16: "w4_bf16", torch.float16: "w4_f16"}


class Nearest2Layer(Layer):
    """A 3x3 conv layer that upsamples by nearest x2 first
    (``ops.fused.upconv_nearest2``). When its weights are loaded it derives
    the fused form's low-resolution weights ``w4`` and bias ``b4``
    (``ops.fused.nearest2_conv_weights``) once and holds them as buffers
    outside the state dict, so every forward hands the tail kernel the same
    tensors and their packing is cached; loading another weight set makes
    new ones.

    Under w8 (an int8 ``weight`` with its ``weight_scale``) the fused
    weights depend on the compute dtype, as the JAX package derives them at
    use from the weight dequantized in it: ``w4`` from the f32 dequant,
    ``w4_bf16`` and ``w4_f16`` from the bf16 and f16 ones (each summed in
    f32). :meth:`fused_weight` gives a tier's."""

    def __init__(self):
        super().__init__()
        for name in list(_W4.values()) + ["b4"]:
            self.register_buffer(name, None, persistent=False)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        if self.weight.dim() == 4 and tuple(self.weight.shape[2:]) == (3, 3):
            scale = ops.nn.weight_scale(self)
            with torch.no_grad():
                for dt, name in _W4.items():
                    w4 = None
                    if dt == torch.float32 or scale is not None:
                        w4, self.b4 = nearest2_conv_weights(
                            ops.nn.dequant(self.weight, scale, dt), self.bias)
                    setattr(self, name, w4)

    def fused_weight(self, compute: torch.dtype) -> torch.Tensor:
        """The fused weights a tier that contracts in ``compute`` uses: its
        own under w8, else ``w4`` (which the 2-byte tiers round at use)."""
        w4 = getattr(self, _W4[compute])
        return self.w4 if w4 is None else w4


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
    """The pixel-shuffle tail, NHWC out: 3x3 conv ``p[0]``, then
    PixelShuffle(``upscale``), through :func:`conv_shuffle` (the tail
    kernel)."""
    return ops.to_nhwc(conv_shuffle(seq(p, 0), h, upscale))


# ---------------------------------------------------------------------------
# The reference block library (KAIR basicblock.py:61-591; JAX blocks.py:182-431)
# ---------------------------------------------------------------------------

def conv_shuffle(p: nn.Module, x: torch.Tensor, r: int, *, stride: int = 1,
                 padding: Optional[int] = 1) -> torch.Tensor:
    """``pixel_shuffle(conv(p, x), r)``. A 3x3 conv of stride 1, padded by 1
    (``padding=None`` is the same for a 3x3), at r = 2 or 4 runs as the
    tail kernel (``ops.fused.conv_pixelshuffle``: on a CUDA tensor it
    launches or raises; on the CPU its plain version); any other conv is
    ``ops.conv`` and then ``ops.pixel_shuffle``. Decided from the shapes."""
    w = p.weight
    if (r in (2, 4) and stride == 1 and padding in (1, None) and w.dim() == 4
            and tuple(w.shape[2:]) == (3, 3)):
        return conv_pixelshuffle(x, w, getattr(p, "bias", None), r,
                                 scale=ops.nn.weight_scale(p))
    return ops.pixel_shuffle(ops.conv(p, x, stride=stride, padding=padding), r)


def pixelshuffle_tail(p: nn.Module, x: torch.Tensor, r: int = 4) -> torch.Tensor:
    """conv (same padding) to ``out * r * r`` channels, then PixelShuffle(r)."""
    return conv_shuffle(p, x, r, padding=None)


# the parameters of the layer each mode character makes: a conv or a
# conv-transpose, BatchNorm2d (affine, with its running statistics),
# InstanceNorm2d (affine); the other characters make parameter-free layers
_MODE_PARAMS = {"C": ("weight", "bias"), "T": ("weight", "bias"),
                "B": ("weight", "bias", "running_mean", "running_var"),
                "I": ("weight", "bias")}
_MODE_CHARS = set(_MODE_PARAMS) | set("RrLl234UuvMA")
_MODE_BN_EPS = 1e-4  # the factory's BatchNorm2d(momentum=0.9, eps=1e-4)
_NEAREST = {"U": 2, "u": 3, "v": 4}
_NEAREST_OF = {"2": "U", "3": "u", "4": "v"}


def _check_mode(mode: str) -> None:
    for t in mode:
        if t not in _MODE_CHARS:
            raise NotImplementedError(f"undefined mode char: {t!r}")


def mode_conv(p: nn.Module, x: torch.Tensor, mode: str, *, negative_slope: float = 0.2,
              stride: int = 1, padding: int = 1, pool_kernel: int = 3,
              pool_stride: Optional[int] = None) -> torch.Tensor:
    """The layers a mode string like ``"CBR"`` describes, applied with the
    parameters ``p`` holds (itself for one character, its child ``str(i)``
    for the i-th of several): C conv, T conv-transpose, B BatchNorm
    (eps 1e-4), I InstanceNorm, R/r ReLU, L/l LeakyReLU, 2/3/4
    PixelShuffle, U/u/v nearest x2/x3/x4, M max-pool, A average pool.
    ``stride`` and ``padding`` apply to C and T, ``pool_kernel`` and
    ``pool_stride`` to the pools. ``C`` then ``2`` or ``4`` is
    :func:`conv_shuffle`."""
    single = len(mode) == 1

    def sub(i):
        return p if single else p._modules[str(i)]

    i = 0
    while i < len(mode):
        t = mode[i]
        if t == "C" and mode[i + 1:i + 2] in ("2", "4"):
            x = conv_shuffle(sub(i), x, int(mode[i + 1]), stride=stride, padding=padding)
            i += 1
        elif t == "C":
            x = ops.conv(sub(i), x, stride=stride, padding=padding)
        elif t == "T":
            q = sub(i)
            x = ops.conv_transpose2d(x, ops.nn.dequant_weight(q), getattr(q, "bias", None),
                                     stride=stride, padding=padding)
        elif t == "B":
            x = ops.batch_norm(sub(i), x, eps=_MODE_BN_EPS)
        elif t == "I":
            x = ops.instance_norm(sub(i), x)
        elif t in ("R", "r"):
            x = ops.relu(x)
        elif t in ("L", "l"):
            x = ops.leaky_relu(x, negative_slope)
        elif t in ("2", "3", "4"):
            x = ops.pixel_shuffle(x, int(t))
        elif t in _NEAREST:
            x = ops.interpolate(x, scale_factor=_NEAREST[t], mode="nearest")
        elif t == "M":
            x = ops.max_pool2d(x, pool_kernel, pool_stride or pool_kernel)
        elif t == "A":
            x = ops.avg_pool2d(x, pool_kernel, pool_stride or pool_kernel)
        else:
            raise NotImplementedError(f"undefined mode char: {t!r}")
        i += 1
    return x


class ModeConv(Layer):
    """KAIR's ``conv(mode=...)`` factory: the layers of ``mode`` (each
    sized by the state loaded into it), applied by :func:`mode_conv` with
    the options given here. An unknown character raises
    ``NotImplementedError`` naming it."""

    def __init__(self, mode: str = "CBR", *, negative_slope: float = 0.2, stride: int = 1,
                 padding: int = 1, pool_kernel: int = 3, pool_stride: Optional[int] = None):
        _check_mode(mode)
        single = len(mode) == 1
        super().__init__(_MODE_PARAMS.get(mode, ()) if single else ())
        if not single:
            for i, t in enumerate(mode):
                if t in _MODE_PARAMS:
                    self.add_module(str(i), Layer(_MODE_PARAMS[t]))
        self.mode = mode
        self.options = dict(negative_slope=negative_slope, stride=stride, padding=padding,
                            pool_kernel=pool_kernel, pool_stride=pool_stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mode_conv(self, x, self.mode, **self.options)


def _holder(names: Sequence[str], make: Callable[[], nn.Module] = Layer) -> nn.Module:
    """A module that holds ``make()`` under each of ``names``."""
    m = nn.Module()
    for name in names:
        m.add_module(name, make())
    return m


def concat_block(fn, p, x: torch.Tensor) -> torch.Tensor:
    """ConcatBlock: ``cat([x, fn(p, x)])`` over channels."""
    return ops.cat([x, fn(p, x)])


def shortcut_block(fn, p, x: torch.Tensor) -> torch.Tensor:
    """ShortcutBlock: ``x + fn(p, x)``."""
    return x + fn(p, x)


class ConcatBlock(nn.Module):
    def __init__(self, sub: nn.Module):
        super().__init__()
        self.sub = sub

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return concat_block(lambda q, v: q(v), self.sub, x)


class ShortcutBlock(nn.Module):
    def __init__(self, sub: nn.Module):
        super().__init__()
        self.sub = sub

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return shortcut_block(lambda q, v: q(v), self.sub, x)


def res_block(p: nn.Module, x: torch.Tensor, mode: str = "CRC",
              negative_slope: float = 0.2) -> torch.Tensor:
    """ResBlock: ``x + mode_conv(p.res, x)``."""
    return x + mode_conv(p.res, x, mode, negative_slope=negative_slope)


class ResBlock(nn.Module):
    def __init__(self, mode: str = "CRC", negative_slope: float = 0.2):
        super().__init__()
        self.mode, self.negative_slope = mode, negative_slope
        self.res = ModeConv(mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return res_block(self, x, self.mode, self.negative_slope)


def ca_layer(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """CALayer: ``x`` times sigmoid(1x1(relu(1x1(global mean)))); the two
    1x1 convs are ``conv_fc.0`` and ``conv_fc.2`` (or ``p``'s own 0 and 2)."""
    fc = getattr(p, "conv_fc", p)
    y = ops.relu(ops.conv(fc._modules["0"], ops.global_avg_pool(x), padding=0))
    return x * ops.sigmoid(ops.conv(fc._modules["2"], y, padding=0))


def cca_layer(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """IMDN's contrast-aware channel attention: :func:`ca_layer` on the
    spatial standard deviation plus mean, through ``conv_du``."""
    y = ops.global_std_pool(x) + ops.global_avg_pool(x)
    y = ops.relu(ops.conv(p.conv_du._modules["0"], y, padding=0))
    return x * ops.sigmoid(ops.conv(p.conv_du._modules["2"], y, padding=0))


class CALayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_fc = _holder(("0", "2"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ca_layer(self, x)


class CCALayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_du = _holder(("0", "2"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cca_layer(self, x)


def conditional_batch_norm(p: nn.Module, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ConditionalBatchNorm2d: BatchNorm without affine (``p.bn``'s running
    statistics), then a per-sample scale and shift looked up by the int64
    class ids ``y`` in ``p.embed.weight`` (classes, 2C)."""
    out = ops.batch_norm(p.bn, x)
    emb = p.embed.weight[y.to(p.embed.weight.device)]
    c = x.shape[1]
    return emb[:, :c, None, None] * out + emb[:, c:, None, None]


class ConditionalBatchNorm2d(nn.Module):
    def __init__(self):
        super().__init__()
        self.bn = Layer(("running_mean", "running_var"))
        self.embed = Layer(("weight",))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return conditional_batch_norm(self, x, y)


def esa_basic(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The library's ESA (basicblock.py:271-295): a ``conv21`` skip, ReLU
    after ``conv3`` and ``conv4``."""
    x1 = ops.conv(p.conv1, x, padding=0)
    x2 = ops.max_pool2d(ops.conv(p.conv2, x1, stride=2, padding=0), 7, 3)
    x2 = ops.relu(ops.conv(p.conv3, x2))
    x2 = ops.relu(ops.conv(p.conv4, x2))
    x2 = ops.interpolate(ops.conv(p.conv5, x2), size=(x.shape[2], x.shape[3]), mode="bilinear")
    x2 = ops.conv(p.conv6, x2 + ops.conv(p.conv21, x1, padding=0), padding=0)
    return x * ops.sigmoid(x2)


class ESABasic(nn.Module):
    def __init__(self):
        super().__init__()
        for name in ("conv1", "conv21", "conv2", "conv3", "conv4", "conv5", "conv6"):
            self.add_module(name, Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return esa_basic(self, x)


def cfrb(p: nn.Module, x: torch.Tensor, negative_slope: float = 0.05) -> torch.Tensor:
    """CFRB: RFDB-like distillation whose residual convs keep the full
    width and whose last distill conv ``conv4_d`` is 3x3, gated by
    :func:`esa_basic`."""
    def c(name, v, padding=1):
        return mode_conv(getattr(p, name), v, "C", padding=padding)

    d1 = c("conv1_d", x, padding=0)
    x = ops.leaky_relu(c("conv1_r", x) + x, negative_slope)
    d2 = c("conv2_d", x, padding=0)
    x = ops.leaky_relu(c("conv2_r", x) + x, negative_slope)
    d3 = c("conv3_d", x, padding=0)
    x = ops.leaky_relu(c("conv3_r", x) + x, negative_slope)
    x = c("conv4_d", x)
    x = ops.leaky_relu(ops.cat([d1, d2, d3, x]), negative_slope)
    return esa_basic(p.esa, c("conv1x1", x, padding=0))


class CFRB(nn.Module):
    def __init__(self, negative_slope: float = 0.05):
        super().__init__()
        self.negative_slope = negative_slope
        for name in ("conv1_d", "conv1_r", "conv2_d", "conv2_r", "conv3_d", "conv3_r",
                     "conv4_d", "conv1x1"):
            self.add_module(name, Layer())
        self.esa = ESABasic()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cfrb(self, x, self.negative_slope)


def rcab(p: nn.Module, x: torch.Tensor, mode: str = "CRC", reduction_unused: int = 16,
         negative_slope: float = 0.2) -> torch.Tensor:
    """RCABlock: ``ca_layer(mode_conv(x)) + x`` (the reduction is in the
    loaded widths)."""
    res = mode_conv(p.res, x, mode, negative_slope=negative_slope)
    return ca_layer(p.ca, res) + x


class RCABlock(nn.Module):
    def __init__(self, mode: str = "CRC", negative_slope: float = 0.2):
        super().__init__()
        self.mode, self.negative_slope = mode, negative_slope
        self.res = ModeConv(mode)
        self.ca = CALayer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rcab(self, x, self.mode, negative_slope=self.negative_slope)


def rca_group(p: nn.Module, x: torch.Tensor, nb: int = 12, mode: str = "CRC",
              negative_slope: float = 0.2) -> torch.Tensor:
    """RCAGroup: ``nb`` RCABlocks (``rg.0`` ...) and a 3x3 conv
    (``rg.<nb>``), + x."""
    h = x
    for i in range(nb):
        h = rcab(p.rg._modules[str(i)], h, mode, negative_slope=negative_slope)
    return ops.conv(p.rg._modules[str(nb)], h) + x


class RCAGroup(nn.Module):
    def __init__(self, nb: int = 12, mode: str = "CRC", negative_slope: float = 0.2):
        super().__init__()
        self.nb, self.mode, self.negative_slope = nb, mode, negative_slope
        self.rg = _holder([str(i) for i in range(nb)], lambda: RCABlock(mode, negative_slope))
        self.rg.add_module(str(nb), Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rca_group(self, x, self.nb, self.mode, self.negative_slope)


def residual_dense_block_5c(p: nn.Module, x: torch.Tensor, mode: str = "CR",
                            negative_slope: float = 0.2) -> torch.Tensor:
    """ResidualDenseBlock_5C: four growth convs on the dense concatenation
    (mode ``"C" + mode[1:]``), a fusing conv (``"C"``), ``x5 * 0.2 + x``."""
    act = mode[1:]

    def cv(name, parts, m):
        return mode_conv(getattr(p, name), ops.cat(parts), m, negative_slope=negative_slope)

    x1 = cv("conv1", [x], "C" + act)
    x2 = cv("conv2", [x, x1], "C" + act)
    x3 = cv("conv3", [x, x1, x2], "C" + act)
    x4 = cv("conv4", [x, x1, x2, x3], "C" + act)
    x5 = cv("conv5", [x, x1, x2, x3, x4], "C")
    return x5 * ops.nn._rn(0.2, x5.dtype) + x


class ResidualDenseBlock_5C(nn.Module):
    def __init__(self, mode: str = "CR", negative_slope: float = 0.2):
        super().__init__()
        self.mode, self.negative_slope = mode, negative_slope
        for i in range(1, 5):
            self.add_module(f"conv{i}", ModeConv("C" + mode[1:]))
        self.conv5 = ModeConv("C")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return residual_dense_block_5c(self, x, self.mode, self.negative_slope)


def rrdb(p: nn.Module, x: torch.Tensor, mode: str = "CR",
         negative_slope: float = 0.2) -> torch.Tensor:
    """RRDB: three chained ResidualDenseBlock_5C, ``out * 0.2 + x``."""
    out = x
    for name in ("RDB1", "RDB2", "RDB3"):
        out = residual_dense_block_5c(getattr(p, name), out, mode, negative_slope)
    return out * ops.nn._rn(0.2, out.dtype) + x


class RRDB(nn.Module):
    def __init__(self, mode: str = "CR", negative_slope: float = 0.2):
        super().__init__()
        self.mode, self.negative_slope = mode, negative_slope
        for name in ("RDB1", "RDB2", "RDB3"):
            self.add_module(name, ResidualDenseBlock_5C(mode, negative_slope))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rrdb(self, x, self.mode, self.negative_slope)


# KAIR's upsample_* / downsample_* factories (basicblock.py:446-527): each
# is one mode string, its layers numbered as KAIR's flattening sequential
# numbers them (the pools of the downsamplers at index 0). kind -> the
# mode_conv string of its layers at the factory's mode (the factor, then
# the layers after the conv: "2R"), which the functions run and Resampler
# builds
_LAYERS = {
    "pixelshuffle": lambda m: "C" + m,
    "upconv": lambda m: _NEAREST_OF[m[0]] + "C" + m[1:],
    "convtranspose": lambda m: "T" + m[1:],
    "strideconv": lambda m: "C" + m[1:],
    "maxpool": lambda m: "MC" + m[1:],
    "avgpool": lambda m: "AC" + m[1:],
}


def upsample_pixelshuffle(p: nn.Module, x: torch.Tensor, mode: str = "2R",
                          negative_slope: float = 0.2) -> torch.Tensor:
    """3x3 conv to ``out * r * r`` channels, PixelShuffle(r) (the tail
    kernel at r = 2 and 4), then the rest of ``mode``."""
    return mode_conv(p, x, _LAYERS["pixelshuffle"](mode), negative_slope=negative_slope)


def upsample_upconv(p: nn.Module, x: torch.Tensor, mode: str = "2R",
                    negative_slope: float = 0.2) -> torch.Tensor:
    """Nearest upsampling by ``mode[0]``, then a 3x3 conv."""
    return mode_conv(p, x, _LAYERS["upconv"](mode), negative_slope=negative_slope)


def upsample_convtranspose(p: nn.Module, x: torch.Tensor, mode: str = "2R",
                           negative_slope: float = 0.2) -> torch.Tensor:
    """ConvTranspose with kernel and stride ``mode[0]``."""
    return mode_conv(p, x, _LAYERS["convtranspose"](mode), stride=int(mode[0]), padding=0,
                     negative_slope=negative_slope)


def downsample_strideconv(p: nn.Module, x: torch.Tensor, mode: str = "2R",
                          negative_slope: float = 0.2) -> torch.Tensor:
    """A conv with kernel and stride ``mode[0]``."""
    return mode_conv(p, x, _LAYERS["strideconv"](mode), stride=int(mode[0]), padding=0,
                     negative_slope=negative_slope)


def downsample_maxpool(p: nn.Module, x: torch.Tensor, mode: str = "2R", padding: int = 0,
                       negative_slope: float = 0.2) -> torch.Tensor:
    """Max-pool by ``mode[0]`` (index 0), then a 3x3 conv from index 1."""
    r = int(mode[0])
    return mode_conv(p, x, _LAYERS["maxpool"](mode), padding=padding, pool_kernel=r,
                     pool_stride=r, negative_slope=negative_slope)


def downsample_avgpool(p: nn.Module, x: torch.Tensor, mode: str = "2R", padding: int = 1,
                       negative_slope: float = 0.2) -> torch.Tensor:
    """Average pool by ``mode[0]`` (index 0), then a 3x3 conv from index 1."""
    r = int(mode[0])
    return mode_conv(p, x, _LAYERS["avgpool"](mode), padding=padding, pool_kernel=r,
                     pool_stride=r, negative_slope=negative_slope)


_RESAMPLERS = {
    "pixelshuffle": upsample_pixelshuffle, "upconv": upsample_upconv,
    "convtranspose": upsample_convtranspose, "strideconv": downsample_strideconv,
    "maxpool": downsample_maxpool, "avgpool": downsample_avgpool,
}


class Resampler(ModeConv):
    """KAIR's ``upsample_<kind>`` / ``downsample_<kind>`` factory for
    ``kind`` in ``pixelshuffle``, ``upconv``, ``convtranspose`` (up) and
    ``strideconv``, ``maxpool``, ``avgpool`` (down), at ``factory_mode``
    (the factor, then the layers after the conv: ``"2R"``)."""

    def __init__(self, kind: str, factory_mode: str = "2R", negative_slope: float = 0.2):
        super().__init__(_LAYERS[kind](factory_mode))
        self.fn = _RESAMPLERS[kind]
        self.factory_mode, self.negative_slope = factory_mode, negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self, x, self.factory_mode, negative_slope=self.negative_slope)


def non_local_block_2d(p: nn.Module, x: torch.Tensor, act_mode: str = "B",
                       downsample: bool = False) -> torch.Tensor:
    """NonLocalBlock2D, embedded Gaussian without a scale: ``x +
    W(softmax(theta(x) phi(x)^T) g(x))``, the 1x1 convs ``theta``, ``phi``
    and ``g`` (``phi.1`` and ``g.1`` after a 2x2 max-pool where
    ``downsample``), ``W`` a ``"C" + act_mode`` :class:`ModeConv`. The two
    products are f32 matmuls of the upcast operands (TF32 off), rounded to
    the activations' dtype, as the JAX einsums compute them."""
    n, _, h, w = x.shape

    def tokens(t):
        return ops.to_nhwc(t).reshape(n, -1, t.shape[1])

    theta = tokens(ops.conv(p.theta, x, padding=0))
    if downsample:
        v = ops.max_pool2d(x, 2, 2)
        phi = tokens(ops.conv(p.phi._modules["1"], v, padding=0))
        g = tokens(ops.conv(p.g._modules["1"], v, padding=0))
    else:
        phi = tokens(ops.conv(p.phi, x, padding=0))
        g = tokens(ops.conv(p.g, x, padding=0))
    f = torch.matmul(theta.float(), phi.float().transpose(1, 2)).to(theta.dtype)
    att = ops.softmax(f, -1)
    y = torch.matmul(att.float(), g.float()).to(torch.promote_types(att.dtype, g.dtype))
    y = ops.from_nhwc(y.reshape(n, h, w, -1))
    return mode_conv(p.W, y, "C" + act_mode, padding=0) + x


class NonLocalBlock2D(nn.Module):
    def __init__(self, act_mode: str = "B", downsample: bool = False):
        super().__init__()
        self.act_mode, self.downsample = act_mode, downsample
        self.theta = Layer()
        for name in ("phi", "g"):
            self.add_module(name, _holder(("1",)) if downsample else Layer())
        self.W = ModeConv("C" + act_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return non_local_block_2d(self, x, self.act_mode, self.downsample)
