"""Core primitives of the ported models (counterpart of ``ntire2022_esr_tpu/ops/nn.py``).

Layout: the public boundary is NHWC like the JAX package's; inside,
activations are NCHW-shaped tensors in ``torch.channels_last`` memory, so
the bytes are NHWC (what the CUDA kernels read) while ``F.conv2d`` and
``F.max_pool2d`` run natively. Conv weights are torch OIHW.

The numerics follow the JAX ops: convolutions contract in the tier's
compute dtype, and every conv output goes through ``store_out`` — a
saturating round into the storage dtype under the storage tiers.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ntire2022_esr_tpu_torch import config

IntOr2 = Union[int, Tuple[int, int]]
CL = torch.channels_last


def _pair(v: IntOr2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def from_nhwc(a: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW-shaped channels_last tensor over the same bytes
    (a view when ``a`` is contiguous)."""
    return a.permute(0, 3, 1, 2).contiguous(memory_format=CL)


def to_nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW-shaped tensor -> NHWC view (contiguous when ``t`` is channels_last)."""
    return t.permute(0, 2, 3, 1)


# f16 overflow guard (JAX ops/nn.py:82-119): every cast into float16
# saturates at the largest finite value instead of turning into inf.
F16_MAX = 65504.0


def cast_compute(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast to ``dtype``, saturating (not inf-ing) into float16."""
    if dtype == torch.float16 and a.dtype != torch.float16:
        a = a.clamp(-F16_MAX, F16_MAX)
    return a.to(dtype)


def saturate_f16(out: torch.Tensor) -> torch.Tensor:
    """Clamp f16 overflow (inf) to the largest finite f16."""
    if out.dtype == torch.float16:
        return out.clamp(-F16_MAX, F16_MAX)
    return out


def store_out(out: torch.Tensor, nm: config.Numerics) -> torch.Tensor:
    """Contraction epilogue: clamp f16 overflow, then round into the
    storage dtype when the tier separates storage from compute."""
    out = saturate_f16(out)
    sd = nm.storage_dtype
    if sd is not None and out.dtype != sd:
        out = cast_compute(out, sd)
    return out


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: IntOr2 = 1,
    padding: Optional[IntOr2] = None,
    dilation: IntOr2 = 1,
    groups: int = 1,
) -> torch.Tensor:
    """2-D convolution, NCHW (channels_last) x OIHW -> NCHW (channels_last).

    ``padding=None`` is torch's ``dilation * (k // 2)`` ('same' for odd
    kernels at stride 1); an int or pair is explicit symmetric zero padding.
    """
    if w.dtype == torch.int8:
        raise NotImplementedError("int8 (w8-tier) weights are not ported yet")
    kh, kw = int(w.shape[2]), int(w.shape[3])
    d = _pair(dilation)
    if padding is None:
        padding = (d[0] * (kh // 2), d[1] * (kw // 2))
    nm = config.numerics()
    cdt = nm.compute_dtype
    out = F.conv2d(cast_compute(x, cdt), cast_compute(w, cdt),
                   None if b is None else b.to(cdt),
                   stride=_pair(stride), padding=_pair(padding), dilation=d, groups=groups)
    return store_out(out, nm).contiguous(memory_format=CL)


def conv(p: torch.nn.Conv2d, x: torch.Tensor, **kw) -> torch.Tensor:
    """Apply the weights of conv layer ``p`` through :func:`conv2d` (its
    own ``forward`` would skip the tier's store rounding)."""
    return conv2d(x, p.weight, p.bias, **kw)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """``x if x >= 0 else x * slope``, with the slope first rounded to
    ``x.dtype`` as JAX rounds a weakly typed Python scalar (0.05 becomes
    0.0499878 in f16); the product is then taken in f32 and rounded."""
    return F.leaky_relu(x, float(torch.tensor(negative_slope, dtype=x.dtype)))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def prelu(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """torch PReLU, ``x if x >= 0 else x * w``, with the slope (one per
    channel, or a single one) first cast to ``x.dtype`` as the JAX op does."""
    return torch.where(x >= 0, x, x * w.to(x.dtype).reshape(1, -1, 1, 1))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def cat(ts) -> torch.Tensor:
    """Concatenate along channels; the result is channels_last like every
    activation between layers."""
    return torch.cat(list(ts), dim=1).contiguous(memory_format=CL)


def max_pool2d(x: torch.Tensor, kernel: IntOr2, stride: IntOr2, padding: IntOr2 = 0) -> torch.Tensor:
    """torch max pooling in floor mode."""
    return F.max_pool2d(x, _pair(kernel), _pair(stride), _pair(padding))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space in torch's channel-major order:
    out[n, c, h*r+i, w*r+j] == x[n, c*r*r + i*r + j, h, w]."""
    return F.pixel_shuffle(x, r).contiguous(memory_format=CL)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Space-to-depth, the inverse of :func:`pixel_shuffle` (the JAX op's
    channel order is torch's): out[n, c*r*r + i*r + j, h, w] ==
    x[n, c, h*r+i, w*r+j]."""
    return F.pixel_unshuffle(x, r).contiguous(memory_format=CL)
