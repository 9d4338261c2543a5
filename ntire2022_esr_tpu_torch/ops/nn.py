"""Core primitives of the ported models (counterpart of ``ntire2022_esr_tpu/ops/nn.py``).

Layout: the public boundary is NHWC like the JAX package's; inside,
activations are NCHW-shaped tensors in ``torch.channels_last`` memory, so
the bytes are NHWC (what the CUDA kernels read) while ``F.conv2d`` and
``F.max_pool2d`` run natively. Conv weights are torch OIHW.

The numerics follow the JAX ops: convolutions and linears contract in the
tier's compute dtype, and every output goes through ``store_out`` — a
saturating round into the storage dtype under the storage tiers. Under
``fast`` and ``fast16`` the contraction's output is rounded to bf16 or f16
first and the bias, rounded to it too, is added after: two roundings, as
the JAX ops compute ``out + b.astype(out.dtype)``. Reductions of 2-byte
tensors sum in f32, as ``jnp.sum`` and ``jnp.mean`` do, and a Python
scalar that meets a 2-byte tensor is first rounded to its dtype, as JAX
rounds a weakly typed scalar.
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
    # an f32 bias inside the f32 conv is the same f32 add as after it; a
    # 2-byte one comes after the output's own rounding (two roundings)
    fused = b is not None and not nm.two_byte_compute
    out = F.conv2d(cast_compute(x, cdt), cast_compute(w, cdt), b if fused else None,
                   stride=_pair(stride), padding=_pair(padding), dilation=d, groups=groups)
    if b is not None and not fused:
        out = out + b.to(cdt).reshape(1, -1, 1, 1)
    return store_out(out, nm).contiguous(memory_format=CL)


def conv(p: torch.nn.Conv2d, x: torch.Tensor, **kw) -> torch.Tensor:
    """Apply the weights of conv layer ``p`` through :func:`conv2d` (its
    own ``forward`` would skip the tier's store rounding)."""
    return conv2d(x, p.weight, getattr(p, "bias", None), **kw)


def linear_tokens(p: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Dense layer on the last axis of ``x`` (tokens (B, N, C) or NHWC):
    the cache stores the weight (in, out), as the JAX package does, not
    torch's (out, in). Contracts in the compute dtype; bias and rounding as
    :func:`conv2d`."""
    nm = config.numerics()
    cdt = nm.compute_dtype
    out = torch.matmul(cast_compute(x, cdt), cast_compute(p.weight, cdt))
    b = getattr(p, "bias", None)
    if b is not None:
        out = out + b.to(cdt)
    return store_out(out, nm)


def linear(p: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """:func:`linear_tokens` on the channel axis of an NCHW (channels_last)
    tensor."""
    return linear_tokens(p, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2).contiguous(memory_format=CL)


def _rn(v: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX rounds a weakly typed one to ``dtype``."""
    return float(torch.tensor(v, dtype=dtype))


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch.nn.GELU()'s default."""
    return F.gelu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 6)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``exp(x - max) / sum``, as ``jax.nn.softmax`` computes it: the sum
    of a 2-byte tensor in f32, then rounded to its dtype."""
    u = torch.exp(x - x.amax(dim, keepdim=True))
    return u / u.sum(dim, keepdim=True, dtype=torch.float32).to(u.dtype)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for f16 tensors (their sums overflow f16), else their own."""
    return torch.float32 if x.dtype == torch.float16 else x.dtype


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1), keeping the spatial dims: the mean of a 2-byte
    tensor summed and divided in f32, then rounded once."""
    return x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=(2, 3), keepdim=True)


def spatial_std(x: torch.Tensor, ddof: int, acc: torch.dtype) -> torch.Tensor:
    """The spatial standard deviation as the JAX models compute it in
    ``acc``: mean, ``(x - mean) ** 2``, their sum (each rounded to ``acc``,
    sums in f32), divided by ``H*W - ddof`` (at least 1) rounded to
    ``acc``, square root, then ``x.dtype``."""
    xa = x.to(acc)
    mean = xa.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(acc)
    d = xa - mean
    n = max(x.shape[2] * x.shape[3] - ddof, 1)
    var = (d * d).sum(dim=(2, 3), keepdim=True, dtype=torch.float32).to(acc) / _rn(n, acc)
    return torch.sqrt(var).to(x.dtype)


def global_std_pool(x: torch.Tensor) -> torch.Tensor:
    """torch.std over the spatial dims (unbiased), accumulated in f32 for
    f16 inputs and in bf16 for bf16 ones, as the JAX op does."""
    return spatial_std(x, 1, _acc_dtype(x))


def batch_norm(p: torch.nn.Module, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm2d from the running statistics of layer
    ``p`` (and its ``weight`` and ``bias`` where it has them):
    ``(x - mean) * rsqrt(var + eps) * weight + bias``. The statistics and
    the affine terms are first rounded to ``x.dtype``, as the JAX op casts
    them (and ``eps``, as JAX rounds a weakly typed scalar); the arithmetic
    is f32, rounded once to ``x.dtype``."""
    def term(name):
        t = getattr(p, name, None)
        return None if t is None else t.to(x.dtype).float().reshape(1, -1, 1, 1)

    out = (x.float() - term("running_mean")) * torch.rsqrt(term("running_var") + _rn(eps, x.dtype))
    w, b = term("weight"), term("bias")
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out.to(x.dtype).contiguous(memory_format=CL)


def layer_norm(p: torch.nn.Module, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, op by op as the JAX op computes it in
    ``x.dtype``: the mean (a 2-byte tensor summed and divided in f32, then
    rounded), ``(x - mean) ** 2`` and its mean, ``rsqrt(var + eps)`` with
    ``eps`` rounded to ``x.dtype`` (1e-5 is subnormal in f16), then the
    weight and bias of ``p`` cast to ``x.dtype``."""
    mean = x.mean(-1, keepdim=True, dtype=torch.float32).to(x.dtype)
    d = x - mean
    var = (d * d).mean(-1, keepdim=True, dtype=torch.float32).to(x.dtype)
    out = d * torch.rsqrt(var + _rn(eps, x.dtype))
    w, b = getattr(p, "weight", None), getattr(p, "bias", None)
    if w is not None:
        out = out * w.to(x.dtype)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """torch channel_shuffle: channel ``i * (C/g) + j`` goes to ``j * g + i``."""
    n, c, h, w = x.shape
    return (x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)
            .contiguous(memory_format=CL))


def mean_shift(x: torch.Tensor, rgb_range: float, sign: int = -1,
               rgb_mean=(0.4488, 0.4371, 0.4040), rgb_std=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """EDSR's MeanShift, ``x / std + sign * rgb_range * mean / std``, in
    ``x.dtype``."""
    std = torch.tensor(rgb_std, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    mean = torch.tensor(rgb_mean, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    return x / std + _rn(sign * rgb_range, x.dtype) * mean / std


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
