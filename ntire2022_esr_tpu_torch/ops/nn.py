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

Under the w8 tier (``porter/quant.py``) a layer holds an int8 ``weight``
and its f32 ``weight_scale``; every site that computes with a layer's
weight takes it through :func:`dequant_weight`, in the tier's compute
dtype, as the JAX ops do.
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


def block_diag_weights(blocks) -> torch.Tensor:
    """Per-branch OIHW conv weights as one block-diagonal weight: branch
    ``i`` reads its own slice of the input channels and writes its own
    slice of the output channels; every weight off the blocks is exactly
    zero, so the merged conv computes each branch's sums (JAX
    ``block_diag_weights``, in HWIO there)."""
    kh, kw = int(blocks[0].shape[2]), int(blocks[0].shape[3])
    cout = sum(int(w.shape[0]) for w in blocks)
    cin = sum(int(w.shape[1]) for w in blocks)
    dense = blocks[0].new_zeros((cout, cin, kh, kw))
    co = ci = 0
    for w in blocks:
        no, ni = co + int(w.shape[0]), ci + int(w.shape[1])
        dense[co:no, ci:ni] = w
        co, ci = no, ni
    return dense


def concat_biases(pairs, dtype: torch.dtype) -> Optional[torch.Tensor]:
    """The biases of a merged conv: ``pairs`` is ``[(bias or None, out
    width), ...]``; a branch without a bias gets zeros (on the device of
    the others), and the result is None when no branch has one."""
    if all(b is None for b, _ in pairs):
        return None
    device = next(b.device for b, _ in pairs if b is not None)
    return torch.cat([b.to(dtype) if b is not None else torch.zeros(n, dtype=dtype, device=device)
                      for b, n in pairs])


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
    ``w`` is a float weight: an int8 (w8) weight comes through
    :func:`conv` or :func:`dequant`, and a raw one raises.
    """
    if w.dtype == torch.int8:
        raise TypeError("an int8 (w8) weight reached conv2d without its scale; "
                        "apply the layer through ops.conv (or dequant it first)")
    kh, kw = int(w.shape[2]), int(w.shape[3])
    d = _pair(dilation)
    if padding is None:
        padding = (d[0] * (kh // 2), d[1] * (kw // 2))
    return _contract(F.conv2d, x, w, b, stride=_pair(stride), padding=_pair(padding),
                     dilation=d, groups=groups)


def _contract(op, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              **kw) -> torch.Tensor:
    """``op(x, w, b, **kw)`` (a torch conv) in the tier's compute dtype,
    then ``store_out``, channels_last. An f32 bias inside the f32 conv is
    the same f32 add as after it; a 2-byte one comes after the output's
    own rounding (two roundings)."""
    nm = config.numerics()
    cdt = nm.compute_dtype
    fused = b is not None and not nm.two_byte_compute
    out = op(cast_compute(x, cdt), cast_compute(w, cdt), b if fused else None, **kw)
    if b is not None and not fused:
        out = out + b.to(cdt).reshape(1, -1, 1, 1)
    return store_out(out, nm).contiguous(memory_format=CL)


def conv_transpose2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: IntOr2 = 2,
    padding: IntOr2 = 0,
    output_padding: IntOr2 = 0,
    groups: int = 1,
) -> torch.Tensor:
    """torch ``ConvTranspose2d``, NCHW (channels_last) x torch's
    ``(I, O, kh, kw)`` weight (``porter.to_torch`` un-flips the JAX
    package's HWIO taps into it), contracted in the tier's compute dtype
    by ``F.conv_transpose2d``; the bias and the rounding as :func:`conv2d`.
    ``groups=1`` only, as in the JAX op."""
    if groups != 1:
        raise NotImplementedError("conv_transpose2d supports groups=1 only")
    if w.dtype == torch.int8:
        raise TypeError("an int8 (w8) weight reached conv_transpose2d without its scale; "
                        "dequant it first (ops.nn.dequant_weight)")
    return _contract(F.conv_transpose2d, x, w, b, stride=_pair(stride), padding=_pair(padding),
                     output_padding=_pair(output_padding))


def weight_scale(p: torch.nn.Module) -> Optional[torch.Tensor]:
    """The w8 scale of layer ``p``, None where its weight is a float one."""
    return getattr(p, "weight_scale", None)


def dequant(w: torch.Tensor, scale: Optional[torch.Tensor],
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An int8 (w8) weight times its scale in ``dtype`` (the tier's compute
    dtype by default): ``q.to(dtype) * scale.to(dtype)``, one rounding of
    the exact product, as the JAX ``dequant_weight`` computes it. A float
    weight passes through unchanged; an int8 one without a scale raises."""
    if w.dtype != torch.int8:
        return w
    if scale is None:
        raise TypeError(f"an int8 (w8) weight {tuple(w.shape)} came without its weight_scale")
    dt = config.numerics().compute_dtype if dtype is None else dtype
    return w.to(dt) * scale.to(dt)


def dequant_weight(p: torch.nn.Module) -> torch.Tensor:
    """The weight of layer ``p`` as the tier computes with it: an int8
    weight dequantized in the compute dtype (:func:`dequant`), a float one
    unchanged. Every site that computes with a layer's weight goes through
    it (JAX ``ops.nn.dequant_weight``)."""
    return dequant(p.weight, weight_scale(p))


def conv(p: torch.nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    """Apply the weights of conv layer ``p`` through :func:`conv2d` (its
    own ``forward`` would skip the tier's store rounding), the weight
    dequantized under w8."""
    return conv2d(x, dequant_weight(p), getattr(p, "bias", None), **kw)


def linear_tokens(p: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Dense layer on the last axis of ``x`` (tokens (B, N, C) or NHWC):
    the cache stores the weight (in, out), as the JAX package does, not
    torch's (out, in). Contracts in the compute dtype; bias and rounding as
    :func:`conv2d`. A w8 weight (int8 (in, out), scale (1, out)) is
    dequantized first."""
    nm = config.numerics()
    cdt = nm.compute_dtype
    out = torch.matmul(cast_compute(x, cdt), cast_compute(dequant_weight(p), cdt))
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


def softmax(x: torch.Tensor, dim: Union[int, Tuple[int, ...]]) -> torch.Tensor:
    """``exp(x - max) / sum`` over ``dim`` (one axis or several, jointly),
    as ``jax.nn.softmax`` computes it: the sum of a 2-byte tensor in f32,
    then rounded to its dtype. Rounded to f16, a sum of 65520 or more is
    inf, and the result 0: a flat f16 map of 256x256 values or more."""
    u = torch.exp(x - x.amax(dim, keepdim=True))
    return u / u.sum(dim, keepdim=True, dtype=torch.float32).to(u.dtype)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for f16 tensors (their sums overflow f16), else their own."""
    return torch.float32 if x.dtype == torch.float16 else x.dtype


def avg_pool2d(x: torch.Tensor, kernel: IntOr2, stride: Optional[IntOr2] = None,
               padding: IntOr2 = 0, count_include_pad: bool = True) -> torch.Tensor:
    """torch average pooling in floor mode: ``count_include_pad`` divides
    every window by kh*kw (torch's default), else by its in-bounds pixels.
    A 2-byte tensor is summed and divided in f32, then rounded once (JAX
    sums f16 in f32, which f16's range needs at data range 255)."""
    k = _pair(kernel)
    out = F.avg_pool2d(x.float() if x.dtype in (torch.float16, torch.bfloat16) else x, k,
                       _pair(stride if stride is not None else kernel), _pair(padding),
                       count_include_pad=count_include_pad)
    return out.to(x.dtype).contiguous(memory_format=CL)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """AdaptiveAvgPool2d(1): the mean of a 2-byte tensor summed and divided
    in f32, then rounded once. ``keepdims=False`` drops the spatial dims:
    (N, C), as the JAX op on NHWC."""
    return x.mean(dim=(2, 3), keepdim=keepdims, dtype=torch.float32).to(x.dtype)


def global_max_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    return x.amax(dim=(2, 3), keepdim=keepdims)


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


def global_std_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """torch.std over the spatial dims (unbiased), accumulated in f32 for
    f16 inputs and in bf16 for bf16 ones, as the JAX op does; (N, C) with
    ``keepdims=False``."""
    s = spatial_std(x, 1, _acc_dtype(x))
    return s if keepdims else s.flatten(1)


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


def instance_norm(p: Optional[torch.nn.Module], x: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d without running statistics (torch's default): each
    sample's channels normalized by their own spatial mean and (biased)
    variance, as the JAX op computes them: the mean summed in f32 and
    rounded to ``x.dtype``, the variance in f32 and rounded, then
    ``(x - mean) * rsqrt(var + eps)`` in ``x.dtype`` (``eps`` rounded to
    it), and the affine ``weight`` and ``bias`` of ``p`` where it has them."""
    mean = x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32)
    d = x.float() - mean
    var = (d * d).mean(dim=(2, 3), keepdim=True).to(x.dtype)
    out = (x - mean.to(x.dtype)) * torch.rsqrt(var + _rn(eps, x.dtype))
    w, b = getattr(p, "weight", None), getattr(p, "bias", None)
    if w is not None:
        out = out * w.to(x.dtype).reshape(1, -1, 1, 1)
    if b is not None:
        out = out + b.to(x.dtype).reshape(1, -1, 1, 1)
    return out.contiguous(memory_format=CL)


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


def _pad(x: torch.Tensor, pad, mode: str) -> torch.Tensor:
    return F.pad(x, tuple(pad), mode=mode).contiguous(memory_format=CL)


def zero_pad2d(x: torch.Tensor, pad) -> torch.Tensor:
    """Zero padding by torch's ``(left, right, top, bottom)``."""
    return _pad(x, pad, "constant")


def reflect_pad2d(x: torch.Tensor, pad) -> torch.Tensor:
    """Reflection padding (the edge not repeated) by ``(left, right, top, bottom)``."""
    return _pad(x, pad, "reflect")


def replicate_pad2d(x: torch.Tensor, pad) -> torch.Tensor:
    """Edge padding by ``(left, right, top, bottom)``."""
    return _pad(x, pad, "replicate")
