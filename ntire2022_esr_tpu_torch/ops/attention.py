"""Attention primitives of the transformer-hybrid zoo models (counterpart of
``ntire2022_esr_tpu/ops/attention.py``).

Used by MobileSR (20: plain windows), HNCT (12) and IMDTN (09: Swin
windows with a relative-position bias and shift masks) and SCET (30: MDTA
channel attention). Windows are the batch dimension of one batched
``torch.matmul``; tokens are (B, N, C), taken from NHWC views of the
port's channels-last activations.

The dtypes follow JAX's promotion, which the port reproduces: a 2-byte
score tensor plus the f32 relative-position bias (or mask, or times SCET's
f32 ``temperature``) becomes f32, and ``config.attn_bf16`` then rounds it
through bf16 or f16. A Python scalar that meets a tensor is first rounded
to its dtype, as JAX rounds a weakly typed scalar. Products of 2-byte
operands with ``preferred_element_type=f32`` are exact in f32, so they run
as an f32 ``torch.matmul`` of the upcast operands (TF32 is off).

The shift masks and the relative-position index are host-side numpy, as in
the JAX package; :func:`shift_mask` keeps one device copy per shape, made
at the first (warm-up) forward, so that a CUDA-graph capture copies
nothing from the host.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.ops import nn


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as a JAX einsum computes it: in the promoted dtype of the
    two operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    scale: Optional[float] = None,
    rel_bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    site: str = "mha",
) -> torch.Tensor:
    """Batched MHA over (B, N, C) tokens.

    ``rel_bias``: (heads, N, N) added to the logits. ``mask``: (nW, N, N)
    added per window group (B a multiple of nW; the Swin shift mask
    layout). ``site``: the model's key in ``config.attn_bf16``.
    """
    b, n, c = q.shape
    d = c // num_heads
    if scale is None:
        scale = d ** -0.5

    def split(t):
        return t.reshape(b, n, num_heads, d).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    attn = _matmul(qh, kh.transpose(-2, -1))
    attn = attn * nn._rn(scale, attn.dtype)
    if rel_bias is not None:
        attn = attn + rel_bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(b // nw, nw, num_heads, n, n) + mask[None, :, None]
        attn = attn.reshape(b, num_heads, n, n)
    ab = config.attn_bf16(site)
    store = torch.float16 if ab == "scores_f16" else torch.bfloat16
    if ab in ("scores", "scores_f16") and attn.dtype == torch.float32:
        attn = attn.to(store).float()
    probs = nn.softmax(attn, -1)
    if ab in ("probs", "scores", "scores_f16") and probs.dtype == torch.float32:
        # 2-byte probabilities times 2-byte v, each product exact in f32
        out = torch.matmul(probs.to(store).float(), vh.to(store).float())
    else:
        out = _matmul(probs, vh)
    return out.transpose(1, 2).reshape(b, n, c)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C); H, W must be multiples of ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).transpose(2, 3)
    return x.reshape(b * (h // ws) * (w // ws), ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).transpose(2, 3)
    return x.reshape(b, h, w, c)


def pad_to_multiple(x: torch.Tensor, m: int) -> Tuple[torch.Tensor, int, int]:
    """Zero-pad (B, H, W, C) at the bottom and right so that H and W are
    multiples of ``m``."""
    _, h, w, _ = x.shape
    pad_b = (m - h % m) % m
    pad_r = (m - w % m) % m
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    return x, pad_b, pad_r


def swin_shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Swin SW-MSA attention mask, (nW, ws*ws, ws*ws) with 0 / -100 entries
    (the reference's ``calculate_mask``)."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    m = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5)
    m = m.reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def shift_mask(h: int, w: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    """:func:`swin_shift_mask` on ``device``, made once per shape."""
    return torch.from_numpy(swin_shift_mask(h, w, ws, shift)).to(device)


def relative_position_index(ws: int) -> np.ndarray:
    """Swin relative position index table, (ws*ws, ws*ws) ints."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def mdta_channel_attention(p, x: torch.Tensor, num_heads: int,
                           temperature: torch.Tensor) -> torch.Tensor:
    """Restormer MDTA (SCET): attention over the channel dimension with
    L2-normalised q and k and a learned f32 ``temperature``. ``p`` holds
    the layers ``qkv`` (1x1), ``qkv_dwconv`` (depthwise 3x3) and
    ``project_out`` (1x1). NCHW (channels_last) in and out."""
    n, c, h, w = x.shape
    qkv = nn.conv(p.qkv, x, padding=0)
    qkv = nn.conv(p.qkv_dwconv, qkv, groups=qkv.shape[1])
    d = c // num_heads

    def split(t):  # (n, c, h, w) -> (n, heads, d, h*w), the channel-token layout
        return t.reshape(n, num_heads, d, h * w)

    def l2_normalize(t):
        norm = torch.sqrt((t * t).sum(-1, keepdim=True, dtype=torch.float32).to(t.dtype))
        return t / torch.clamp_min(norm, nn._rn(1e-12, t.dtype))

    qh, kh, vh = (split(t) for t in qkv.split(c, dim=1))
    attn = _matmul(l2_normalize(qh), l2_normalize(kh).transpose(-2, -1))
    attn = attn * temperature.reshape(num_heads, 1, 1)
    out = _matmul(nn.softmax(attn, -1), vh)
    out = out.reshape(n, c, h, w).contiguous(memory_format=nn.CL)
    return nn.conv(p.project_out, out, padding=0)
