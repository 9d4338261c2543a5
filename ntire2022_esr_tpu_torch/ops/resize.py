"""Nearest, bilinear and bicubic resize (counterpart of ``ntire2022_esr_tpu/ops/resize.py``).

``F.interpolate`` is not the function the JAX package computes: it builds
the row and column weight matrices on the host (torch ``align_corners=
False`` semantics), casts them to the activation dtype, and contracts the
activation with them. Under ``fasthi16`` the matrices are therefore f16.
This module copies that construction and rounding: matrices rounded to
``x.dtype``, each product accumulated in f32 and rounded to ``x.dtype``.
Bicubic is torch's (a = -0.75, the taps clamped at the border), as the
global residuals of models 11, 23 and 42 use it. Nearest at an integer
factor repeats each pixel, as the JAX op does; no value changes.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ntire2022_esr_tpu_torch.ops.nn import CL

IntOr2 = Union[int, Tuple[int, int]]


def _cubic_torch(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch's cubic convolution kernel."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(ax <= 1, (a + 2) * ax3 - (a + 3) * ax2 + 1,
                    np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0))


@functools.lru_cache(maxsize=512)
def _torch_resize_matrix(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """(out_size, in_size) weight matrix matching torch interpolate."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if mode == "nearest":
        src = np.clip(np.floor(dst * scale).astype(np.int64), 0, in_size - 1)
        m[np.arange(out_size), src] = 1.0
        return m.astype(np.float32)
    src = (dst + 0.5) * scale - 0.5
    if mode == "bilinear":
        x0 = np.floor(src).astype(np.int64)
        lam = src - x0
        for tap, w in ((x0, 1.0 - lam), (x0 + 1, lam)):
            idx = np.clip(tap, 0, in_size - 1)
            np.add.at(m, (np.arange(out_size), idx), w)
        return m.astype(np.float32)
    if mode == "bicubic":
        x0 = np.floor(src).astype(np.int64)
        t = src - x0
        for k in range(-1, 3):  # the 4 taps around src
            idx = np.clip(x0 + k, 0, in_size - 1)
            np.add.at(m, (np.arange(out_size), idx), _cubic_torch(t - k))
        return m.astype(np.float32)
    raise ValueError(f"unknown mode {mode!r}")


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int, mode: str, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """The matrix rounded to ``dtype``, held in f32 on ``device``."""
    m = torch.from_numpy(_torch_resize_matrix(in_size, out_size, mode))
    return m.to(dtype).to(device=device, dtype=torch.float32)


def interpolate(x: torch.Tensor, size: Optional[IntOr2] = None,
                scale_factor: Optional[float] = None, mode: str = "bilinear") -> torch.Tensor:
    """torch.nn.functional.interpolate (align_corners=False) semantics on an
    NCHW tensor, computed as the JAX package computes it: ``nearest``,
    ``bilinear`` or ``bicubic``, to ``size`` or to ``int(side *
    scale_factor)``."""
    n, c, h, w = x.shape
    if size is None:
        size = (int(h * scale_factor), int(w * scale_factor))
    oh, ow = (size, size) if isinstance(size, int) else size
    if (oh, ow) == (h, w):
        return x
    if mode == "nearest" and oh % h == 0 and ow % w == 0:
        y = x.repeat_interleave(oh // h, dim=2).repeat_interleave(ow // w, dim=3)
        return y.contiguous(memory_format=CL)
    wh = _resize_weights(h, oh, mode, x.dtype, x.device)
    ww = _resize_weights(w, ow, mode, x.dtype, x.device)
    y = torch.matmul(wh, x.float()).to(x.dtype)             # (n, c, oh, w)
    y = torch.matmul(y.float(), ww.t()).to(x.dtype)         # (n, c, oh, ow)
    return y.contiguous(memory_format=CL)
