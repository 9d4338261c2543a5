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

:func:`imresize_matlab` and :func:`imresize_matlab_np` are MATLAB's
antialiased bicubic ``imresize`` (a = -0.5, the kernel widened by ``1 /
scale`` on a downscale, symmetric boundary), the reference's
``utils_image.imresize``: the JAX package's weight matrices, applied as
two f32 products on the tensor's device or in f64 with numpy.
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


def _cubic_matlab(x: np.ndarray) -> np.ndarray:
    return _cubic_torch(x, a=-0.5)


@functools.lru_cache(maxsize=512)
def _matlab_resize_matrix(in_size: int, out_size: int, scale: Optional[float] = None,
                          antialias: bool = True) -> np.ndarray:
    """(out_size, in_size) MATLAB imresize weights (the reference's
    ``calculate_weights_indices``). ``scale`` is the requested factor:
    MATLAB maps the coordinates with it, not with ``out_size / in_size``
    (they differ where the output size is rounded up: 37 * 0.25 -> 10)."""
    if scale is None:
        scale = out_size / in_size
    kernel_width = 4.0
    if scale < 1 and antialias:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_size + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :]  # 1-based
    dist = u[:, None] - indices
    if scale < 1 and antialias:
        weights = scale * _cubic_matlab(dist * scale)
    else:
        weights = _cubic_matlab(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # symmetric boundary: out-of-range indices reflect
    aux = np.concatenate([np.arange(in_size), np.arange(in_size - 1, -1, -1)])
    idx = aux[np.mod(indices.astype(np.int64) - 1, 2 * in_size)]
    m = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(m, (np.repeat(np.arange(out_size), p), idx.ravel()), weights.ravel())
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int, mode: str, dtype: torch.dtype,
                    device: torch.device, scale: Optional[float] = None) -> torch.Tensor:
    """The matrix rounded to ``dtype``, held in f32 on ``device``: torch's
    for ``mode``, or MATLAB's for ``mode="matlab"`` at ``scale``."""
    if mode == "matlab":
        m = _matlab_resize_matrix(in_size, out_size, scale)
    else:
        m = _torch_resize_matrix(in_size, out_size, mode)
    return torch.from_numpy(m).to(dtype).to(device=device, dtype=torch.float32)


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


def imresize_matlab(x: torch.Tensor, scale: float) -> torch.Tensor:
    """MATLAB's antialiased bicubic resize by ``scale`` of an NHWC (or HWC)
    tensor, on its device, to ``ceil(side * scale)``: the weight matrices
    rounded to ``x.dtype``, each of the two products (rows, then columns)
    an f32 matmul (TF32 off) rounded to ``x.dtype``, as the JAX op
    contracts."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n, h, w, c = x.shape
    oh, ow = int(np.ceil(h * scale)), int(np.ceil(w * scale))
    wh = _resize_weights(h, oh, "matlab", x.dtype, x.device, scale)
    ww = _resize_weights(w, ow, "matlab", x.dtype, x.device, scale)
    y = torch.matmul(wh, x.float().reshape(n, h, w * c)).to(x.dtype)   # (n, oh, w*c)
    y = torch.matmul(ww, y.float().reshape(n, oh, w, c)).to(x.dtype)   # (n, oh, ow, c)
    return y[0] if squeeze else y


def imresize_matlab_np(img: np.ndarray, scale: float) -> np.ndarray:
    """The same resize on the host in float64, HWC or HW in, float32 out."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    oh, ow = int(np.ceil(h * scale)), int(np.ceil(w * scale))
    mh = _matlab_resize_matrix(h, oh, scale).astype(np.float64)
    mw = _matlab_resize_matrix(w, ow, scale).astype(np.float64)
    out = np.einsum("oh,hwc->owc", mh, img.astype(np.float64))
    out = np.einsum("pw,owc->opc", mw, out).astype(np.float32)
    return out[:, :, 0] if squeeze else out
