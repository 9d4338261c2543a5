"""Spectral ops of NLFFC (counterpart of ``ntire2022_esr_tpu/ops/spectral.py``;
reference team02_nlffc/basicblock.py:9-32).

SpectralTx: a real FFT over the *height* axis (norm='ortho'), a 1x1 conv
on the stacked (re, im) channels, LeakyReLU, and the inverse FFT.

The transform is computed as the JAX package computes it: as products with
f32 DFT matrices built on the host from ``np.fft`` impulse responses, not
as an FFT. ``rfft_h`` is one product with the stacked ``[Fr; Fi]``;
``irfft_h`` is two products and an add under parity and one product
``[Br | Bi] @ [re; im]`` under every other tier (the longer contraction
sums in another order, so parity keeps the two). The products take f32
operands under every tier and run in f32 (TF32 is off, ``config``).

``rfft_h`` and ``irfft_h`` take and return NHWC tensors: the height axis
is then the rows of one ``(H, W*C)`` matrix per image, and the port's
channels_last activations are NHWC in memory. The matrices are cached on
each device per height; the first (warm-up) forward fills the cache, so
a CUDA graph captured after it copies nothing from the host.

The JAX package's four-step form (``NTIRE_FOUR_STEP_DFT``, off by
default) is not ported.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.ops import nn


@functools.lru_cache(maxsize=64)
def _dft_mats(h: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(Fr, Fi, Br, Bi): rfft and irfft as real f32 matrices, norm='ortho'.

    rfft(x)[f] = sum_t (Fr + i*Fi)[f, t] x[t]; irfft from (re, im):
    x[t] = Br[t, f] re[f] + Bi[t, f] im[f].
    """
    hp = h // 2 + 1
    eye = np.eye(h, dtype=np.float64)
    fwd = np.fft.rfft(eye, axis=0, norm="ortho")  # column t = rfft(e_t)
    eyec = np.eye(hp, dtype=np.complex128)
    back_re = np.stack([np.fft.irfft(eyec[:, f], n=h, norm="ortho") for f in range(hp)], axis=1)
    back_im = np.stack([np.fft.irfft(1j * eyec[:, f], n=h, norm="ortho") for f in range(hp)],
                       axis=1)
    return (fwd.real.astype(np.float32), fwd.imag.astype(np.float32),
            back_re.astype(np.float32), back_im.astype(np.float32))


@functools.lru_cache(maxsize=64)
def _device_mats(h: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``[Fr; Fi]`` (2*hp, h), Br, Bi (h, hp) and ``[Br | Bi]`` (h, 2*hp)
    on ``device``."""
    fr, fi, br, bi = (torch.from_numpy(m) for m in _dft_mats(h))
    mats = (torch.cat([fr, fi]), br, bi, torch.cat([br, bi], dim=1))
    return tuple(m.to(device) for m in mats)


# the profiler span of every DFT product (tools/forward_trace.py reads it)
SPAN = "spectral.dft"


def _rows(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("fh,nhwc->nfwc", mat, x)`` in f32."""
    n, h, w, c = x.shape
    with torch.profiler.record_function(SPAN):
        return torch.matmul(mat, x.float().reshape(n, h, w * c)).reshape(n, -1, w, c)


def rfft_h(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real FFT over the height axis of an NHWC tensor, as f32 (re, im),
    each (N, H//2 + 1, W, C): one product with the stacked ``[Fr; Fi]``
    (each output row contracts on its own, so it equals two products)."""
    h = x.shape[1]
    both = _rows(_device_mats(h, x.device)[0], x)
    hp = h // 2 + 1
    return both[:, :hp], both[:, hp:]


def irfft_h(re: torch.Tensor, im: torch.Tensor, h: int) -> torch.Tensor:
    """Inverse of :func:`rfft_h` back to height ``h``, f32 NHWC."""
    _, br, bi, b_cat = _device_mats(h, re.device)
    if config.mode() != "parity":
        return _rows(b_cat, torch.cat([re.float(), im.float()], dim=1))
    return _rows(br, re) + _rows(bi, im)


def spectral_tx(p: torch.nn.Module, x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """SpectralTx on an NCHW (channels_last) tensor: rfft over H, the 1x1
    conv ``p.conv`` on the spectrum stacked in the torch channel order
    ``[c][re|im]`` (channel ``2*ci`` is the real part of channel ``ci``,
    ``2*ci + 1`` its imaginary part), LeakyReLU(``slope``), irfft. The
    output has ``x``'s shape and dtype."""
    n, c, h, w = x.shape
    if h % 2:
        # the reference's irfft takes its default length 2*(hp-1), which is
        # h-1 for an odd h: its round trip changes the height. Every zoo use
        # has an even h (NLFFC upsamples x4 before any spectral op).
        raise NotImplementedError(
            f"spectral_tx requires even H (got {h}): the reference irfft "
            "round-trips odd heights to h-1; no zoo model reaches this")
    re, im = rfft_h(nn.to_nhwc(x))
    hp = re.shape[1]
    stacked = torch.stack([re, im], dim=-1).reshape(n, hp, w, 2 * c)
    out = nn.leaky_relu(nn.conv(p.conv, nn.from_nhwc(stacked), padding=0), slope)
    out = nn.to_nhwc(out).reshape(n, hp, w, c, 2)
    y = irfft_h(out[..., 0], out[..., 1], h).to(x.dtype)
    return nn.from_nhwc(y)
