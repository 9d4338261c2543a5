"""Plain float32 IMDN x4 (the NTIRE 2022 ESR baseline), written from the
published architecture.

Hui et al., "Lightweight Image Super-Resolution with Information
Multi-distillation Network", ACM MM 2019 (arXiv:1909.11856), in the form
the challenge ships as its baseline (KAIR's ``IMDN``, nc 64, nb 8):

    head = conv3x3(x)                                      3 -> 64
    h = IMDB^8(head); h = head + conv3x3(h)                64 wide
    y = PixelShuffle(4)(conv3x3(h))                        64 -> 48 -> 3 x (4H, 4W)

    IMDB(x): d1, r1 = split(lrelu(conv1(x)), 16, 48)       64 -> 64
             d2, r2 = split(lrelu(conv2(r1)), 16, 48)      48 -> 64
             d3, r3 = split(lrelu(conv3(r2)), 16, 48)      48 -> 64
             d4 = conv4(r3)                                48 -> 16, no activation
             x + conv1x1(cat(d1, d2, d3, d4))              64 -> 64

All convolutions are 3x3 with padding 1 but the 1x1; LeakyReLU slope
0.05. Departures: none in the arithmetic. The input and output are NCHW
tensors in [0, 1] (the model's data range) and the output is not
clipped. Weights come from the same npz the port's registry loads (HWIO,
transposed here to OIHW).

``conv`` as in ``rlfn.py``. This module imports nothing of
the port and nothing of JAX.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def load(path: str, device) -> Params:
    """The npz's tensors on ``device``: conv weights as OIHW float32."""
    with np.load(path) as z:
        out = {}
        for k in z.files:
            a = z[k].astype(np.float32)
            out[k] = torch.from_numpy(a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a)
    return {k: v.to(device) for k, v in out.items()}


def forward(p: Params, x: torch.Tensor, conv: Callable = F.conv2d,
            slope: float = 0.05, nb: int = 8, d_nc: int = 16, upscale: int = 4) -> torch.Tensor:
    """IMDN on ``x`` (N, 3, H, W) in [0, 1] -> (N, 3, 4H, 4W)."""

    def c(name: str, t: torch.Tensor) -> torch.Tensor:
        w = p[f"{name}.weight"]
        return conv(t, w, p[f"{name}.bias"], 1, w.shape[-1] // 2)

    def imdb(b: str, t: torch.Tensor) -> torch.Tensor:
        parts, r = [], t
        for name in ("conv1.0", "conv2.0", "conv3.0"):
            o = F.leaky_relu(c(f"{b}.{name}", r), slope)
            parts.append(o[:, :d_nc])
            r = o[:, d_nc:]
        parts.append(c(f"{b}.conv4", r))
        return t + c(f"{b}.conv1x1", torch.cat(parts, dim=1))

    head = c("model.0", x)
    h = head
    for i in range(nb):
        h = imdb(f"model.1.sub.{i}", h)
    h = head + c(f"model.1.sub.{nb}", h)
    return F.pixel_shuffle(c("model.2", h), upscale)
