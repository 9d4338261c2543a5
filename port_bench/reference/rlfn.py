"""Plain float32 RLFN_cut x4, written from the published architecture.

Kong et al., "Residual Local Feature Network for Efficient
Super-Resolution", CVPRW 2022 (arXiv:2205.07514); team04 of the NTIRE 2022
ESR challenge (github.com/ofsoundof/NTIRE2022_ESR, ``RLFN_cut``):

    fea = conv3x3(x)                                   3 -> 46
    h = RLFB(RLFB(RLFB(RLFB(fea))))                    46 wide
    y = PixelShuffle(4)(conv3x3(conv3x3(h) + fea))     46 -> 48 -> 3 x (4H, 4W)

    RLFB(x) = ESA(conv1x1(x + lrelu(c3(lrelu(c2(lrelu(c1(x))))))))
              c1 46 -> 48, c2 48 -> 48, c3 48 -> 46, LeakyReLU(0.05)
    ESA(x)  = x * sigmoid(c4(up(c3(maxpool7/3(c2(c1_))), HxW) + cf(c1_)))
              c1_ = conv1x1(x) 46 -> 16; c2 3x3 stride 2, no padding;
              c3 3x3; cf, c4 1x1 (16 -> 46); up: bilinear, align_corners=False

The ESA is the trimmed one that RLFN ships (no ``conv_max``, no
``conv3_``). Departures: none in the arithmetic. The input and output
are NCHW tensors in [0, 255] (the model's data range) and the output is
not clipped. Weights come from the same npz the port's registry loads
(HWIO, transposed here to OIHW).

``conv`` (default ``F.conv2d``) lets a caller count the convolutions.
This module imports nothing of the port and nothing of JAX.
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
            slope: float = 0.05, num_modules: int = 4, upscale: int = 4) -> torch.Tensor:
    """RLFN_cut on ``x`` (N, 3, H, W) in [0, 255] -> (N, 3, 4H, 4W)."""

    def c(name: str, t: torch.Tensor, stride: int = 1, padding=None) -> torch.Tensor:
        w = p[f"{name}.weight"]
        pad = w.shape[-1] // 2 if padding is None else padding
        return conv(t, w, p[f"{name}.bias"], stride, pad)

    def act(t: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(t, slope)

    def esa(b: str, t: torch.Tensor) -> torch.Tensor:
        c1_ = c(f"{b}.conv1", t)
        c1 = c(f"{b}.conv2", c1_, stride=2, padding=0)
        v_max = F.max_pool2d(c1, kernel_size=7, stride=3)
        c3 = c(f"{b}.conv3", v_max)
        c3 = F.interpolate(c3, size=t.shape[2:], mode="bilinear", align_corners=False)
        cf = c(f"{b}.conv_f", c1_)
        c4 = c(f"{b}.conv4", c3 + cf)
        return t * torch.sigmoid(c4)

    def rlfb(b: str, t: torch.Tensor) -> torch.Tensor:
        out = act(c(f"{b}.c1_r", t))
        out = act(c(f"{b}.c2_r", out))
        out = act(c(f"{b}.c3_r", out))
        out = out + t
        return esa(f"{b}.esa", c(f"{b}.c5", out))

    fea = c("fea_conv", x)
    h = fea
    for i in range(1, num_modules + 1):
        h = rlfb(f"B{i}", h)
    h = c("LR_conv", h) + fea
    return F.pixel_shuffle(c("upsampler.0", h), upscale)
