"""The one generator of traffic: uint8 frames from a seed.

A mix's ``frames`` entry gives ``count``, ``height``, ``width`` and
``channels``. Every frame is a smooth random field (a coarse grid of
uniform values, one every :data:`CELL` pixels, resized bicubically) plus
uniform detail of amplitude :data:`DETAIL`, mapped into [0.1, 0.9] of the
uint8 range before the detail, so that few outputs saturate and the
comparison with the reference sees the whole range. A seed fixes every
frame; every seed gives the same sizes. The frames are made on
``device`` with a ``torch.Generator`` there, in a few large calls.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

CELL = 16  # pixels between the coarse field's values
DETAIL = 0.12  # amplitude of the uniform detail, as a share of the range


def make(spec: Dict, seed: int, device) -> torch.Tensor:
    """(count, height, width, channels) uint8 frames on ``device``."""
    n, h, w, c = (int(spec[k]) for k in ("count", "height", "width", "channels"))
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    coarse = torch.rand((n, c, h // CELL + 2, w // CELL + 2), generator=g, device=device)
    base = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)
    noise = torch.rand((n, c, h, w), generator=g, device=device) - 0.5
    img = (0.1 + 0.8 * base.clamp(0, 1) + DETAIL * noise).clamp(0, 1)
    return torch.round(img * 255.0).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
