"""Overlap-tiled inference (counterpart of ``ntire2022_esr_tpu/harness/tiling.py``;
reference test_demo.py:364-391 semantics).

For models whose whole-image footprint exceeds memory, the image is swept
with overlapping tiles and the outputs are blended: every output pixel is
the mean of the tile forwards that covered it (the reference's E / W
canvases). The tiles of a chunk of ``max_tiles_per_call`` are gathered
into one batch, so the model's kernels see one launch per chunk.

``ChunkedTiler`` (the serving tiler) is not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch


def _tile_starts(size: int, tile: int, stride: int) -> List[int]:
    return list(range(0, size - tile, stride)) + [size - tile]


def tiled_apply(
    model: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    tile: int,
    tile_overlap: int = 32,
    scale: int = 4,
    max_tiles_per_call: int = 16,
) -> torch.Tensor:
    """Run ``model`` (NHWC -> NHWC, x``scale``) over overlapping tiles of
    the single image ``x`` and blend them with equal weights.

    Each chunk's outputs are added into the canvases before the next chunk
    runs, so live memory is one chunk of outputs plus the canvases.
    """
    n, h, w, _ = x.shape
    if n != 1:
        raise ValueError(f"tiled_apply expects a single image (N==1); got N={n}")
    tile = min(tile, h, w)
    stride = tile - tile_overlap
    coords = [(hi, wi) for hi in _tile_starts(h, tile, stride)
              for wi in _tile_starts(w, tile, stride)]
    ts = tile * scale
    e = cov = None
    chunk_size = max(1, max_tiles_per_call)
    for start in range(0, len(coords), chunk_size):
        chunk = coords[start:start + chunk_size]
        patches = torch.stack([x[0, hi:hi + tile, wi:wi + tile, :] for hi, wi in chunk])
        outs = model(patches)  # (T, tile*s, tile*s, C)
        if e is None:
            e = torch.zeros((1, h * scale, w * scale, outs.shape[-1]), dtype=outs.dtype,
                            device=outs.device)
            cov = torch.zeros((1, h * scale, w * scale, 1), dtype=outs.dtype, device=outs.device)
        for t, (hi, wi) in enumerate(chunk):
            oh, ow = hi * scale, wi * scale
            e[0, oh:oh + ts, ow:ow + ts] += outs[t]
            cov[0, oh:oh + ts, ow:ow + ts] += 1.0
    return e / cov


def forward(
    model: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    tile: Optional[int] = None,
    tile_overlap: int = 32,
    scale: int = 4,
    max_tiles_per_call: int = 16,
) -> torch.Tensor:
    """Whole-image or tiled forward: the reference ``forward`` contract."""
    if tile is None:
        return model(x)
    return tiled_apply(model, x, tile, tile_overlap, scale, max_tiles_per_call=max_tiles_per_call)
