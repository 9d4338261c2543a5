"""Overlap-tiled inference (counterpart of ``ntire2022_esr_tpu/harness/tiling.py``;
reference test_demo.py:364-391 semantics).

For models whose whole-image footprint exceeds memory, the image is swept
with overlapping tiles and the outputs are blended: every output pixel is
the mean of the tile forwards that covered it (the reference's E / W
canvases). The tiles of a chunk of ``max_tiles_per_call`` are gathered
into one batch, so the model's kernels see one launch per chunk.

:func:`tiled_apply` is the protocol path: ``runner.run`` captures it whole
as one CUDA graph per image shape. :class:`ChunkedTiler` is the serving
path: the model runs only on fixed ``(chunk, tile, tile, C)`` batches, so
one graph serves every frame shape.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ntire2022_esr_tpu_torch.harness import graphs


def _tile_starts(size: int, tile: int, stride: int) -> List[int]:
    return list(range(0, size - tile, stride)) + [size - tile]


def tiled_apply(
    model: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    tile: int,
    tile_overlap: int = 32,
    scale: int = 4,
    batch_tiles: bool = True,
    max_tiles_per_call: int = 16,
) -> torch.Tensor:
    """Run ``model`` (NHWC -> NHWC, x``scale``) over overlapping tiles of
    the single image ``x`` and blend them with equal weights.

    Each chunk's outputs are added into the canvases before the next chunk
    runs, so live memory is one chunk of outputs plus the canvases. With
    ``batch_tiles=False`` the model takes one tile a call, the image's own
    ``(1, tile, tile, C)`` slice (``max_tiles_per_call`` is then unused).
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
    chunk_size = max(1, max_tiles_per_call) if batch_tiles else 1
    for start in range(0, len(coords), chunk_size):
        chunk = coords[start:start + chunk_size]
        if batch_tiles:
            patches = torch.stack([x[0, hi:hi + tile, wi:wi + tile, :] for hi, wi in chunk])
        else:
            (hi, wi), = chunk
            patches = x[:, hi:hi + tile, wi:wi + tile, :]
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


class ChunkedTiler:
    """Overlap-tiled inference for serving frames of any shape (JAX
    ``tiling.ChunkedTiler``).

    The model sees only ``(chunk, tile, tile, C)`` batches. On a CUDA
    device they run as one CUDA graph (``graphs.GraphedForward``), captured
    at the first chunk and replayed for every chunk of every frame shape;
    the gather of the tiles and their blend into the canvases run eagerly
    for each frame. A ragged last chunk is padded with its last tile
    coordinates, and the padding is masked (weight 0: added to neither
    canvas), so the blend is :func:`tiled_apply`'s equal-weight mean. The
    canvases take the input's dtype. A frame smaller than the tile takes
    :func:`tiled_apply`'s whole-image path, eagerly, so the chunk graph
    stays alive. On the CPU the model runs eagerly.
    """

    def __init__(self, model: Callable[[torch.Tensor], torch.Tensor], tile: int,
                 tile_overlap: int = 32, scale: int = 4, chunk: int = 2):
        self._model = model
        self.tile, self.overlap, self.scale = tile, tile_overlap, scale
        self.chunk = max(1, chunk)
        self._graphed = None

    def _run_chunk(self, patches: torch.Tensor) -> torch.Tensor:
        if patches.device.type != "cuda":
            return self._model(patches)
        if self._graphed is None:
            self._graphed = graphs.GraphedForward(self._model, patches.device)
        self._graphed.prepare(patches)
        # the static output: blended below before the next replay, on the
        # same stream, overwrites it
        return self._graphed.replay()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        if n != 1:
            raise ValueError(f"ChunkedTiler expects a single image; got N={n}")
        tile = self.tile
        if tile > min(h, w):
            return tiled_apply(self._model, x, tile, self.overlap, self.scale,
                               max_tiles_per_call=self.chunk)
        stride = tile - self.overlap
        coords = [(hi, wi) for hi in _tile_starts(h, tile, stride)
                  for wi in _tile_starts(w, tile, stride)]
        sc, ts = self.scale, tile * self.scale
        e = torch.zeros((1, h * sc, w * sc, c), dtype=x.dtype, device=x.device)
        cov = torch.zeros((1, h * sc, w * sc, 1), dtype=x.dtype, device=x.device)
        for start in range(0, len(coords), self.chunk):
            batch = coords[start:start + self.chunk]
            real = len(batch)
            batch = batch + [batch[-1]] * (self.chunk - real)  # ragged: pad, then mask
            patches = torch.stack([x[0, hi:hi + tile, wi:wi + tile, :] for hi, wi in batch])
            outs = self._run_chunk(patches)
            for t, (hi, wi) in enumerate(batch[:real]):
                oh, ow = hi * sc, wi * sc
                e[0, oh:oh + ts, ow:ow + ts] += outs[t]
                cov[0, oh:oh + ts, ow:ow + ts] += 1.0
        return e / cov
