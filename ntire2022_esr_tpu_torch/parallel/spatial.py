"""Spatial (image-plane) sharding with halo exchange (counterpart of
``ntire2022_esr_tpu/parallel/spatial.py``).

For whole-image inference on large inputs the H axis is sharded across
the mesh: each device runs the model on its slab extended by an
``overlap`` halo of rows from its neighbours, then crops the halo from the
x``scale`` output. JAX moves the halo with ``ppermute`` inside a
``shard_map``; the port moves each neighbour's edge rows to the device
with ``.to(device, non_blocking=True)``, outside any captured graph.

Exact wherever ``overlap`` covers the receptive field, as overlap-tiled
inference is (harness/tiling.py, reference test_demo.py:364-391): the
image's top and bottom edges see the model's own zero padding. Models
with global spatial operators (softmax over H*W, FFT over H, pooling
grids) are not slab-decomposable (``registry.ModelSpec.slab_safe``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ntire2022_esr_tpu_torch.parallel.eval import Fn, Replicas, gather
from ntire2022_esr_tpu_torch.parallel.mesh import Mesh


class SpatialShardUnavailable(ValueError):
    """The input cannot be H-sharded over this mesh (image too small for
    the window scheme). A ValueError subclass so callers that want a
    single-device fallback can catch exactly this condition without
    swallowing errors raised inside the sharded forward."""


class SpatialApply:
    """``fn(x) -> y``, reusable: x (N, H, W, C) -> (N, H*scale, W*scale, C').

    ``batch_axis`` composes batch parallelism with the H-slab sharding on
    a 2-D mesh (``mesh.data_space_mesh``): the batch splits over
    ``batch_axis`` and each group H-shards over ``axis``; the batch must
    divide by ``mesh.shape[batch_axis]``.

    Two schemes, picked per input shape (:meth:`plan`):

    - **halo** (H divisible by the ``axis`` size n): slab i is rows
      ``[i*H/n, (i+1)*H/n)`` extended by ``overlap`` rows of each
      neighbour; the edge slabs end at the true image edge,
      ``[slab, down, dead]`` and ``[dead, up, slab]`` (``dead`` is zeros a
      full ``overlap`` of true rows away from the slab), and the crops
      start at 0, ``overlap*scale`` and ``2*overlap*scale``.
    - **windowed** (any H): each device reads its own window of
      ``ceil(H/n) + 2*overlap`` rows of the whole input, clamped to the
      image as the reference clamps its last tile, and contributes
      ``ceil(H/n)`` output rows; overlapping output rows are written twice,
      in device order.

    A space axis of size 1 runs each group's whole forward. ``fn(x)`` is
    :meth:`prepare` (the slabs and their halos placed on their devices)
    then :meth:`replay` (the slabs' forwards, the crops and the gather on
    the first entry's device). ``graphed``: each entry's forward is a CUDA
    graph per slab shape (``eval.Replicas``).
    """

    def __init__(self, model: nn.Module, mesh: Mesh, overlap: int = 32, scale: int = 4,
                 axis: str = "data", batch_axis: Optional[str] = None,
                 fn: Optional[Fn] = None, graphed: bool = False):
        self.grid = mesh.axis_grid(axis, batch_axis)  # (groups, slabs)
        self.n_batch, self.n_dev = self.grid.shape
        self._batch_axis = batch_axis
        self._overlap, self._scale = overlap, scale
        self.replicas = Replicas(model, mesh.distinct, fn, graphed)

    def plan(self, shape) -> str:
        """"whole", "halo" or "windowed" for an input of ``shape``; raises
        ``ValueError`` where the batch does not divide by the batch axis and
        :class:`SpatialShardUnavailable` where H is too small to shard."""
        n, h = shape[0], shape[1]
        if self._batch_axis and n % self.n_batch:
            raise ValueError(
                f"batch {n} must divide by the {self._batch_axis!r} mesh axis "
                f"({self.n_batch}); pad the batch (harness/serving.py does)")
        if self.n_dev == 1:
            return "whole"
        if h % self.n_dev == 0 and self._overlap <= h // self.n_dev:
            return "halo"
        s = -(-h // self.n_dev)
        if s + 2 * self._overlap > h:
            raise SpatialShardUnavailable(
                f"H={h} too small to shard over {self.n_dev} devices with overlap "
                f"{self._overlap} (window {s + 2 * self._overlap} rows exceeds the image)")
        return "windowed"

    def _halo_parts(self, x: torch.Tensor, devs) -> List[Tuple[torch.device, torch.Tensor]]:
        n, ov = self.n_dev, self._overlap
        s = x.shape[1] // n
        slabs = [x[:, i * s:(i + 1) * s].to(d, non_blocking=True) for i, d in enumerate(devs)]
        parts = []
        for i, d in enumerate(devs):
            if i > 0:
                up = slabs[i - 1][:, -ov:].to(d, non_blocking=True)
            if i < n - 1:
                down = slabs[i + 1][:, :ov].to(d, non_blocking=True)
            if i == 0:
                ext = [slabs[i], down, torch.zeros_like(down)]
            elif i == n - 1:
                ext = [torch.zeros_like(up), up, slabs[i]]
            else:
                ext = [up, slabs[i], down]
            parts.append((d, torch.cat(ext, dim=1)))
        return parts

    def _halo_crop(self, outs: List[torch.Tensor], h: int) -> List[torch.Tensor]:
        """Each slab's own rows of its output."""
        n, so, ov = self.n_dev, (h // self.n_dev) * self._scale, self._overlap * self._scale
        starts = [0] + [ov] * (n - 2) + [2 * ov]
        return [y[:, st:st + so] for y, st in zip(outs, starts)]

    def _windows(self, h: int):
        """(s, wh, a, starts): device i owns output rows [a[i], a[i] + s) of
        the LR grid and reads window rows [starts[i], starts[i] + wh)."""
        s = -(-h // self.n_dev)
        wh = s + 2 * self._overlap
        a = np.clip(np.arange(self.n_dev) * s, 0, h - s)
        starts = np.clip(a - self._overlap, 0, h - wh)
        return s, wh, a, starts

    def prepare(self, x: torch.Tensor) -> None:
        kind = self.plan(x.shape)
        n, h = x.shape[0], x.shape[1]
        bg = n // self.n_batch
        groups = [x[g * bg:(g + 1) * bg] for g in range(self.n_batch)]
        parts = []
        for g, xg in enumerate(groups):
            devs = list(self.grid[g])
            if kind == "whole":
                parts.append((devs[0], xg))
            elif kind == "halo":
                parts += self._halo_parts(xg, devs)
            else:
                _, wh, _, starts = self._windows(h)
                parts += [(d, xg[:, int(st):int(st) + wh].contiguous())
                          for d, st in zip(devs, starts)]
        self.replicas.prepare(parts)
        self._pending = (kind, h)

    def replay(self) -> torch.Tensor:
        kind, h = self._pending
        outs = self.replicas.replay()
        dst = self.grid[0, 0]
        if kind == "whole":
            return gather(outs, dst)
        per = self.n_dev
        results = []
        for g in range(self.n_batch):
            mine = outs[g * per:(g + 1) * per]
            if kind == "halo":
                results.append(gather(self._halo_crop(mine, h), dst, dim=1))
                continue
            s, _, a, starts = self._windows(h)
            sc = self._scale
            y0 = mine[0]
            out = torch.zeros((y0.shape[0], h * sc) + tuple(y0.shape[2:]), dtype=y0.dtype,
                              device=dst)
            for y, ai, st in zip(mine, a, starts):
                off = int(ai - st) * sc
                out[:, int(ai) * sc:(int(ai) + s) * sc].copy_(y[:, off:off + s * sc],
                                                             non_blocking=True)
            results.append(out)
        return gather(results, dst)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.prepare(x)
        return self.replay()


def make_spatial_apply(model: nn.Module, mesh: Mesh, overlap: int = 32, scale: int = 4,
                       axis: str = "data", batch_axis: Optional[str] = None,
                       fn: Optional[Fn] = None, graphed: bool = False) -> SpatialApply:
    """A reusable H-sharded forward ``fn(x) -> y`` (:class:`SpatialApply`)."""
    return SpatialApply(model, mesh, overlap, scale, axis, batch_axis, fn, graphed)


def spatial_shard_apply(model: nn.Module, mesh: Mesh, x: torch.Tensor, overlap: int = 32,
                        scale: int = 4, axis: str = "data") -> torch.Tensor:
    """One-shot convenience wrapper over :func:`make_spatial_apply`."""
    return make_spatial_apply(model, mesh, overlap, scale, axis)(x)
