"""Sharded batch evaluation (counterpart of ``ntire2022_esr_tpu/parallel/eval.py``).

JAX shards the batch axis over the mesh's ``data`` axis with a
``NamedSharding``, replicates the params, and lets XLA partition the
program. The port does the same by hand, from one thread: a replica of
the model on each distinct device of the mesh (:class:`Replicas`; the
kernels' packed-weight cache keys on the device, so each device packs
once), the batch split into one chunk per entry of the axis, each chunk
moved to its device with ``non_blocking=True`` and run there without
waiting, and the outputs gathered on the mesh's first device.

Each sharded forward is a ``prepare``/``replay`` pair, as
``graphs.GraphedForward`` is: ``prepare`` places every entry's shard on
its device, and ``replay`` runs the entries' forwards and gathers their
outputs. With ``graphed=True`` each entry's forward is one CUDA graph per
input shape, which ``prepare`` loads (capturing it where the shape is
new); the copies between devices stay outside the captures.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ntire2022_esr_tpu_torch.harness import graphs, tiling
from ntire2022_esr_tpu_torch.parallel.mesh import Mesh

Fn = Callable[[nn.Module, torch.Tensor], torch.Tensor]


def _call(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return model(x)


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` on a CUDA device, else nothing: the
    kernels, the streams and the side stream of a capture follow it."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class Replicas:
    """``fn(replica, x)`` (default ``replica(x)``) for a list of (device,
    input) entries, with one replica of ``model`` per distinct device: the
    model itself on its own device, a copy elsewhere (made outside
    inference mode, as ``registry.build_model`` makes the weights).

    :meth:`prepare` places each entry's input on its device; :meth:`replay`
    queues each entry's forward without waiting and returns the outputs.
    ``graphed=True`` (CUDA devices only) gives each entry position a
    ``graphs.GraphedForward`` of its own, captured anew when that entry's
    shape changes, so entries that share a device keep separate static
    buffers; an output is then its graph's static output, which the next
    replay overwrites."""

    def __init__(self, model: nn.Module, devices: Sequence[torch.device],
                 fn: Optional[Fn] = None, graphed: bool = False):
        home = next(iter(model.parameters())).device
        self.models: Dict[torch.device, nn.Module] = {}
        for d in dict.fromkeys(devices):
            if d == home:
                self.models[d] = model
            else:
                with torch.inference_mode(False):
                    self.models[d] = copy.deepcopy(model).to(d)
        self._fn = fn or _call
        self._graphed = graphed
        self._graphs: Dict[Tuple[int, torch.device], graphs.GraphedForward] = {}
        self._parts: List[Tuple[int, torch.device, Optional[torch.Tensor]]] = []

    def _graph(self, k: int, device: torch.device) -> "graphs.GraphedForward":
        if (k, device) not in self._graphs:
            model = self.models[device]
            self._graphs[(k, device)] = graphs.GraphedForward(lambda v: self._fn(model, v), device)
        return self._graphs[(k, device)]

    def prepare(self, parts: Sequence[Tuple[torch.device, torch.Tensor]]) -> None:
        self._parts = []
        for k, (d, x) in enumerate(parts):
            x = x.to(d, non_blocking=True)
            if self._graphed:
                self._graph(k, d).prepare(x)
                x = None
            self._parts.append((k, d, x))

    def replay(self) -> List[torch.Tensor]:
        outs = []
        for k, d, x in self._parts:
            if self._graphed:
                outs.append(self._graph(k, d).replay())
            else:
                with on_device(d):
                    outs.append(self._fn(self.models[d], x))
        return outs

    def map(self, parts: Sequence[Tuple[torch.device, torch.Tensor]]) -> List[torch.Tensor]:
        """:meth:`prepare` then :meth:`replay`."""
        self.prepare(parts)
        return self.replay()


def gather(pieces: Sequence[torch.Tensor], dst: torch.device, dim: int = 0) -> torch.Tensor:
    """The pieces concatenated on ``dst`` (one piece is returned as it is)."""
    pieces = [p.to(dst, non_blocking=True) for p in pieces]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)


def _split_batch(n: int, parts: int, axis: str) -> int:
    if n % parts:
        raise ValueError(f"batch {n} must divide by the {axis!r} mesh axis ({parts}); "
                         "pad the batch (harness/serving.py does)")
    return n // parts


class ShardedBatch:
    """``fn(x)``: the batch ``x`` (N, H, W, C) split over the ``axis``
    entries of ``mesh``, each chunk's forward on its device, the output
    gathered on the mesh's first device. N must divide by the axis.
    ``fn(x)`` is ``prepare(x)`` then ``replay()``. With ``graphed`` and one
    entry the output is that entry's graph's static output, which the next
    replay overwrites."""

    def __init__(self, model: nn.Module, mesh: Mesh, axis: str = "data",
                 fn: Optional[Fn] = None, graphed: bool = False):
        self.devices = list(mesh.axis_grid(axis)[0])
        self.replicas = Replicas(model, mesh.distinct, fn, graphed)
        self._axis = axis

    def parts(self, *tensors: torch.Tensor) -> List[List[torch.Tensor]]:
        """Each tensor's chunks, one per entry of the axis."""
        b = _split_batch(tensors[0].shape[0], len(self.devices), self._axis)
        return [[t[i * b:(i + 1) * b] for t in tensors] for i in range(len(self.devices))]

    def prepare(self, x: torch.Tensor) -> None:
        self.replicas.prepare([(d, c[0]) for d, c in zip(self.devices, self.parts(x))])

    def replay(self) -> torch.Tensor:
        return gather(self.replicas.replay(), self.devices[0])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.prepare(x)
        return self.replay()


def sharded_batch_apply(model: nn.Module, mesh: Mesh, axis: str = "data",
                        fn: Optional[Fn] = None, graphed: bool = False) -> ShardedBatch:
    """``f(x)`` with the batch sharded over ``axis`` and the model
    replicated (JAX: params replicated, activations sharded)."""
    return ShardedBatch(model, mesh, axis, fn, graphed)


def sharded_eval_step(model: nn.Module, mesh: Mesh, data_range: float = 1.0,
                      axis: str = "data"
                      ) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """``step(lr, hr) -> (sr, per_image_mse)``: the sharded forward and each
    image's MSE in the [0, 255] domain the challenge scores in (clip,
    round, border 4; test_demo.py:447), computed on each image's device
    and gathered on the mesh's first device."""
    sharded = ShardedBatch(model, mesh, axis)
    scale = 255.0 / float(data_range)

    def step(lr: torch.Tensor, hr: torch.Tensor):
        chunks = sharded.parts(lr, hr)
        srs = sharded.replicas.map([(d, c[0]) for d, c in zip(sharded.devices, chunks)])
        mses = []
        for sr, (_, h) in zip(srs, chunks):
            sr255 = torch.round(sr.float().clamp(0, float(data_range)) * scale)
            b = 4
            diff = (sr255 - h.to(sr.device, non_blocking=True))[:, b:-b, b:-b, :].float()
            mses.append((diff * diff).mean(dim=(1, 2, 3)))
        dst = sharded.devices[0]
        return gather(srs, dst), gather(mses, dst)

    return step


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    return 20.0 * math.log10(255.0) - 10.0 * torch.log10(mse)


def sharded_tiled_apply(model: nn.Module, mesh: Mesh, x: torch.Tensor, tile: int,
                        tile_overlap: int = 32, scale: int = 4, axis: str = "data") -> torch.Tensor:
    """One image's overlap-tile grid sharded over the mesh. The tiles are
    read with their overlap from the input, so no halo moves between
    devices; the tile count is padded to a multiple of the mesh size with
    zero tiles, which the blend leaves out (the coverage count)."""
    n, h, w, c = x.shape
    tile = min(tile, h, w)
    stride = tile - tile_overlap
    coords = [(hi, wi) for hi in tiling._tile_starts(h, tile, stride)
              for wi in tiling._tile_starts(w, tile, stride)]
    t_pad = (-len(coords)) % mesh.devices.size
    patches = torch.stack([x[0, hi:hi + tile, wi:wi + tile, :] for hi, wi in coords]
                          + [x.new_zeros((tile, tile, c))] * t_pad)
    outs = ShardedBatch(model, mesh, axis)(patches)

    ts = tile * scale
    e = torch.zeros((n, h * scale, w * scale, outs.shape[-1]), dtype=outs.dtype, device=outs.device)
    cov = torch.zeros((1, h * scale, w * scale, 1), dtype=outs.dtype, device=outs.device)
    for k, (hi, wi) in enumerate(coords):
        oh, ow = hi * scale, wi * scale
        e[:, oh:oh + ts, ow:ow + ts] += outs[k]
        cov[:, oh:oh + ts, ow:ow + ts] += 1.0
    return e / cov
