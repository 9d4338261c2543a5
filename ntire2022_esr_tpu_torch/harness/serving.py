"""Bounded-depth uint8 SR serving (counterpart of ``ntire2022_esr_tpu/harness/serving.py``).

A persistent server over one model: it takes uint8 HWC frames, batches
consecutive frames of one shape up to ``max_batch``, converts on the
device (``/(255/dr)`` in; clip, rescale, round out: the exact
tensor2uint rounding), and returns uint8 SR frames in order.

Bounded in-flight depth: work is queued on the device's stream without
synchronising; at most ``depth`` batches are queued, and the oldest is
drained (copied to the host, which waits for it) before another is
submitted. The tier defaults to the model's entry in the card's envelope,
``results/h100/zoo_sustained_gated.json`` (``harness/envelope.py``), and
every dispatch runs under it, whatever the process's tier is then.

``stage_split`` runs a split-capable model's body at the full batch and
its x4 tail over chunks (``harness/stagesplit.py``). ``mesh`` shards each
batch over the devices of a ``parallel.Mesh`` (a replica of the model on
each, ``parallel.sharded_batch_apply``): a short batch is padded with
black frames to a multiple of the mesh size when it is submitted. The
two do not compose. A caller may serve a model of its own (``model=``,
with ``data_range=``).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.harness import registry, stagesplit
from ntire2022_esr_tpu_torch.parallel import sharded_batch_apply

def gated_tier(name: str, path: Optional[str] = None) -> str:
    """The benchmark-gated numerics tier of model ``name`` ("04_RLFN") in
    the envelope at ``path`` (the card's by default)."""
    from ntire2022_esr_tpu_torch.harness import envelope  # envelope imports SRServer

    return envelope.load_envelope(path)[name].tier


def u8_in(u8: torch.Tensor, data_range: float) -> torch.Tensor:
    """uint8 -> f32 in [0, dr], on ``u8``'s device: ``/(255/dr)``."""
    return u8.float() / (255.0 / float(data_range))


def u8_out(y: torch.Tensor, data_range: float) -> torch.Tensor:
    """A model output -> uint8: clip to [0, dr], rescale, round half to even."""
    dr = float(data_range)
    return torch.round(y.clamp(0, dr) * (255.0 / dr)).to(torch.uint8)


def u8_forward(model, u8: torch.Tensor, data_range: float) -> torch.Tensor:
    """uint8 NHWC in, uint8 out, converted on ``u8``'s device."""
    return u8_out(model(u8_in(u8, data_range)), data_range)


class SRServer:
    """Synchronous bounded-pipeline SR server over one zoo model.

    >>> srv = SRServer(model_id=4)               # doctest: +SKIP
    >>> sr = srv.process_one(lr_u8)              # doctest: +SKIP
    >>> for sr in srv.process_stream(frames): ...  # doctest: +SKIP
    """

    def __init__(self, model_id: int = 4, *, max_batch: int = 32, depth: int = 2,
                 device=None, tier: Optional[str] = None, weights_dir: Optional[str] = None,
                 model: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 data_range: Optional[float] = None, mesh=None,
                 stage_split: Union[bool, int] = False):
        """``model`` (NHWC -> NHWC, on ``device``) replaces the registry's
        model ``model_id``; ``data_range`` must come with it, and the tier
        defaults to the process's tier at construction. ``stage_split``
        (True, or a chunk size) needs a model id with a split; True takes
        the shipped chunk. ``mesh`` (a ``parallel.Mesh``) needs ``max_batch``
        a multiple of its size; the model lives on ``device``, by default
        the mesh's first device."""
        if mesh is not None and stage_split:
            raise ValueError("stage_split does not compose with mesh serving "
                             "(shard the batch OR split stages)")
        if mesh is not None and device is None:
            device = mesh.devices.flat[0]
        self.device = config.resolve_device(device)
        if model is None:
            model, name, data_range, tile = registry.build_model(
                model_id, weights_dir, device=self.device)
            if tile is not None:
                raise ValueError(
                    f"model {model_id} requires tiled inference; serve it through "
                    "harness.tiling.ChunkedTiler (harness.serve), not the batch server")
            self.tier = tier or gated_tier(name)
        elif data_range is None:
            raise ValueError("data_range is required with a user-supplied model")
        else:
            self.tier = tier or config.mode()
        if self.tier not in config.modes():
            raise ValueError(f"unknown tier {self.tier!r} (have {config.modes()})")
        self._split = None
        if stage_split:
            sp = stagesplit.get_split(model_id)
            if sp is None:
                raise ValueError(f"model {model_id} has no registered stage split "
                                 f"(available: {stagesplit.split_ids()})")
            chunk = (int(stage_split) if stage_split is not True
                     else stagesplit.SHIPPED.get(model_id, (0, 8))[1])
            self._split = (stagesplit.split_apply(model_id, chunk, sp), chunk)
        self._model = model
        self._dr = float(data_range)
        self._max_batch = int(max_batch)
        self._depth = max(1, int(depth))
        self._mesh = mesh
        self._sharded = None
        if mesh is not None:
            if self._max_batch % mesh.devices.size:
                raise ValueError(f"max_batch {self._max_batch} must be a multiple of the "
                                 f"mesh size {mesh.devices.size}")
            dr = self._dr
            self._sharded = sharded_batch_apply(model, mesh,
                                                fn=lambda m, u8: u8_forward(m, u8, dr))
        self._lock = threading.Lock()

    def _serve(self, u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), config.numerics_mode(self.tier):
            if self._sharded is not None:
                return self._sharded(u8)
            if self._split is None:
                return u8_forward(self._model, u8, self._dr)
            # the batch padded to a multiple of the chunk with black frames
            run, chunk = self._split
            n = u8.shape[0]
            pad = (-n) % chunk
            if pad:
                u8 = torch.cat([u8, u8.new_zeros((pad,) + tuple(u8.shape[1:]))])
            return u8_forward(lambda x: run(self._model, x), u8, self._dr)[:n]

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(batch)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def warmup(self, hw: Tuple[int, int], batch: Optional[int] = None) -> None:
        """Build the kernels and run one batch of an LR shape (on a mesh,
        of a size that divides by it: a batch is padded to it when it is
        submitted, so warm the padded size)."""
        b = batch or self._max_batch
        if self._mesh is not None and b % self._mesh.devices.size:
            raise ValueError(
                f"warmup batch {b} must be a multiple of the mesh size "
                f"{self._mesh.devices.size} (sharded batches are padded to the mesh at "
                "submit time; warm the padded size)")
        u = torch.zeros((b, hw[0], hw[1], 3), dtype=torch.uint8, device=self.device)
        self._serve(u)[0, 0, 0, 0].item()

    def _submit(self, frames: List[np.ndarray]) -> torch.Tensor:
        batch = np.stack(frames)
        if self._mesh is not None:
            # a sharded batch divides by the mesh: black frames pad it, and
            # the output is cut back to the frames
            pad = (-len(frames)) % self._mesh.devices.size
            if pad:
                batch = np.concatenate([batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
        # the lock serialises dispatch only; it is never held across a yield
        with self._lock:
            return self._serve(self._to_device(batch))[:len(frames)]

    def process_one(self, lr_u8: np.ndarray) -> np.ndarray:
        """uint8 HWC in -> uint8 (4H, 4W, C) out."""
        return self._submit([lr_u8])[0].cpu().numpy()

    def process_stream(self, frames: Iterable[np.ndarray],
                       batch: Optional[int] = None) -> Iterator[np.ndarray]:
        """Stream uint8 frames through the device, preserving order.

        Frames are grouped into consecutive same-shape batches (a shape
        change flushes the open batch). At most ``depth`` batches are in
        flight; results are yielded as host uint8 arrays.
        """
        max_b = batch or self._max_batch
        inflight: "collections.deque" = collections.deque()
        pending: List[np.ndarray] = []
        pend_shape: Optional[Tuple[int, ...]] = None

        def flush():
            nonlocal pending, pend_shape
            if pending:
                inflight.append(self._submit(pending))
                pending, pend_shape = [], None

        def drain_one():
            yield from inflight.popleft().cpu().numpy()

        for f in frames:
            if pend_shape is not None and (f.shape != pend_shape or len(pending) >= max_b):
                flush()
            if not pending:
                pend_shape = f.shape
            pending.append(f)
            if len(pending) >= max_b:
                flush()
            while len(inflight) >= self._depth:
                yield from drain_one()
        flush()
        while inflight:
            yield from drain_one()


def bucketed_throughput(server: SRServer, frames: List[np.ndarray],
                        batch: Optional[int] = None) -> Dict[str, float]:
    """Sustained images/sec of ``process_stream`` over ``frames`` (host
    clock; every output has reached the host when it stops)."""
    t0 = time.perf_counter()
    n = 0
    for _ in server.process_stream(frames, batch=batch):
        n += 1
    dt = time.perf_counter() - t0
    return {"images": n, "seconds": dt, "images_per_sec": n / dt}
