"""Bounded-depth uint8 SR serving (counterpart of ``ntire2022_esr_tpu/harness/serving.py``).

A persistent server over one model: it takes uint8 HWC frames, batches
consecutive frames of one shape up to ``max_batch``, converts on the
device (``/(255/dr)`` in; clip, rescale, round out: the exact
tensor2uint rounding), and returns uint8 SR frames in order.

Bounded in-flight depth: work is queued on the device's stream without
synchronising; at most ``depth`` batches are queued, and the oldest is
drained (copied to the host, which waits for it) before another is
submitted. The tier defaults to the model's entry in
``results/protocol/zoo_sustained_gated.json`` (``fasthi16`` for RLFN).

Not ported yet (ROADMAP.md): ``mesh`` (multi-device) and ``stage_split``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.harness import registry

GATED_TIERS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "results", "protocol", "zoo_sustained_gated.json")


def gated_tier(name: str, path: str = GATED_TIERS) -> str:
    """The benchmark-gated numerics tier of model ``name`` ("04_RLFN")."""
    with open(path) as fh:
        return json.load(fh)[name]["tier"]


def u8_forward(model, u8: torch.Tensor, data_range: float) -> torch.Tensor:
    """uint8 NHWC in, uint8 out, converted on ``u8``'s device: ``/(255/dr)``
    in; clip, rescale and round (half to even) out."""
    dr = float(data_range)
    y = model(u8.float() / (255.0 / dr))
    y = y.clamp(0, dr) * (255.0 / dr)
    return torch.round(y).to(torch.uint8)


class SRServer:
    """Synchronous bounded-pipeline SR server over one zoo model.

    >>> srv = SRServer(model_id=4)               # doctest: +SKIP
    >>> sr = srv.process_one(lr_u8)              # doctest: +SKIP
    >>> for sr in srv.process_stream(frames): ...  # doctest: +SKIP
    """

    def __init__(self, model_id: int = 4, *, max_batch: int = 32, depth: int = 2,
                 device=None, tier: Optional[str] = None, weights_dir: Optional[str] = None):
        self.device = config.resolve_device(device)
        model, name, data_range, tile = registry.build_model(
            model_id, weights_dir, device=self.device)
        if tile is not None:
            raise ValueError(f"model {model_id} requires tiled inference, which is not ported")
        self.tier = tier or gated_tier(name)
        if self.tier not in config.modes():
            raise ValueError(f"unknown tier {self.tier!r} (have {config.modes()})")
        self._model = model
        self._dr = float(data_range)
        self._max_batch = int(max_batch)
        self._depth = max(1, int(depth))
        self._lock = threading.Lock()

    def _serve(self, u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), config.numerics_mode(self.tier):
            return u8_forward(self._model, u8, self._dr)

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(batch)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def warmup(self, hw: Tuple[int, int], batch: Optional[int] = None) -> None:
        """Build the kernels and run one batch of an LR shape."""
        b = batch or self._max_batch
        u = torch.zeros((b, hw[0], hw[1], 3), dtype=torch.uint8, device=self.device)
        self._serve(u)[0, 0, 0, 0].item()

    def _submit(self, frames: List[np.ndarray]) -> torch.Tensor:
        # the lock serialises dispatch only; it is never held across a yield
        with self._lock:
            return self._serve(self._to_device(np.stack(frames)))

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
