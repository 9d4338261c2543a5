"""Stage-pipelined inference across two devices (counterpart of
``ntire2022_esr_tpu/parallel/pipeline.py``).

The stage-split seam (harness/stagesplit.py: LR body | x4 tail) maps onto
a two-stage device pipeline: the body runs on one device, the tail on the
other, and the body's output crosses once per batch
(``.to(device, non_blocking=True)``). Every dispatch is queued without
waiting, so in steady state the two stages overlap and the slower stage
sets the throughput. On a list that names one card twice both stages run
on it, one after the other.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ntire2022_esr_tpu_torch.parallel.eval import Replicas, on_device
from ntire2022_esr_tpu_torch.parallel.mesh import _device


def _to(h, device: torch.device):
    """A body output (a tensor, or a tuple or list of them) on ``device``."""
    if isinstance(h, (tuple, list)):
        return type(h)(_to(t, device) for t in h)
    return h.to(device, non_blocking=True)


class PipelinedSR:
    """Two-stage (body | tail) pipelined SR over two devices.

    >>> pipe = PipelinedSR(model_id=28)              # doctest: +SKIP
    >>> for sr in pipe.process_stream(batches): ...  # doctest: +SKIP

    Frames are float NHWC batches at the model's data_range, run under the
    process's tier. ``devices`` defaults to ``cuda:0`` and ``cuda:1``;
    ``model`` (an ``nn.Module`` of ``model_id``) replaces the registry's;
    ``depth`` bounds the batches in flight.
    """

    def __init__(self, model_id: int, devices: Optional[Sequence] = None, depth: int = 2,
                 model: Optional[nn.Module] = None):
        from ntire2022_esr_tpu_torch.harness import registry, stagesplit

        split = stagesplit.get_split(model_id)
        if split is None:
            raise KeyError(f"model {model_id} has no stage split "
                           f"(available: {stagesplit.split_ids()})")
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(min(2, torch.cuda.device_count()))]
        devs = [_device(d) for d in devices]
        if len(devs) != 2:
            raise ValueError(f"pipeline needs exactly 2 devices, got {len(devs)}")
        self._d0, self._d1 = devs
        if model is None:
            model, *_ = registry.build_model(model_id, device=self._d0)
        models = Replicas(model, devs).models
        self._m0, self._m1 = models[self._d0], models[self._d1]
        self._split = split
        self._depth = max(1, int(depth))

    def _submit(self, batch: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            x0 = torch.from_numpy(np.asarray(batch)).to(self._d0, non_blocking=True)
            with on_device(self._d0):
                h = self._split.body(self._m0, x0)             # stage 0
            h1, x1 = _to(h, self._d1), x0.to(self._d1, non_blocking=True)
            with on_device(self._d1):
                return self._split.tail(self._m1, h1, x1)      # stage 1

    @staticmethod
    def _host(y: torch.Tensor) -> np.ndarray:
        return y.float().cpu().numpy()

    def process_one(self, batch: np.ndarray) -> np.ndarray:
        return self._host(self._submit(batch))

    def process_stream(self, batches: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Pipeline a stream of batches, in order; at most ``depth`` in
        flight keeps both stages busy without holding every x4 output."""
        inflight: "collections.deque" = collections.deque()
        for batch in batches:
            inflight.append(self._submit(batch))
            while len(inflight) >= self._depth:
                yield self._host(inflight.popleft())
        while inflight:
            yield self._host(inflight.popleft())

    @property
    def devices(self):
        return (self._d0, self._d1)
