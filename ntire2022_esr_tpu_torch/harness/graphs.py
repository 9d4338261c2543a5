"""CUDA graphs of a forward, one per input shape (the timed unit of
``runner.run``, ``runner.run_batched``, ``tiling.ChunkedTiler`` and each
entry of ``parallel/``'s sharded forwards). It imports nothing of the
port, so the runner and ``parallel/`` both build on it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

# Graphs captured and replayed by GraphedForward in this process. A
# kernel wrapper counts its launches when it is called, so under a graph
# its counter moves at capture only; a replay launches the captured work.
captures = 0
replays = 0

# One side stream per device for every warm-up and capture: cuBLAS keeps a
# workspace (32 MiB on this card) for each stream that has run a matmul,
# for the life of the process, so a new stream per capture would add one
# to the peak memory with every input shape.
_capture_streams: Dict[int, torch.cuda.Stream] = {}


def _capture_stream() -> torch.cuda.Stream:
    dev = torch.cuda.current_device()
    if dev not in _capture_streams:
        _capture_streams[dev] = torch.cuda.Stream()
    return _capture_streams[dev]


class GraphedForward:
    """``fn`` (tensor -> tensor) on a CUDA device, replayed as a CUDA graph
    captured for the shape and dtype of its last input.

    :meth:`prepare` copies an input into the graph's static input buffer,
    after capturing a graph for it if its shape or dtype is new: the
    previous graph, its static buffers and its memory pool are dropped
    first, then ``fn`` runs once on the device's side stream (where the
    kernels are built and their weights packed, the resize matrices cached
    and the cuDNN and cuBLAS workspaces allocated, none of which may happen
    during a capture) and is captured on that stream. :meth:`replay` launches the graph and returns
    its static output, which the next replay overwrites: copy it out first.
    Everything runs under ``torch.cuda.device(device)``.
    """

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], device: torch.device):
        self._fn = fn
        self._device = torch.device(device)
        self._key: Optional[Tuple] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._in: Optional[torch.Tensor] = None
        self._out: Optional[torch.Tensor] = None

    def prepare(self, x: torch.Tensor) -> None:
        """Load ``x`` into the static input, capturing a graph for it first
        if the live graph was captured for another shape or dtype."""
        global captures
        key = (tuple(x.shape), x.stride(), x.dtype)
        with torch.cuda.device(self._device):
            if key != self._key:
                self._key = self._graph = self._in = self._out = None
                static_in = x.clone()
                side = _capture_stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self._fn(static_in)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, stream=side):
                        out = self._fn(static_in)
                torch.cuda.current_stream().wait_stream(side)
                self._key, self._graph, self._in, self._out = key, graph, static_in, out
                captures += 1
            else:
                self._in.copy_(x)

    def replay(self) -> torch.Tensor:
        global replays
        with torch.cuda.device(self._device):
            self._graph.replay()
        replays += 1
        return self._out
