"""The NTIRE 2022 ESR runtime protocol, as the port's ``runner.run`` times
it, on a pool of seeded frames.

Set-up: the tier that the configuration states for the cell, entered for
the whole run (``config.numerics_mode``; the protocol CLI's default is
``parity``),
``registry.build_model(model_id)``, the pool of seeded uint8 frames
(``frames.py``) on the device, each as the protocol loads it (``u8 /
(255 / data_range)``, float32 NHWC, batch 1), and the timed unit: the
forward ``tiling.forward(model, x, tile)`` in a
``graphs.GraphedForward``, captured on the first frame, then
``warm_replays`` replays.

Window: frame after frame of the pool, cycled: ``prepare`` loads it into
the graph's static input, and CUDA events (``timing.Timer``, a copy of
the port's) bracket ``replay`` alone, as ``runner.run`` does. The window
runs until ``seconds`` have passed (traced: ``trace_replays`` replays).
``runtime_ms`` is the mean of the event times, ``runtime_ms_p95`` their
95th percentile by nearest rank. ``sample`` outputs, drawn from the seed,
are copied to the host outside the events. The runner's PNG decode,
scoring and saving are not timed by the challenge and are left out.
"""

from __future__ import annotations

import contextlib
import random
import time

import torch

from port_bench import frames as frames_mod
from port_bench import timing
from port_bench.window import Reservoir, Window

WINDOW = "replay"


class _Eager:
    """The ``prepare``/``replay`` pair of a forward run eagerly (the CPU,
    where there are no graphs)."""

    def __init__(self, fn):
        self._fn = fn

    def prepare(self, x):
        self._x = x

    def replay(self):
        return self._fn(self._x)


class State:
    pass


def setup(ctx) -> State:
    from ntire2022_esr_tpu_torch import config as port_config
    from ntire2022_esr_tpu_torch.harness import graphs, registry, tiling

    st = State()
    tr = ctx.cell.traffic
    st.traffic = tr
    st.mode = port_config.numerics_mode(ctx.tier)
    st.mode.__enter__()
    model, _, dr, tile = registry.build_model(ctx.cell.config["model_id"], device=ctx.device)
    u8 = frames_mod.make(tr["frames"], ctx.seed, ctx.device)
    st.pool = u8.cpu().numpy()
    st.xs = [u8[i:i + 1].float() / (255.0 / float(dr)) for i in range(u8.shape[0])]

    def forward(x):
        return tiling.forward(model, x, tile)

    with torch.inference_mode():
        st.unit = (graphs.GraphedForward(forward, ctx.device) if ctx.device.type == "cuda"
                   else _Eager(forward))
        for i in range(1 + int(tr["warm_replays"])):
            st.unit.prepare(st.xs[i % len(st.xs)])
            st.unit.replay()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    st.timer = timing.Timer(ctx.device)
    return st


def window(st: State, seconds: float, tracing: bool, rng: random.Random) -> Window:
    from ntire2022_esr_tpu_torch import config as port_config

    keep = Reservoir(int(st.traffic["sample"]), rng)
    limit = int(st.traffic["trace_replays"]) if tracing else None
    times = []
    n = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    with torch.inference_mode():
        while (n < limit) if tracing else (time.perf_counter() < deadline):
            k = n % len(st.xs)
            st.unit.prepare(st.xs[k])
            with (torch.profiler.record_function(WINDOW) if tracing
                  else contextlib.nullcontext()):
                st.timer.start()
                out = st.unit.replay()
                times.append(st.timer.stop())
            keep.offer(k, lambda: out.cpu().numpy())
            n += 1
    return Window(units=n, timed_s=sum(times) / 1000.0,
                  e2e={"runtime_ms": sum(times) / len(times),
                       "runtime_ms_p95": timing.nearest_rank(times, 0.95)},
                  samples=keep.sample(), pool=st.pool, tier=port_config.mode())


def release(st: State) -> None:
    st.unit = st.xs = None
    st.mode.__exit__(None, None, None)
