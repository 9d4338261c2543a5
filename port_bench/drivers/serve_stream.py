"""A closed loop of uint8 frames through the port's serving entry.

Set-up: ``envelope.make_server(model_id)`` at the model's card plan (its
batch and dispatch; a mix may fix ``batch``) and at the tier that the
configuration states for the cell, the pool of seeded
frames (``frames.py``) on the host, ``SRServer.warmup`` at the frame
shape, then ``warm_batches`` whole batches through ``process_stream``,
so that the pinned host buffers and the copy path are warm.

Window: ``process_stream`` over the pool, cycled. The loop is closed: the
server takes the next frame when it asks for one. Frames are fed in whole
batches; once ``seconds`` have passed at a batch boundary (or, traced,
after ``trace_batches`` batches) no more are fed, and the window ends when
the last output has reached the host. ``images_per_s`` is the outputs
over that time. ``sample`` outputs, drawn from the seed, are kept.
"""

from __future__ import annotations

import contextlib
import random
import time

import torch

from port_bench import frames as frames_mod
from port_bench.window import Reservoir, Window

WINDOW = "stream_window"


class State:
    def __init__(self, server, pool, batch: int, traffic):
        self.server, self.pool, self.batch, self.traffic = server, pool, batch, traffic


def _cycle(pool, n: int):
    for i in range(n):
        yield pool[i % len(pool)]


def setup(ctx) -> State:
    from ntire2022_esr_tpu_torch.harness import envelope

    tr = ctx.cell.traffic
    batch = None if tr.get("batch", "plan") == "plan" else int(tr["batch"])
    server = envelope.make_server(ctx.cell.config["model_id"], max_batch=batch,
                                  depth=int(tr["depth"]), device=ctx.device, tier=ctx.tier)
    b = batch or server.plan.batch
    pool = frames_mod.make(tr["frames"], ctx.seed, ctx.device).cpu().numpy()
    server.warmup(pool.shape[1:3], batch=b)
    for _ in server.process_stream(_cycle(pool, int(tr["warm_batches"]) * b), batch=b):
        pass
    return State(server, pool, b, tr)


def window(st: State, seconds: float, tracing: bool, rng: random.Random) -> Window:
    b, pool = st.batch, st.pool
    units = int(st.traffic["trace_batches"]) * b if tracing else None
    keep = Reservoir(int(st.traffic["sample"]), rng)

    def feed(deadline: float):
        n = 0
        while True:
            if n % b == 0 and (n >= units if tracing else time.perf_counter() >= deadline):
                return
            yield pool[n % len(pool)]
            n += 1

    span = torch.profiler.record_function(WINDOW) if tracing else contextlib.nullcontext()
    n_out = 0
    t0 = time.perf_counter()
    with span:
        for out in st.server.process_stream(feed(t0 + seconds), batch=b):
            keep.offer(n_out % len(pool), out.copy)
            n_out += 1
    wall = time.perf_counter() - t0
    return Window(units=n_out, timed_s=wall,
                  e2e={"images_per_s": n_out / wall}, samples=keep.sample(), pool=pool,
                  tier=st.server.tier)


def release(st: State) -> None:
    st.server = None
