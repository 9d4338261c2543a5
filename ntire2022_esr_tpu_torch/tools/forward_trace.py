#!/usr/bin/env python3
"""Trace of the protocol's timed forward at batch 1, eager against graph.

    python3 ntire2022_esr_tpu_torch/tools/forward_trace.py [--model 4] [--tiers fasthi16,parity]
        [--hw 339x510] [--iters 10] [--modes eager,graph]

For each tier and mode it runs one LR image (a ``data.synthetic_hr`` field
from numpy seed 0, 4x4 block means, as ``write_synthetic_div2k`` makes it)
through the model ``--iters`` times after a warm-up, each forward timed by
CUDA events as ``runner.run`` times it and marked with a
``record_function`` window, all under ``profiling.trace``. ``eager``
dispatches the forward op by op from Python; ``graph`` replays the
``graphs.GraphedForward`` capture. It prints per tier and mode the median
event time, the device-busy share of the timed windows
(``profiling.busy_share``: the union of the kernels and copies over the
windows' span), the device events a forward and peak memory, and the
median event time of as many forwards run before the trace (the
profiler's own cost on the host shows as their difference), the card's
name and power limit, and one JSON line at the end. Under ``eager`` it
also prints the ``TOP_OPS`` host-side ops (aten ops, from
``key_averages()``) with the most device time of their own a forward, and
their share of the device time of all ops; under ``graph`` the replay hides which op launched a
kernel, and the device time of the ``SPANS`` (``record_function``
spans of the port: NLFFC's DFT products, ``spectral.dft``) a forward and
their share of the forward. A tiled model (NLFFC) runs
``tiling.forward`` at its registry tile and tiles a call, as
``runner.run`` does. The traces are written under
``build/forward_trace/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
WINDOW = "timed_forward"
TOP_OPS = 12
SPANS = ("spectral.dft",)


def top_ops(prof, iters: int, n: int) -> list:
    """The ``n`` host-side ops with the most device time of their own (that
    of the kernels they launched) a forward: [(name, ms a forward, share of
    all ops' device time, calls a forward)]. The kernels' own entries are
    left out: each is counted in the op that launched it."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        t = e.self_device_time_total
        if t > 0 and e.key != WINDOW and e.device_type == DeviceType.CPU:
            rows.append((e.key, t / 1e3 / iters, e.count / iters))
    total = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return [(k, ms, ms / total, calls) for k, ms, calls in rows[:n]]


def span_ms(prof, iters: int) -> dict:
    """The device time a forward of each of ``SPANS`` that ran, in ms: that
    of the kernels launched inside the span."""
    return {e.key: e.device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.key in SPANS and e.device_time_total > 0}


def measure(model, x, tier: str, mode: str, iters: int, logdir: str) -> dict:
    """One tier and mode of ``model`` on the device tensor ``x`` (see the
    module docstring); the trace goes to ``logdir``."""
    import torch
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import graphs, profiling

    dev = x.device
    timer = profiling.Timer(dev)
    with config.numerics_mode(tier), torch.inference_mode():
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        if mode == "graph":
            graphed = graphs.GraphedForward(model, dev)
            graphed.prepare(x)
            fwd = graphed.replay
        else:
            model(x)
            fwd = lambda: model(x)  # noqa: E731
        fwd()
        untraced = []
        for _ in range(iters):
            timer.start()
            fwd()
            untraced.append(timer.stop())
        times = []
        with profiling.trace(logdir) as prof:
            for _ in range(iters):
                with torch.profiler.record_function(WINDOW):
                    timer.start()
                    fwd()
                    times.append(timer.stop())
        peak = torch.cuda.max_memory_allocated(dev) / 1024**2
    path = os.path.join(logdir, profiling.TRACE_FILE)
    share, n = profiling.busy_share(path, WINDOW)
    with open(path) as fh:
        kernels = sum(1 for e in json.load(fh)["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") == "kernel")
    return {"tier": tier, "mode": mode, "hw": list(x.shape[1:3]),
            "ms_median": float(np.median(times)), "ms": times,
            "ms_untraced_median": float(np.median(untraced)), "ms_untraced": untraced,
            "busy_share": share, "windows": n, "kernels_per_forward": kernels / n,
            "peak_mb": peak, "top_ops": top_ops(prof, iters, TOP_OPS) if mode == "eager" else [],
            "spans": span_ms(prof, iters) if mode == "eager" else {}}


def describe(name: str, rec: dict) -> str:
    h, w = rec["hw"]
    text = (f"{name} {rec['tier']} {rec['mode']} LR {h}x{w} batch 1: {rec['ms_median']:.3f} ms "
            f"traced, {rec['ms_untraced_median']:.3f} ms untraced (medians of {len(rec['ms'])}, "
            f"CUDA events), device busy {rec['busy_share']:.1%} of the timed windows, "
            f"{rec['kernels_per_forward']:.0f} kernels a forward, peak {rec['peak_mb']:.1f} MB")
    if rec["top_ops"]:
        text += "; device time of their own a forward: " + ", ".join(
            f"{k} {ms:.3f} ms ({share:.1%}, {calls:g} calls)" for k, ms, share, calls in rec["top_ops"])
    for k, ms in rec["spans"].items():
        text += f"; span {k}: {ms:.3f} ms a forward ({ms / rec['ms_median']:.1%} of the forward)"
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", type=int, default=4)
    ap.add_argument("--tiers", default="fasthi16,parity")
    ap.add_argument("--modes", default="eager,graph")
    ap.add_argument("--hw", default="339x510")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)

    import torch
    if not torch.cuda.is_available():
        print("forward_trace: no CUDA device", file=sys.stderr)
        return 2
    from ntire2022_esr_tpu_torch.harness import data, registry, tiling
    from ntire2022_esr_tpu_torch.utils import image as img_util

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    h, w = (int(v) for v in args.hw.split("x"))
    hr = data.synthetic_hr(np.random.RandomState(0), 4 * h, 4 * w)
    lr = np.round(hr.reshape(h, 4, w, 4, 3).mean(axis=(1, 3))).astype(np.uint8)
    model, name, dr, tile = registry.build_model(args.model)
    x = torch.from_numpy(img_util.uint2nhwc(lr, dr)).to(next(model.parameters()).device)
    per_call = registry.get_spec(args.model).max_tiles_per_call

    def forward(v):
        return tiling.forward(model, v, tile, max_tiles_per_call=per_call)

    out = []
    for tier in args.tiers.split(","):
        for mode in args.modes.split(","):
            logdir = os.path.join(REPO, "build", "forward_trace", f"{name}_{tier}_{mode}")
            rec = measure(forward, x, tier, mode, args.iters, logdir)
            out.append(dict(rec, model=name))
            print(f"{describe(name, rec)}; on {smi}", flush=True)
    print(json.dumps({"device": smi, "records": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
