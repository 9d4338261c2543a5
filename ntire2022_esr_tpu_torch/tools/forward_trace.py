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
``runner.GraphedForward`` capture. It prints per tier and mode the median
event time, the device-busy share of the timed windows
(``profiling.busy_share``: the union of the kernels and copies over the
windows' span), the device events a forward and peak memory, and the
median event time of as many forwards run before the trace (the
profiler's own cost on the host shows as their difference), the card's
name and power limit, and one JSON line at the end. The traces are
written under ``build/forward_trace/``.
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


def measure(model, x, tier: str, mode: str, iters: int, logdir: str) -> dict:
    """One tier and mode of ``model`` on the device tensor ``x`` (see the
    module docstring); the trace goes to ``logdir``."""
    import torch
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import profiling, runner

    dev = x.device
    timer = profiling.Timer(dev)
    with config.numerics_mode(tier), torch.inference_mode():
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        if mode == "graph":
            graphed = runner.GraphedForward(model, dev)
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
        with profiling.trace(logdir):
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
            "peak_mb": peak}


def describe(name: str, rec: dict) -> str:
    h, w = rec["hw"]
    return (f"{name} {rec['tier']} {rec['mode']} LR {h}x{w} batch 1: {rec['ms_median']:.3f} ms "
            f"traced, {rec['ms_untraced_median']:.3f} ms untraced (medians of {len(rec['ms'])}, "
            f"CUDA events), device busy {rec['busy_share']:.1%} of the timed windows, "
            f"{rec['kernels_per_forward']:.0f} kernels a forward, peak {rec['peak_mb']:.1f} MB")


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
    from ntire2022_esr_tpu_torch.harness import data, registry
    from ntire2022_esr_tpu_torch.utils import image as img_util

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    h, w = (int(v) for v in args.hw.split("x"))
    hr = data.synthetic_hr(np.random.RandomState(0), 4 * h, 4 * w)
    lr = np.round(hr.reshape(h, 4, w, 4, 3).mean(axis=(1, 3))).astype(np.uint8)
    model, name, dr, _ = registry.build_model(args.model)
    x = torch.from_numpy(img_util.uint2nhwc(lr, dr)).to(next(model.parameters()).device)
    out = []
    for tier in args.tiers.split(","):
        for mode in args.modes.split(","):
            logdir = os.path.join(REPO, "build", "forward_trace", f"{name}_{tier}_{mode}")
            rec = measure(model, x, tier, mode, args.iters, logdir)
            out.append(dict(rec, model=name))
            print(f"{describe(name, rec)}; on {smi}", flush=True)
    print(json.dumps({"device": smi, "records": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
