"""Each zoo model's sustained ms an image on the card, at one tier and one
dispatch (counterpart of the JAX package's ``tools/sweep_zoo_sustained.py``
and of the split arm of its ``tools/bench_stage_split.py``).

    python -m ntire2022_esr_tpu_torch.tools.sweep_zoo_sustained [ids ...] --mode high
        --method chain|split|fori [--admitted] [--size 256] [--reps 8] [--iters 3]
        [--batch N] [--out results/h100/zoo_sustained.json] [--device cuda]

For each model (all of the registry's by default):
  - ``chain``: ``profiling.chain_timer`` on a seeded f32 batch of
    ``size``² LR images times the data range: ``reps`` forwards queued back
    to back and fenced once, the median of ``iters`` chains;
  - ``split``: ``stagesplit.split_chain_timer`` for the split-capable
    models (``stagesplit.split_ids()``): the body on the batch, the x4 tail
    over chunks of 8;
  - ``fori``: the tiled model (NLFFC) through ``tiling.ChunkedTiler`` on
    one ``size``² frame, as ``harness.serve`` serves it.

The batch starts at 128 (``--batch``) and halves when the card runs out
of memory (``torch.cuda.OutOfMemoryError``, the cache emptied after each),
down to 1 (a split's chunk); any other error propagates. ``--admitted``
keeps the ids whose faster tier ``--mode`` the PSNR-delta ledger admits
(``make_gated_envelope.admits``). Each row is written to ``--out`` as soon
as it is measured, under the key ``"name|mode|method"``, with the card's
``nvidia-smi`` name and power limit in ``device`` (``"cpu"`` on the CPU);
a row already there is skipped only when it was measured the same way
(mode, method, size, reps, iters, device, and the batch where ``--batch``
is given). ``tools/make_gated_envelope.py`` builds the envelope from the
rows.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.harness import registry, stagesplit, tiling
from ntire2022_esr_tpu_torch.harness.profiling import chain_timer
from ntire2022_esr_tpu_torch.ops.kernels import build
from ntire2022_esr_tpu_torch.tools import make_gated_envelope as mge

START_BATCH = 128
SPLIT_CHUNK = 8  # stagesplit.SHIPPED's tail chunk
METHODS = ("chain", "split", "fori")


def device_label(device: torch.device) -> str:
    """The card's ``nvidia-smi`` name and power limit ("cpu" on the CPU)."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[torch.device(device).index or 0]


def row_key(name: str, mode: str, method: str) -> str:
    return f"{name}|{mode}|{method}"


def sweep_ids(ids: Sequence[int], method: str, mode: str, admitted: bool) -> List[int]:
    """The ids a sweep measures: the split-capable ones for ``split``, the
    tiled ones for ``fori``, the others for ``chain``; with ``admitted``,
    those whose tier ``mode`` the delta ledger admits."""
    ids = list(ids) or registry.available_ids()
    tiled = {i for i in ids if registry.get_spec(i).tile is not None}
    if method == "split":
        ids = [i for i in ids if i in stagesplit.split_ids()]
    else:
        ids = [i for i in ids if (i in tiled) == (method == "fori")]
    if admitted:
        with open(mge.DELTAS_PATH) as fh:
            deltas = mge.gated_deltas(json.load(fh))
        ids = [i for i in ids
               if mge.admits(deltas.get(registry.get_spec(i).name, {}).get(mode))]
    return ids


def timer(method: str, mid: int, model, tile: Optional[int], reps: int,
          iters: int) -> Callable[[torch.Tensor], float]:
    """``measure(x)``: median seconds of a chain of ``reps`` forwards on
    ``x`` by the method's dispatch."""
    if method == "split":
        sp = stagesplit.get_split(mid)
        return lambda x: stagesplit.split_chain_timer(sp.body, sp.tail, model, x, SPLIT_CHUNK,
                                                      reps, iters)
    if method == "fori":
        tiler = tiling.ChunkedTiler(model, tile, chunk=registry.get_spec(mid).max_tiles_per_call)
        return lambda x: chain_timer(tiler, x, reps, iters)
    return lambda x: chain_timer(model, x, reps, iters)


def largest_batch(measure: Callable[[torch.Tensor], float],
                  make_x: Callable[[int], torch.Tensor], batch: int, floor: int = 1):
    """``(batch, seconds)``: ``measure`` at ``batch``, halved while the
    card runs out of memory, down to ``floor``; the cache is emptied after
    each failure. Any other error propagates, and so does running out of
    memory at ``floor``."""
    while True:
        x = make_x(batch)
        try:
            return batch, measure(x)
        except torch.cuda.OutOfMemoryError:
            if batch // 2 < floor:
                raise
        finally:
            del x
        # out of the handler, so that its traceback no longer holds the
        # failed forward's tensors
        torch.cuda.empty_cache()
        print(f"   batch {batch}: out of memory; halving", file=sys.stderr, flush=True)
        batch //= 2


def sweep(ids: Sequence[int], mode: str, method: str, out: str, *, size: int = 256,
          reps: int = 8, iters: int = 3, batch: int = 0, admitted: bool = False,
          device="cuda") -> Dict[str, dict]:
    """Measure the rows and write each to ``out`` as it comes; returns the
    file's rows."""
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    if mode not in config.modes():
        raise ValueError(f"unknown tier {mode!r} (have {config.modes()})")
    if admitted and mode == "high":
        raise ValueError("--admitted selects faster tiers; high needs no admission")
    dev = config.resolve_device(device)
    label = device_label(dev)
    rows: Dict[str, dict] = {}
    if os.path.exists(out):
        with open(out) as fh:
            rows = json.load(fh)
    want = {"mode": mode, "method": method, "size": size, "reps": reps, "iters": iters,
            "device": label}
    if dev.type == "cuda":
        build.build()  # every kernel at once (parallel nvcc), not at first launch
    for mid in sweep_ids(ids, method, mode, admitted):
        spec = registry.get_spec(mid)
        key = row_key(spec.name, mode, method)
        old = rows.get(key)
        if old is not None and all(old.get(k) == v for k, v in want.items()) \
                and (not batch or old.get("batch") == batch):
            print(f"[{mid}] {key}: measured the same way, kept", file=sys.stderr, flush=True)
            continue
        model, name, dr, tile = registry.build_model(mid, device=dev)

        def make_x(b: int) -> torch.Tensor:
            x = np.random.RandomState(0).rand(b, size, size, 3).astype(np.float32)
            x *= np.float32(dr)
            return torch.from_numpy(x).to(dev)

        measure = timer(method, mid, model, tile, reps, iters)
        start = 1 if method == "fori" else (batch or START_BATCH)
        floor = SPLIT_CHUNK if method == "split" else 1
        with config.numerics_mode(mode):
            got, seconds = largest_batch(measure, make_x, start, floor)
        row = dict(model_id=mid, batch=got, reps=reps, iters=iters, mode=mode, size=size,
                   method=method, ms_per_image_sustained=seconds * 1e3 / reps / got,
                   device=label)
        if method == "split":
            row["chunk"] = SPLIT_CHUNK
        rows[key] = row
        tmp = out + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(rows, fh, indent=1)
            fh.write("\n")
        os.replace(tmp, out)
        print(f"[{mid}] {key}: {row['ms_per_image_sustained']:.4f} ms/img sustained "
              f"(batch {got}) on {label}", flush=True)
        del model, measure
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("ids", nargs="*", type=int)
    ap.add_argument("--mode", default="high", choices=config.modes())
    ap.add_argument("--method", default="chain", choices=METHODS)
    ap.add_argument("--admitted", action="store_true",
                    help="only the ids whose tier --mode the delta ledger admits")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--batch", type=int, default=0,
                    help=f"the first batch tried (default {START_BATCH}; fori: 1 frame)")
    ap.add_argument("--out", default=mge.ROWS_PATH)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    return sweep(args.ids, args.mode, args.method, args.out, size=args.size, reps=args.reps,
                 iters=args.iters, batch=args.batch, admitted=args.admitted,
                 device=args.device)


if __name__ == "__main__":
    main()
