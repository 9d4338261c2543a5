"""Serving CLI (counterpart of ``ntire2022_esr_tpu/harness/serve.py``): serve one
zoo model at its plan from the gated envelope.

    python -m ntire2022_esr_tpu_torch.harness.serve --list
    python -m ntire2022_esr_tpu_torch.harness.serve --model_id 4 --images DIR \
        [--save_dir S] [--tier fast16] [--batch 64] [--envelope PATH]
    python -m ntire2022_esr_tpu_torch.harness.serve --model_id 4 --synthetic 256 \
        --hw 256 256 [--device cpu]

The plan (``harness/envelope.py``) fixes the numerics tier, the device
batch and the dispatch: ``chain`` and ``split`` plans stream the frames
through an ``SRServer`` (bounded pipeline, shape-bucketed batches; a split
plan runs the body at the batch and the x4 tail over chunks); the tiled
``fori`` plan (NLFFC) serves one frame at a time through
``tiling.ChunkedTiler``, whose model runs on fixed chunks of tiles as one
CUDA graph for every frame shape.

The plans are the card's own, ``results/h100/zoo_sustained_gated.json``.
``ntire2022_esr_tpu_torch/tools/sweep_zoo_sustained.py`` times each
model's candidate tiers and dispatches on an H100: chains of forwards
fenced once, at the largest batch from 128 down that fits in the card's
memory. ``ntire2022_esr_tpu_torch/tools/make_gated_envelope.py`` then
keeps, for each model, the fastest tier that the JAX package's PSNR-delta
ledger admits (``results/protocol/numerics_delta_r4.json``: mean shift
within 0.005 dB of parity, worst image within 0.01 dB, on 8 images or
more; HNCT pinned to ``high``). ``--envelope`` serves another file, such
as the JAX package's plans, chosen by its TPU's timings
(``results/protocol/zoo_sustained_gated.json``).

Frames come from ``--images`` (every
image file under a directory; PNG is the one format read),
``--data_dir`` (the DIV2K valid LR set) or ``--synthetic N --hw H W``
(random uint8 frames, numpy seed 0). The last line printed is a JSON
summary; its ``ms_per_image`` is this run's host-clock time per image,
the warm-up excluded. Runs on CUDA unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.harness import data as data_mod
from ntire2022_esr_tpu_torch.harness import envelope as envelope_mod
from ntire2022_esr_tpu_torch.harness import registry
from ntire2022_esr_tpu_torch.harness.tiling import ChunkedTiler
from ntire2022_esr_tpu_torch.utils import image as img_util


def list_plans(path: Optional[str] = None) -> str:
    """The envelope as a table, one row per model. The time column is the
    file's own sustained time, under a header that names the device it was
    measured on (the JAX package's TPU for a file whose rows name none)."""
    plans = envelope_mod.load_envelope(path)
    devices = sorted({p.device or "the JAX package's TPU" for p in plans.values()})
    lines = [f"| model | tier | batch | method | ms/img ({'; '.join(devices)}) | delta dB |",
             "|---|---|---|---|---|---|"]
    for p in sorted(plans.values(), key=lambda p: p.model_id):
        d = "AUTO ledger" if p.tier_delta_db is None else f"{p.tier_delta_db:+.4f}"
        method = p.method if p.method != "split" else f"split/{p.chunk}"
        lines.append(f"| {p.name} | {p.tier} | {p.batch} | {method} "
                     f"| {p.ms_per_image:.2f} | {d} |")
    return "\n".join(lines)


def _frame_paths(args) -> List[str]:
    if args.images:
        return img_util.get_image_paths(args.images)
    sel = data_mod.select_dataset(args.data_dir, "valid")
    paths = [lr for lr, _ in sel if os.path.exists(lr)]
    if not paths:
        raise FileNotFoundError(
            f"no valid-split LR images under {args.data_dir} (expected e.g. {sel[0][0]})")
    return paths


def _frames(args) -> Tuple[Iterator[np.ndarray], List[Optional[str]], int]:
    """(frames, a source name per frame (None for synthetic), count)."""
    if args.synthetic:
        rng = np.random.RandomState(0)
        h, w = args.hw
        frames = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(args.synthetic)]
        return iter(frames), [None] * len(frames), len(frames)
    paths = _frame_paths(args)
    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    return (img_util.imread_uint(p, 3) for p in paths), names, len(paths)


def _out_name(src: Optional[str], idx: int) -> str:
    return f"{src if src else f'frame_{idx:04d}'}_sr.png"


def _serve_tiled(plan, frames: Iterable[np.ndarray], names, save_dir: Optional[str],
                 device: torch.device, warmup: bool = True) -> Tuple[int, float]:
    """One frame at a time through ``ChunkedTiler`` at the plan's tier.
    Returns ``(frames served, clock start)``; with ``warmup`` the first
    frame is run once more before the clock starts (that run builds and
    captures the chunk's graph, which serves every later frame shape)."""
    model, _, dr, tile = registry.build_model(plan.model_id, device=device)
    tiler = ChunkedTiler(model, tile, chunk=registry.get_spec(plan.model_id).max_tiles_per_call)

    def one(frame: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), config.numerics_mode(plan.tier):
            x = torch.from_numpy(img_util.uint2nhwc(frame, dr)).to(device)
            y = tiler(x)
            return img_util.nhwc2uint(y.float().cpu().numpy(), dr)

    t0 = time.perf_counter()
    n = 0
    for frame, src in zip(frames, names):
        if warmup and n == 0:
            one(frame)
            t0 = time.perf_counter()
        sr = one(frame)
        if save_dir:
            img_util.imsave(sr, os.path.join(save_dir, _out_name(src, n)))
        n += 1
    return n, t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("NTIRE2022-EfficientSR-H100 serving")
    ap.add_argument("--model_id", type=int, default=None)
    ap.add_argument("--list", action="store_true", help="print the envelope table and exit")
    ap.add_argument("--envelope", default=None, metavar="PATH",
                    help="gated-envelope file (default: the card's "
                         "results/h100/zoo_sustained_gated.json)")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--images", default=None, metavar="DIR",
                     help="serve every image file under DIR")
    src.add_argument("--data_dir", default=None, metavar="DIR",
                     help="serve the DIV2K valid LR split under DIR")
    src.add_argument("--synthetic", type=int, default=0, metavar="N",
                     help="serve N random uint8 frames")
    ap.add_argument("--hw", type=int, nargs=2, default=(256, 256),
                    help="LR shape for --synthetic (default 256 256)")
    ap.add_argument("--save_dir", default=None)
    ap.add_argument("--tier", default=None, choices=config.modes(),
                    help="override the plan's numerics tier")
    ap.add_argument("--batch", type=int, default=None, help="override the plan's device batch")
    ap.add_argument("--depth", type=int, default=2, help="max in-flight batches")
    ap.add_argument("--no_warmup", action="store_true",
                    help="no warm-up batch before the clock starts")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.list:
        print(list_plans(args.envelope))
        return 0
    if args.model_id is None:
        ap.error("--model_id is required (or --list)")
    if not (args.images or args.data_dir or args.synthetic):
        ap.error("one frame source is required: --images / --data_dir / --synthetic")
    device = config.resolve_device(args.device)
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    plan = envelope_mod.plan_for(args.model_id, args.envelope)
    if args.tier:
        plan = dataclasses.replace(plan, tier=args.tier, batch=args.batch or plan.batch,
                                   tier_delta_db=None)
    batch = args.batch or plan.batch

    frames, names, count = _frames(args)
    t0 = time.perf_counter()
    if plan.method == "fori":
        served, t0 = _serve_tiled(plan, frames, names, args.save_dir, device,
                                  warmup=not args.no_warmup)
    else:
        srv = envelope_mod.make_server(args.model_id, path=args.envelope, max_batch=batch,
                                       depth=args.depth, device=device, tier=plan.tier)
        if not args.no_warmup:
            head = next(frames)
            # the batch the server will dispatch, not the plan's when --batch is smaller
            srv.warmup(head.shape[:2], batch=min(batch, count))
            t0 = time.perf_counter()

            def _chain(h, rest):
                yield h
                yield from rest

            frames = _chain(head, frames)
        served = 0
        for sr, src in zip(srv.process_stream(frames), names):
            if args.save_dir:
                img_util.imsave(sr, os.path.join(args.save_dir, _out_name(src, served)))
            served += 1
    dt = time.perf_counter() - t0

    print(json.dumps({
        "model": plan.name, "tier": plan.tier, "batch": batch, "method": plan.method,
        "device": str(device), "images": served, "seconds": round(dt, 4),
        "images_per_sec": round(served / dt, 3), "ms_per_image": round(1e3 * dt / served, 4),
        "tier_delta_db": plan.tier_delta_db, "saved": bool(args.save_dir),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
