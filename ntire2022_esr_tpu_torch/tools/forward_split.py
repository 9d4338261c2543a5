#!/usr/bin/env python3
"""Where one served forward spends its time on the card, piece by piece.

    python3 ntire2022_esr_tpu_torch/tools/forward_split.py [--model 4] [--batch 32] [--size 256]
        [--runs 9]

Builds ``SRServer(model_id=...)`` at its gated tier (RLFN, 04: fasthi16)
and walks one batch of random uint8 frames (numpy seed 0) through the same
calls as ``SRServer._serve`` and the model's ``forward`` make, with a CUDA
event between the pieces: the copy to the device, uint8 -> float,
``fea_conv``, per RLFB the conv chain, ``c5`` and the ESA, ``LR_conv`` (+
the skip), the tail (conv3x3 + PixelShuffle, the tail kernel),
clip/round/uint8 and the copy back. A model on the RFDN skeleton
(``models.blocks.RFDNSkeleton``: 00, 06, 08, 12, 14, 15, 17, 22, 25, 35,
37, 38, 40) walks ``fea_conv``, each block whole, the 1x1 fusion,
``LR_conv`` (+ the skip) and its x4 upsampler (``blocks.upsample``, the
tail kernel) instead. It prints the
median of ``--runs`` runs per piece, per image and as a share, the same sums
per kind of piece, the time of one whole ``_serve`` call for comparison, and
the card's name and power limit. The walk's output must equal ``_serve``'s
bit for bit; the script only reads times and changes nothing that serves.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def rlfn_body(model, x, mark):
    """RLFN's forward from the float NHWC batch ``x`` to its NHWC output,
    calling ``mark`` after each piece."""
    from ntire2022_esr_tpu_torch import ops
    from ntire2022_esr_tpu_torch.ops.kernels import fused_conv3x3_chain, fused_conv3x3_pixelshuffle

    fea = ops.conv(model.fea_conv, ops.from_nhwc(x))
    mark("fea_conv")
    h = fea
    for i in range(1, model.num_modules + 1):
        blk = getattr(model, f"B{i}")
        convs = (blk.c1_r, blk.c2_r, blk.c3_r)
        out = fused_conv3x3_chain(h, [c.weight for c in convs], [c.bias for c in convs],
                                  slope=blk.slope, residual=True,
                                  scales=[ops.nn.weight_scale(c) for c in convs])
        mark(f"B{i} chain")
        out = ops.conv(blk.c5, out, padding=0)
        mark(f"B{i} c5")
        h = blk.esa(out)
        mark(f"B{i} ESA")
    h = ops.conv(model.LR_conv, h) + fea
    mark("LR_conv + fea")
    up = model.upsampler[0]
    y = ops.to_nhwc(fused_conv3x3_pixelshuffle(h, up.weight, up.bias, r=model.upscale,
                                               scale=ops.nn.weight_scale(up)))
    mark("tail")
    return y


def skeleton_body(model, x, mark):
    """:func:`rlfn_body` of a model on the RFDN skeleton."""
    from ntire2022_esr_tpu_torch import ops
    from ntire2022_esr_tpu_torch.models import blocks

    fea = ops.conv(model.fea_conv, ops.from_nhwc(x))
    mark("fea_conv")
    h, outs = fea, []
    for i in range(1, model.num_modules + 1):
        h = getattr(model, f"{model.prefix}{i}")(h)
        outs.append(h)
        mark(f"B{i} block")
    h = model.fuse_act(ops.conv(blocks.seq(model.c, 0), ops.cat(outs), padding=0))
    mark("1x1 fusion")
    h = ops.conv(model.LR_conv, h) + fea
    mark("LR_conv + fea")
    y = blocks.upsample(model.upsampler, h, model.upscale)
    mark("tail")
    return y


def walk(srv, frames: np.ndarray, body):
    """One forward in pieces, the model's own (``body``) between the
    server's framing: ``(output on the host, [(piece, ms), ...], host ms
    to pin)``."""
    import torch
    from ntire2022_esr_tpu_torch import config

    dr = srv._dr
    marks = []

    def mark(name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    with torch.inference_mode(), config.numerics_mode(srv.tier):
        t0 = time.perf_counter()
        pinned = torch.from_numpy(frames).pin_memory()
        pin_ms = (time.perf_counter() - t0) * 1e3
        mark("start")
        u8 = pinned.to(srv.device, non_blocking=True)
        mark("copy to the device (uint8, pinned)")
        x = u8.float() / (255.0 / dr)
        mark("uint8 -> float, / (255 / dr)")
        y = body(srv._model, x, mark)
        y = torch.round(y.clamp(0, dr) * (255.0 / dr)).to(torch.uint8)
        mark("clip, round, -> uint8")
        host = y.cpu()
        mark("copy to the host (uint8)")
    torch.cuda.synchronize()
    times = [(name, marks[k - 1][1].elapsed_time(ev)) for k, (name, ev) in enumerate(marks) if k]
    return host, times, pin_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", type=int, default=4)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--runs", type=int, default=9)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    from ntire2022_esr_tpu_torch.harness import serving
    from ntire2022_esr_tpu_torch.models import blocks

    if not torch.cuda.is_available():
        print("forward_split: needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    srv = serving.SRServer(model_id=args.model, max_batch=args.batch, device="cuda")
    if args.model == 4:
        body = rlfn_body
    elif isinstance(srv._model, blocks.RFDNSkeleton):
        body = skeleton_body
    else:
        print(f"forward_split: no walk for model {args.model}", file=sys.stderr)
        return 2
    frames = np.random.RandomState(0).randint(
        0, 256, (args.batch, args.size, args.size, 3), dtype=np.uint8)
    srv.warmup((args.size, args.size))
    want = srv._serve(srv._to_device(frames)).cpu()
    runs, pins, whole = [], [], []
    for k in range(args.runs + 2):
        host, times, pin_ms = walk(srv, frames, body)
        if not torch.equal(host, want):
            print("forward_split: the walk's output differs from SRServer._serve's", file=sys.stderr)
            return 1
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        u8 = srv._to_device(frames)
        torch.cuda.synchronize()
        a.record()
        srv._serve(u8)
        b.record()
        b.synchronize()
        if k >= 2:  # the first two warm up
            runs.append(times)
            pins.append(pin_ms)
            whole.append(a.elapsed_time(b))
    names = [n for n, _ in runs[0]]
    med = {n: float(np.median([dict(r)[n] for r in runs])) for n in names}
    total = sum(med.values())
    print(f"SRServer(model_id={args.model}) [{srv.tier}], batch {args.batch}, {args.size}x{args.size}, "
          f"median of {args.runs} runs, CUDA events, on {smi}")
    print(f"{'piece':40s} {'ms a batch':>11s} {'ms an image':>12s} {'share':>7s}")
    for n in names:
        print(f"{n:40s} {med[n]:11.3f} {med[n] / args.batch:12.4f} {med[n] / total:7.1%}")
    print(f"{'sum of the pieces':40s} {total:11.3f} {total / args.batch:12.4f}")
    kinds = ({"RLFB chains (4)": "chain", "RLFB c5 (4)": "c5", "RLFB ESAs (4)": "ESA"}
             if body is rlfn_body else {"blocks": "block"})
    for label, key in kinds.items():
        v = sum(med[n] for n in names if n.startswith("B") and n.endswith(key))
        print(f"{label:40s} {v:11.3f} {v / args.batch:12.4f} {v / total:7.1%}")
    w = float(np.median(whole))
    print(f"{'one _serve call (device part, whole)':40s} {w:11.3f} {w / args.batch:12.4f}")
    print(f"host: pinning the batch takes {float(np.median(pins)):.3f} ms (host clock)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
