#!/usr/bin/env python3
"""The kernels of one checkout against their plain versions, on the card.

    python3 ntire2022_esr_tpu_torch/tools/chain_check.py [--kernel chain|tail|both]
                                                         [--root DIR] [--weights DIR]

Imports the port's package from ``DIR`` (default: this checkout), so that two
versions of a kernel can be held to the same inputs in one run: unpack the
other commit somewhere (``git archive``) and pass it as ``--root``, with
``--weights`` pointing at this checkout's ``weights/``.

Inputs are those of ``chip_smoke.py`` under fasthi16, on model 04's weights:
RLFN's first RLFB chain on ``8 * randn`` from numpy seed 1 at
(8, 256, 256, 46) and seed 3 at (128, 256, 256, 46); its upsampler
(conv3x3 + PixelShuffle) on seeds 2 and 4 at the same shapes. Prints, per
input, the largest and mean difference, the flip rate (share of f16 outputs
that differ at all from the plain version's) and the kernel's time (median of
5 CUDA-event timings), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", default="chain", choices=["chain", "tail", "both"])
    ap.add_argument("--root", default=REPO, help="checkout whose package is measured")
    ap.add_argument("--weights", default=os.path.join(REPO, "weights"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from ntire2022_esr_tpu_torch import config, ops
    from ntire2022_esr_tpu_torch.harness import registry
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail

    if not torch.cuda.is_available():
        print("chain_check: needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{os.path.abspath(args.root)} on {smi}")
    model = registry.build_model(4, weights_dir=args.weights, device="cuda")[0]
    convs = (model.B1.c1_r, model.B1.c2_r, model.B1.c3_r)
    ws, bs = [c.weight for c in convs], [c.bias for c in convs]
    up = model.upsampler[0]
    # kernel -> (wrapper on x, plain version on x, (batch, numpy seed) of each input)
    cases = {
        "chain": (lambda x: conv_chain.fused_conv3x3_chain(x, ws, bs),
                  lambda x: conv_chain.conv3x3_chain_plain(x, ws, bs), ((8, 1), (128, 3))),
        "tail": (lambda x: tail.fused_conv3x3_pixelshuffle(x, up.weight, up.bias),
                 lambda x: tail.conv3x3_pixelshuffle_plain(x, up.weight, up.bias),
                 ((8, 2), (128, 4))),
    }
    with config.numerics_mode("fasthi16"), torch.inference_mode():
        for name in ("chain", "tail") if args.kernel == "both" else (args.kernel,):
            kernel, plain, inputs = cases[name]
            for batch, seed in inputs:
                x = np.random.RandomState(seed).standard_normal((batch, 256, 256, 46))
                x = ops.from_nhwc(torch.from_numpy(x.astype(np.float32) * 8).cuda()).half()
                out, ref = kernel(x), plain(x)
                d = (out.float() - ref.float()).abs()
                flips = float((out != ref).float().mean())
                times = []
                for _ in range(7):
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    kernel(x)
                    b.record()
                    b.synchronize()
                    times.append(a.elapsed_time(b))
                print(f"{name} batch {batch} seed {seed}: max|d| {float(d.max()):.3e} mean|d| "
                      f"{float(d.mean()):.3e} max|ref| {float(ref.abs().max()):.3e} "
                      f"flip rate {flips:.3e} kernel {float(np.median(times[2:])):.3f} ms")
                del x, out, ref, d
    return 0


if __name__ == "__main__":
    sys.exit(main())
