#!/usr/bin/env python3
"""The conv-chain kernel of one checkout against its plain version, on the card.

    python3 ntire2022_esr_tpu_torch/tools/chain_check.py [--root DIR] [--weights DIR]

Imports the port's package from ``DIR`` (default: this checkout), so that two
versions of the kernel can be held to the same inputs in one run: unpack the
other commit somewhere (``git archive``) and pass it as ``--root``, with
``--weights`` pointing at this checkout's ``weights/``.

Inputs are those of ``chip_smoke.py`` under fasthi16: RLFN's first RLFB chain
(model 04's weights) on ``8 * randn`` from numpy seed 1 at (8, 256, 256, 46)
and seed 3 at (128, 256, 256, 46). Prints, per input, the largest and mean
difference, the flip rate (share of f16 outputs that differ at all from the
plain version's) and the kernel's time (median of 5 CUDA-event timings), with
the card's name and power limit.
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
    ap.add_argument("--root", default=REPO, help="checkout whose package is measured")
    ap.add_argument("--weights", default=os.path.join(REPO, "weights"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from ntire2022_esr_tpu_torch import config, ops
    from ntire2022_esr_tpu_torch.harness import registry
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain

    if not torch.cuda.is_available():
        print("chain_check: needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{os.path.abspath(args.root)} on {smi}")
    model = registry.build_model(4, weights_dir=args.weights, device="cuda")[0]
    convs = (model.B1.c1_r, model.B1.c2_r, model.B1.c3_r)
    ws, bs = [c.weight for c in convs], [c.bias for c in convs]
    with config.numerics_mode("fasthi16"), torch.inference_mode():
        for batch, seed in ((8, 1), (128, 3)):
            x = np.random.RandomState(seed).standard_normal((batch, 256, 256, 46)).astype(np.float32)
            x = ops.from_nhwc(torch.from_numpy(x * 8).cuda()).half()
            out = conv_chain.fused_conv3x3_chain(x, ws, bs)
            ref = conv_chain.conv3x3_chain_plain(x, ws, bs)
            d = (out.float() - ref.float()).abs()
            flips = float((out != ref).float().mean())
            times = []
            for _ in range(7):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                conv_chain.fused_conv3x3_chain(x, ws, bs)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            print(f"batch {batch} seed {seed}: max|d| {float(d.max()):.3e} mean|d| "
                  f"{float(d.mean()):.3e} max|ref| {float(ref.abs().max()):.3e} "
                  f"flip rate {flips:.3e} kernel {float(np.median(times[2:])):.3f} ms")
            del x, out, ref, d
    return 0


if __name__ == "__main__":
    sys.exit(main())
