#!/usr/bin/env python3
"""The kernels of one checkout against their plain versions, on the card.

    python3 ntire2022_esr_tpu_torch/tools/chain_check.py [--kernel chain|tail|both]
                                                         [--tiers TIER ...]
                                                         [--root DIR] [--weights DIR]
                                                         [--one-product]

Imports the port's package from ``DIR`` (default: this checkout), so that two
versions of a kernel can be held to the same inputs in one run: unpack the
other commit somewhere (``git archive``) and pass it as ``--root``, with
``--weights`` pointing at this checkout's ``weights/``.

Inputs are those of ``chip_smoke.py``, on model 04's weights, in the
activation dtype of each tier (default fasthi16): RLFN's first RLFB chain on
``8 * randn`` from numpy seed 1 at (8, 256, 256, 46) and seed 3 at
(128, 256, 256, 46); its upsampler (conv3x3 + PixelShuffle) on seeds 2 and 4
at the same shapes. Prints, per tier and input, the largest and mean
difference, the flip rate (share of outputs that differ at all from the
plain version's) and the kernel's time (median of 5 CUDA-event timings),
with the card's name and power limit. Under fasthi each flip rate is set
against ``FASTHI_FLIP_BARS``, the bar that ``chip_smoke.py`` holds the
2-product split-TF32 kernels to.

``--one-product`` measures a control instead: a copy of the package under
``build/chain_check/one_product/`` whose split-TF32 kernels drop the
``a_hi * w_lo`` product when they take 2 (fasthi then multiplies by TF32
weights alone, one product a MAC; parity keeps its 3). It shows what the
fasthi bar catches.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PKG = "ntire2022_esr_tpu_torch"

# Under fasthi the split-TF32 kernels (2 products, f32-grade) round the same
# sums to bf16 as the plain version, and differ only where the two f32 sums
# straddle a rounding boundary (one ulp, which a chain's later stages carry
# on). Share of outputs that differ at all, at most: 2-3x the H100's
# readings on chip_smoke.py's phase 2-3 inputs (chain 3.3e-3 and 4.4e-3,
# tail 3.0e-4 and 3.8e-4), far below a kernel that multiplies by TF32
# weights alone (about 0.24 and 0.10 emulated on the CPU).
FASTHI_FLIP_BARS = {"chain": 1e-2, "tail": 1e-3}

# The control's text patch of csrc/mma_stage.cuh: the w_lo product only
# where the kernel takes 3 products.
ONE_PRODUCT_PATCH = (
    "              mma_m16n8k8_tf32(acc[m][n], x0, x1, x2, x3, l0, l1);\n",
    "              if (P == 3) mma_m16n8k8_tf32(acc[m][n], x0, x1, x2, x3, l0, l1);\n")


def one_product_copy(dst: str) -> str:
    """A copy of the package under ``dst`` whose 2-product kernels issue
    a_hi * w_hi alone; returns ``dst``. Fails if the patch's anchor is not
    in the source exactly once."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, PKG, "csrc", "mma_stage.cuh")
    with open(path) as fh:
        text = fh.read()
    anchor, new = ONE_PRODUCT_PATCH
    if text.count(anchor) != 1:
        raise RuntimeError(f"{path}: anchor not found exactly once: {anchor!r}")
    with open(path, "w") as fh:
        fh.write(text.replace(anchor, new))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", default="chain", choices=["chain", "tail", "both"])
    ap.add_argument("--tiers", nargs="*", default=["fasthi16"],
                    choices=["parity", "high", "fasthi", "fasthi16"])
    ap.add_argument("--root", default=REPO, help="checkout whose package is measured")
    ap.add_argument("--weights", default=os.path.join(REPO, "weights"))
    ap.add_argument("--one-product", action="store_true",
                    help="measure the one-product control (a patched copy of this checkout)")
    args = ap.parse_args()
    if args.one_product:
        args.root = one_product_copy(os.path.join(REPO, "build", "chain_check", "one_product"))
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
    print(f"{os.path.abspath(args.root)}{' (one-product control)' if args.one_product else ''} "
          f"on {smi}")
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
    for tier in args.tiers:
        with config.numerics_mode(tier), torch.inference_mode():
            dt = config.numerics().activation_dtype
            for name in ("chain", "tail") if args.kernel == "both" else (args.kernel,):
                kernel, plain, inputs = cases[name]
                for batch, seed in inputs:
                    x = np.random.RandomState(seed).standard_normal((batch, 256, 256, 46))
                    x = ops.from_nhwc(torch.from_numpy(x.astype(np.float32) * 8).cuda()).to(dt)
                    out, ref = kernel(x), plain(x)
                    d = (out.float() - ref.float()).abs()
                    flips = float((out != ref).float().mean())
                    times = []
                    for _ in range(7):
                        a = torch.cuda.Event(enable_timing=True)
                        b = torch.cuda.Event(enable_timing=True)
                        a.record()
                        kernel(x)
                        b.record()
                        b.synchronize()
                        times.append(a.elapsed_time(b))
                    bar = FASTHI_FLIP_BARS[name]
                    verdict = (f" ({'under' if flips <= bar else 'over'} the fasthi bar {bar:.0e})"
                               if tier == "fasthi" else "")
                    print(f"{name} [{tier}] batch {batch} seed {seed}: max|d| {float(d.max()):.3e} "
                          f"mean|d| {float(d.mean()):.3e} max|ref| {float(ref.abs().max()):.3e} "
                          f"flip rate {flips:.3e}{verdict} kernel "
                          f"{float(np.median(times[2:])):.3f} ms", flush=True)
                    del x, out, ref, d
    return 0


if __name__ == "__main__":
    sys.exit(main())
