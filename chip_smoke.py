#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ntire2022_esr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device and build: the card's name and power limit; both CUDA kernels
   compiled from ``ntire2022_esr_tpu_torch/csrc`` (nvcc, sm_90a), with the
   ptxas register/shared-memory report;
2. first one stock bf16 and one f16 conv (cuDNN, RLFN's 46 -> 48) against
   an f64 conv of the same rounded operands, rounded to the dtype: within
   one ulp, so cuDNN sums 2-byte convs in f32 on this card. Then the
   conv-chain kernels against their plain PyTorch version on the card, at
   (8, 256, 256, 46) with widths 46 -> 48 -> 48 -> 46 and at (2, 63, 41,
   46), under parity, high, mixed, fasthi16, fasthi, fast and fast16 (f32
   activations: the split-TF32 kernel with 3 products; bf16 with f32
   weights (fasthi): the split-TF32 kernel with 2; f16 with f32 weights
   (fasthi16): the m16n8k16 kernel with two f16 products; fast16 and fast:
   the m16n8k16 kernel with one f16 or bf16 product on weights packed
   rounded to the dtype, and the bias added after the sum's rounding);
   under parity, high and
   mixed each kernel's largest error against an f64 chain (cuDNN in
   float64) at most 4x the plain f32 chain's (cuDNN f32, TF32 off), under
   the 2-byte tiers the flip rate (under fasthi, fast and fast16 at most
   ``tools/chain_check.py``'s ``FLIP_BARS``; under fast and fast16 also the
   flip rate against a plain version that adds the bias inside one
   rounding, which must be at least 10x as high); under fasthi16, parity,
   fasthi, fast and fast16 also chains of one and two stages and of other
   widths (24 -> 24 -> 24, 20 -> 24 -> 24 -> 20, 5 -> 7 -> 5), so that the
   padding paths run;
3. the conv+PixelShuffle kernels against their plain version, same shapes,
   tiers and checks; under fasthi16, parity, fasthi, fast and fast16 also
   other widths and factors (the zoo's upsamplers 40, 42, 50, 64 -> 48
   r=4, 24 -> 27 r=3, 5 -> 12 r=2, 16 -> 64 r=4), an image smaller than one
   tile and a missing bias, so that the padding, general-row, second-chunk
   and plain-copy paths run beside the tensor copies; and under the same five
   tiers the HR tails' x2 upsamplers (``R2_WIDTHS``: 24 -> 96, 32 -> 128,
   52 -> 208, 64 -> 256, r = 2, the last two in channel groups) at
   (2, 37, 29), an image no tile divides, and at (4, 64, 64), held by the
   same checks as RLFN's tail: the flip bars, the one-rounding control
   under fast and fast16, f64 under parity;
4. golden parity: the port's RLFN under parity on the card against
   ``tests/goldens/model_04*.npz`` within 2e-4 * 255;
5. serving: ``SRServer(model_id=4)`` at its gated tier streams three
   batches of 32 random 256x256 uint8 frames (numpy seed 0) through the
   kernels (launch counts checked: 4 chain launches and 1 tail launch per
   forward; both kernels' weights are packed during warm-up and never in
   the stream), and its output is held against the same forward built from
   the plain versions on the card; then 8 frames served under each other
   tier with a path of its own: parity and mixed (the 3-product split-TF32
   kernels, at most 1 level from the plain forward), fasthi (2 products),
   fast and fast16 (one bf16 or f16 m16n8k16 product, the two-rounding
   epilogue), the last three held to the tier's own chaos: no further from
   the plain forward than the plain forward moves when its input moves by
   1e-4; each run counts its path's launches (``tf32x3``, ``tf32x2``,
   ``bf16x1``, ``f16x1``; ``f16`` is fasthi16's);
6. times at the served shape (batch 128, 256x256, fasthi16): each kernel,
   its plain version and one PyTorch library call computing the same
   function (cuDNN f32 with TF32 off on the upcast f16 activations and the
   f32 weights, each conv's output rounded to f16), medians of CUDA-event
   timings, beside cuDNN f16 (the weights rounded to f16: another
   function) and the bound: the card's best rate for the work whatever
   implements it (two f16 products a MAC, the f32-grade form of f16
   activations and f32 weights) against the bytes; and each kernel's flip
   rate, the share of f16 outputs that differ between the kernel and its
   plain version.
   Then the same for the split-TF32 kernels under parity and fasthi (cuDNN
   f32 with TF32 off as the library call, under fasthi each conv's output
   rounded to bf16, cuDNN bf16 beside it; the bound the cheapest f32-grade
   form of the operands: 3 TF32 products on f32 activations, 3 bf16
   products on bf16 ones, with the kernels' own form and the old bound of
   an f32 CUDA-core kernel beside it) and for fast and fast16 (cuDNN bf16
   and f16 as the library call; the bound one 2-byte product at 989
   TFLOP/s against 2-byte bytes, the kernels' own form): the chain, and the
   tail at every upsampler width of the ported zoo (40, 42, 46, 50, 64 ->
   48, r = 4) under parity, fasthi, fast and fast16, and under fasthi16
   beside cuDNN f32 rounded to f16 and cuDNN f16; then the four x2
   upsamplers under fast, fast16, fasthi and fasthi16 at batch 16 at the
   size each sees for a 256x256 LR input (``R2_TIMED``), beside the same
   library calls + PixelShuffle(2);
7. the challenge protocol on six valid and two test synthetic DIV2K pairs
   (numpy seed 0, written by the port's PNG codec under ``build/``; LR widths
   with W mod 4 = 0, 1, 2 and 3): ``harness.cli.main`` for model 04 under
   parity with SSIM (results.json keys, the complexity report against the
   JAX package's numbers, per-image runtime and peak memory), and under
   parity and fasthi16 each image's PSNR within 0.01 dB of the plain forward
   on the card, and over each whole image parity outputs at most 1 level
   apart, fasthi16's under phase 5's bar (under 1e-4 of values 2+ levels
   apart, under 0.2 1+ apart); the x8 ensemble and
   ``tiled_apply`` (tile 128, overlap 32, 16 tiles a call) at most 1 level
   from the plain path under parity; ``run_batched(u8_io=True)`` under
   fasthi16 held to ``run``'s outputs. The runners time a CUDA graph per
   input shape: every protocol run counts one replay per image (one per
   batch for ``run_batched``) and 4 chain launches and 1 tail launch in
   each captured graph and in the warm-up before it; the peak memory of six
   shapes equals that of the largest alone (one graph alive at a time).
   Beside them, RLFN at LR 339x510, batch 1, eager against graph under
   parity and fasthi16: CUDA-event times and the device-busy share of the
   timed windows from a ``torch.profiler`` trace
   (``tools/forward_trace.py``);
8. the zoo: each of the 41 models besides RLFN (the RFDN skeleton and
   IMDN family, FMEN, RePAFDN, AALN, ARFDN, AFDN, PRRN, FDEN, BSRN,
   IMDeception and MDAN; MDGN, LWFANet, NASNetBN, CLRFDN, SR_model,
   m_RFDN, ESAN, RFESR, IMDN_plus, RLCSR, ResDN and MSDN; the attention
   family: IMDTN, HNCT, MobileSR and SCET; and NLFFC) built from its
   weights on the card, its 64x64 golden (NLFFC's 97x127 too) under
   parity within 2e-4 * data_range, and one synthetic LR 339x510 image
   through the graph-timed ``runner.run`` at its gated tier (NLFFC tiled
   at 256, 2 tiles a call, as the registry says), whose PSNR must be
   within 0.01 dB of an eager forward's; a line per model with the graph
   and eager times and the peak memory. A model without an HR tail
   launches no kernel in its served forwards (the JAX graphs of all but
   RLFN and the HR tails call no Pallas kernel). For the HR tails (27, 28,
   33, gated at ``high``, their tails under ``fast``) instead: the
   launches of each captured forward (2 tail launches on ``bf16x1``,
   nothing else), no weight pack after the warm-up, and the served PSNR
   within 0.01 dB of the same forward on the kernels' plain versions. For
   NLFFC also: the DFT products' share of an eager forward's device time
   (the ``spectral.dft`` profiler span), how many of its global-context
   softmax maps overflow in f16 under fast16 (their map is 0), the fast16
   image's PSNR against parity's forward of it, and the DFT products
   beside cuFFT's ``rfft``/``irfft`` on one 2-tile chunk's global half;
9. serving: ``harness.serve.main`` in-process, each run's JSON summary
   printed: ``--list`` (every registry model has a plan); ``--model_id 4
   --synthetic 64 --hw 256 256`` (the chain plan: 4 chain launches and 1
   tail launch a forward, warm-up included, and the saved frames equal
   ``SRServer(4)``'s); ``--model_id 28 --synthetic 16 --hw 128 128`` (the
   split plan: 2 ``bf16x1`` tail launches a tail chunk, no weight pack
   after the warm-up, at most 1 level and under 1e-3 of values off the
   unsplit server; then the shipped schedule, body at 128 and tail in
   chunks of 8, timed by ``stagesplit.split_chain_timer`` beside the whole
   forward's ``profiling.chain_timer`` at LR 128x128); ``--model_id 2 --synthetic 2 --hw 339 510`` and then
   ``--images`` with a 339x510 and a 300x420 frame (the tiled plan through
   ``tiling.ChunkedTiler``: one CUDA graph captured in each run, across
   both shapes in the second, no kernel launch, each output at most 1
   level from ``tiled_apply``'s);
10. the multi-device paths (``ntire2022_esr_tpu_torch/parallel/``) on meshes
   that list the one card several times, which run the slab, halo, window,
   padding and pipeline logic and the kernels at the shards' shapes, but
   no copy between two cards: ``harness.cli --batched`` for RLFN on phase
   7's six valid pairs, with and without ``--mesh 1``, as users run it
   (``--mode parity``) and, as an extra check, under fasthi16 through a
   patched ``config.set_mode`` (the results.json entries; each image's
   PSNR within 0.01 dB; 4 chain and 1 tail launches on the tier's path a
   captured forward); ``sharded_batch_apply``
   of RLFN over ``[cuda:0] * 2`` at batch 32, 256x256, against
   ``SRServer``'s output at phase 5's bar (4 + 1 launches a device
   forward); ``SRServer(model_id=4, mesh=...)`` streaming 64 frames, at the
   same bar; NASNetBN under high H-sharded at its halo of 48 over
   ``[cuda:0] * 2``, halo scheme at LR 340x512 and windowed at 339x510, and
   2 images on a (2, 2) (data, space) mesh, each against the whole forward
   (the tier's own move under a 1e-4 input shift, the PSNR within 0.01
   dB) with 2 ``bf16x1`` tail launches a slab, and through
   ``runner.run(spatial_mesh=)`` at LR 340x512, 339x510, 340x512 against
   the one-device run (each entry's graph captured once an image, outside
   the timed window: the third image's time within 20% of the first's);
   ``PipelinedSR(28)`` over
   ``[cuda:0] * 2``: 4 batches in order, each held to its whole forward at
   the same bar. Times: CUDA events from a synchronised start
   (``profiling.MeshTimer``), the streams on the host clock.

The line before the last is one JSON object with a record per kernel and
path (``conv3x3_chain`` and ``conv3x3_pixelshuffle`` for the split-f16
path under fasthi16, ``_f16x1`` and ``_bf16x1`` for the one-product path
under fast16 and fast, and ``_tf32x3`` and ``_tf32x2`` for the split-TF32
ones; ``conv3x3_pixelshuffle_bf16x1_r2_<cin>to<channels>`` for the HR
tails' x2 upsamplers under fast, whose launches are counted in phase 8's
served forwards); the kernels launched in phase 10 carry ``mesh_launches``,
their launches there. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
import subprocess
import sys
import time
import traceback
import types
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit: f16 and bf16
# on the tensor cores, TF32 on them, f32 outside them (the bound of an f32
# CUDA-core kernel, printed beside the others) and HBM3 bandwidth
PEAK_F16_FLOPS = 989e12  # and bf16
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the kernels' own form under each tier: (products a MAC, rate, operand
# type); fast and fast16 run one m16n8k16 product on their 2-byte operands
KERNEL_FORM = {"fasthi16": (2, PEAK_F16_FLOPS, "f16"),
               "parity": (3, PEAK_TF32_FLOPS, "TF32"), "high": (3, PEAK_TF32_FLOPS, "TF32"),
               "mixed": (3, PEAK_TF32_FLOPS, "TF32"), "fasthi": (2, PEAK_TF32_FLOPS, "TF32"),
               "fast": (1, PEAK_F16_FLOPS, "bf16"), "fast16": (1, PEAK_F16_FLOPS, "f16")}
F32_TIERS = ("parity", "high", "mixed")  # f32 activations: held against f64
TWO_BYTE_TIERS = ("fast", "fast16")  # 2-byte weights, the bias after the rounding
# the library call of each tier in phase 6 computes the kernels' function:
# where the weights are 2-byte (fast, fast16), cuDNN in that dtype; where
# they are f32, cuDNN f32 with TF32 off on the activations upcast to f32,
# each conv's output rounded to the tier's storage dtype (fasthi16 and
# fasthi store f16 and bf16). cuDNN in the storage dtype, which rounds the
# f32 weights to it, is another function: it is timed beside them
# (``TWO_BYTE_LIBRARY``) and labelled so
LIBRARY_DTYPE = {"fast": "bfloat16", "fast16": "float16"}
TWO_BYTE_LIBRARY = ("fasthi16", "fasthi")
# The bound of an f32-grade path is its operands' cheapest f32-grade form on
# the card, whatever the kernel issues: (products a MAC, rate, name). f32
# activations: 3 TF32 products (a split into bf16 terms needs 6 at twice
# the rate, the same time). bf16 activations are exact bf16 values: the
# weight split into three bf16 terms (24 bits) gives 3 bf16 products at 989
# TFLOP/s, less time than the kernels' 2 TF32 products at 495 (3/989 against
# 2/495 = 4/989).
# Under fast and fast16 the operands themselves are 2-byte: one bf16 or f16
# product a MAC at 989 TFLOP/s. fasthi16's f16 activations are exact f16
# values and its f32 weights need two f16 terms for f32-grade products
# (2^-22 relative; ROADMAP, the split-f16 products): two f16 products a MAC.
F32_GRADE_BOUND = {"fasthi16": (2, PEAK_F16_FLOPS, "f16 x2 at 989 TFLOP/s"),
                   "parity": (3, PEAK_TF32_FLOPS, "TF32 x3 at 495 TFLOP/s"),
                   "high": (3, PEAK_TF32_FLOPS, "TF32 x3 at 495 TFLOP/s"),
                   "mixed": (3, PEAK_TF32_FLOPS, "TF32 x3 at 495 TFLOP/s"),
                   "fasthi": (3, PEAK_F16_FLOPS, "bf16 x3 at 989 TFLOP/s"),
                   "fast": (1, PEAK_F16_FLOPS, "bf16 x1 at 989 TFLOP/s"),
                   "fast16": (1, PEAK_F16_FLOPS, "f16 x1 at 989 TFLOP/s")}
F64_BAR = 4.0  # a kernel's error against f64 at most this many times cuDNN f32's

SERVE_BATCH = 32
SERVE_BATCHES = 3
TIME_BATCH = 128
SIZE = 256
CHAIN_WIDTHS = (46, 48, 48, 46)

# phase 7: DIV2K-like LR shapes (H, W); the widths cover W mod 4 = 2, 3, 0, 1
PROTOCOL_VALID = ((339, 510), (510, 339), (384, 508), (341, 341), (351, 510), (255, 383))
PROTOCOL_TEST = ((339, 510), (255, 383))
# the JAX package's summary.model_complexity of RLFN at 256x256 on the CPU
RLFN_COMPLEXITY = {"activations": 80.045184, "num_conv": 39, "flops": 19.857590272,
                   "num_parameters": 0.317218}
# the keys of the JAX CLI's results.json entry with --ssim --include_test
PROTOCOL_KEYS = sorted([f"{m}_{k}" for m in ("valid", "test") for k in (
    "runtime", "psnr", "ssim", "memory", "ave_runtime", "ave_psnr", "ave_ssim")]
    + list(RLFN_COMPLEXITY))
PSNR_BAR_DB = 0.01  # the challenge's
# phase 8: every id but 04 in the registry: the RFDN skeleton and IMDN family,
# the ten models of the third zoo slice, the twelve of the fourth, the
# attention family and NLFFC
ZOO_IDS = (-1, 0, 1, 3, 5, 6, 8, 10, 11, 13, 14, 15, 16, 17, 18, 19, 22, 23, 25, 26, 35, 37,
           38, 40, 24, 27, 28, 29, 31, 33, 34, 36, 39, 42, 43, 44, 9, 12, 20, 30, 2)
# NLFFC (02): the goldens held under parity, and the transform timed beside
# cuFFT on one 2-tile chunk's global half at the 1024x1024 body
NLFFC_GOLDENS = ("model_02", "model_02_97x127")
NLFFC_DFT_SHAPE = (2, 1024, 1024, 32)
F16_INF = 65520.0  # the least f32 value that rounds to inf in f16
# phase 9: serve.main runs (argv, the test frame shapes)
SERVE_CHAIN = ["--model_id", "4", "--synthetic", "64", "--hw", "256", "256"]
SERVE_SPLIT = ["--model_id", "28", "--synthetic", "16", "--hw", "128", "128"]
SPLIT_TIMING_HW, SPLIT_TIMING_REPS = (128, 128), 4  # the split schedule's chain timing
SERVE_TILED = ["--model_id", "2", "--synthetic", "2", "--hw", "339", "510"]
TILED_SECOND = (300, 420)  # a second frame shape for NLFFC's one chunk graph
SPLIT_TAIL_LAUNCHES = 2  # NASNetBN's tail: two x2 upsamplers a chunk
# the HR tails and their x2 upsamplers (cin, conv channels): each captured
# forward of the served model launches the tail kernel on each once
HR_TAILS = {27: ((64, 256), (64, 256)), 28: ((32, 128), (32, 128)), 33: ((52, 208), (24, 96))}
# phase 3: the x2 upsamplers as (cin, cout) of the shuffle; phase 6 times them
# at batch R2_BATCH on the LR side each sees for a 256x256 input
R2_WIDTHS = ((24, 24), (32, 32), (52, 52), (64, 64))
R2_BATCH = 16
R2_TIMED = ((24, 24, 512), (32, 32, 256), (52, 52, 256), (64, 64, 256))
SKELETON_NF = 50  # fea width of the RFDN baseline (00, 06, 08, 35, 38)
# phase 10: meshes that list the one card several times. NASNetBN (28,
# slab-safe, halo 48) at a height 2 slabs divide (halo scheme) and at an
# odd one (windowed), and 2 images on a (2, 2) mesh; the pipeline's batches
MESH_NAS_HW = ((340, 512), (339, 510))
MESH_PIPE_BATCHES, MESH_PIPE_SHAPE = 4, (2, 128, 128, 3)
# runner.run's third image repeats the first's shape: its time is held
# within this share of the first's (a capture in the window would add an
# eager forward and the capture itself, more than doubling it)
MESH_REPEAT_TIME_BAR = 0.2
MESH_SERVE_FRAMES = 64


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# flip-rate checks that failed in the current phase: the phase reads every
# case before it fails, so that one call shows all of them
FLIP_FAILURES: list = []


def end_phase_checks(name: str) -> None:
    require(not FLIP_FAILURES, f"{name}: flip-rate checks failed: {FLIP_FAILURES}")


def phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def chain_args(model, shape, dtype, seed):
    """Input of the RLFB body at ``shape`` (NHWC) and the B1 chain's weights."""
    import torch
    from ntire2022_esr_tpu_torch import ops

    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32) * 8
    x = ops.from_nhwc(torch.from_numpy(x).cuda()).to(dtype)
    convs = (model.B1.c1_r, model.B1.c2_r, model.B1.c3_r)
    return x, [c.weight for c in convs], [c.bias for c in convs]


def reset_counts() -> None:
    """Every launch count of both kernel modules to 0."""
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail

    for mod in (conv_chain, tail):
        for k in mod.launches_by_path:
            mod.launches_by_path[k] = 0
    tail.launches_by_shape.clear()


def path_counts(path: str):
    """(chain, tail) launches on ``path`` since the last reset_counts()."""
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail

    return conv_chain.launches_by_path[path], tail.launches_by_path[path]


def total_counts():
    """(chain, tail) launches on every path since the last reset_counts()."""
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail

    return sum(conv_chain.launches_by_path.values()), sum(tail.launches_by_path.values())


def path_of(tier: str) -> str:
    """The kernels' path under ``tier``: the wrappers' own choice."""
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain

    return conv_chain.path(config._MODES[tier])


def entry_of(kname: str, tier: str) -> str:
    """The kernels line's name of ``kname``'s instantiation under ``tier``:
    the kernel's own name for the split-f16 path under fasthi16,
    ``_<path>`` for the others."""
    return kname if tier == "fasthi16" else f"{kname}_{path_of(tier)}"


def random_chain(shape, chans, seed, dtype=None):
    """A chain of other widths than RLFN's: input (NHWC ``shape``, f16 or
    ``dtype``) and f32 weights and biases from numpy ``seed``."""
    import torch
    from ntire2022_esr_tpu_torch import ops

    rs = np.random.RandomState(seed)
    x = ops.from_nhwc(torch.from_numpy(rs.standard_normal(shape).astype(np.float32) * 8).cuda())
    # the weights outside inference mode: the packed-weight cache refuses
    # inference tensors, which carry no version
    with torch.inference_mode(False):
        ws = [torch.from_numpy(rs.standard_normal((co, ci, 3, 3)).astype(np.float32) * 0.05)
              .cuda() for ci, co in chans]
        bs = [torch.from_numpy(rs.standard_normal(co).astype(np.float32) * 0.1).cuda()
              for _, co in chans]
    return x.to(dtype or torch.float16), ws, bs


def flip_rate(out, ref) -> float:
    """Share of values that differ at all between a kernel and its plain version."""
    return float((out != ref).float().mean())


def flip_check(tag: str, kernel: str, out, ref, tier: str, one=None) -> float:
    """Prints the flip rate; under fasthi, fast and fast16 holds it to the
    bar of ``tools/chain_check.py`` FLIP_BARS, which a kernel short of
    f32-grade products (fasthi) or one that adds the bias inside the sum's
    rounding (fast, fast16) would cross. ``one``: under fast and fast16 the
    plain version with one rounding (``chain_check.one_rounding``), whose
    flip rate against the kernel must be at least 10x the plain version's.
    Returns the flip rate."""
    from ntire2022_esr_tpu_torch.tools.chain_check import FLIP_BARS

    rate = flip_rate(out, ref)
    if tier not in FLIP_BARS:
        print(f"   {tag} [{tier}]: flip rate {rate:.3e}")
        return rate
    bar = FLIP_BARS[tier][kernel]
    extra = ""
    ok = rate <= bar
    if one is not None:
        rate1 = flip_rate(out, one)
        ok = ok and rate1 >= 10 * rate
        extra = f"; against one rounding {rate1:.3e} (at least 10x)"
    print(f"   {tag} [{tier}]: flip rate {rate:.3e} (bar {bar:.0e}){extra} -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        FLIP_FAILURES.append(f"{tag} [{tier}]")
    return rate


def r2_flip_check(tag: str, out, ref, x, w, b, tier: str, one) -> None:
    """The x2 upsamplers' flip check (phase 3). ``flip_check``'s bar against
    the plain version, as for RLFN's tail. Under fast and fast16 a kernel
    over its bar passes only where the plain version sums the products in
    another order than the kernel: then both are held to the f64 sum of
    the same rounded operands, rounded as the tier rounds
    (``chain_check.exact_two_byte``): the kernel's flip rate against it at
    most 1.5x the plain version's, and the one-rounding control at least 10x
    the kernel's rate against the plain version. At 52 -> 208 cuDNN takes
    another order than at the other widths: its result is the same on the
    input zero-padded to 56 or 64 channels and differs from the kernel's by
    1.6e-3 of the f16 values, while the kernel's and cuDNN's flip rates
    against the f64 sum are 2.03e-3 and 2.09e-3 (PERF.md §6)."""
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.tools.chain_check import FLIP_BARS, exact_two_byte

    rate = flip_rate(out, ref)
    if tier not in TWO_BYTE_TIERS or rate <= FLIP_BARS[tier]["tail"]:
        flip_check(tag, "tail", out, ref, tier, one)
        return
    exact = exact_two_byte(x, w, b, 2, config.numerics().compute_dtype)
    k_ex, p_ex, rate1 = flip_rate(out, exact), flip_rate(ref, exact), flip_rate(out, one)
    ok = k_ex <= 1.5 * p_ex and rate1 >= 10 * rate
    print(f"   {tag} [{tier}]: flip rate {rate:.3e} over the bar {FLIP_BARS[tier]['tail']:.0e}: "
          f"another sum order; against the f64 sum rounded as {tier} rounds: kernel {k_ex:.3e}, "
          f"plain {p_ex:.3e} (at most 1.5x); against one rounding {rate1:.3e} (at least 10x) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        FLIP_FAILURES.append(f"{tag} [{tier}]")


def tail_args(model, shape, dtype, seed):
    import torch
    from ntire2022_esr_tpu_torch import ops

    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32) * 8
    up = model.upsampler[0]
    return ops.from_nhwc(torch.from_numpy(x).cuda()).to(dtype), up.weight, up.bias


def random_tail(shape, cout, r, seed, bias=True, dtype=None):
    """A tail of other widths than RLFN's: input (NHWC ``shape``, f16 or
    ``dtype``) and an f32 weight to ``cout * r * r`` channels (and bias)
    from numpy ``seed``."""
    x, ws, bs = random_chain(shape, [(shape[3], cout * r * r)], seed, dtype)
    return x, ws[0], bs[0] if bias else None


def chain_f64(x, ws, bs, residual=True):
    """The chain in float64 (cuDNN), the yardstick of the f32 paths' error."""
    import torch.nn.functional as F

    h = x.double()
    for w, b in zip(ws, bs):
        h = F.leaky_relu(F.conv2d(h, w.double(), None if b is None else b.double(), padding=1),
                         0.05)
    return h + x.double() if residual else h


def tail_f64(x, w, b, r=4):
    import torch.nn.functional as F

    return F.pixel_shuffle(F.conv2d(x.double(), w.double(), None if b is None else b.double(),
                                    padding=1), r)


def f64_check(tag: str, out, plain, exact) -> float:
    """Under parity and high: the kernel's largest error against the f64
    result at most F64_BAR times that of the plain f32 version (cuDNN f32,
    TF32 off) on the same inputs. Returns the ratio."""
    e_k = float((out.double() - exact).abs().max())
    e_p = float((plain.double() - exact).abs().max())
    ratio = e_k / max(e_p, 1e-300)
    print(f"   {tag}: max|kernel - f64| {e_k:.3e}, max|cuDNN f32 - f64| {e_p:.3e}: "
          f"{ratio:.2f}x (bar {F64_BAR}x) -> {'ok' if ratio <= F64_BAR else 'FAIL'}", flush=True)
    require(ratio <= F64_BAR, f"{tag}: kernel error over {F64_BAR}x cuDNN f32's against f64")
    return ratio


def compare(tag: str, out, ref, tier: str) -> float:
    """Kernel vs plain version on the same inputs; returns max |diff|.

    parity and high (f32): rtol 1e-4, atol 1e-5 of the largest value. The sums run in
    another order; each sums hundreds of products as large as the output's
    largest values, so where they cancel to near zero the difference is
    absolute, a few f32 ulps of that scale (measured 1.2e-6 of it).
    fasthi16 / fasthi: every stage is stored in f16 / bf16, and where the
    two f32 sums differ in their last bits a store rounds the other way (one
    ulp, which the next stage carries on), so at most 8 ulps of the largest
    value anywhere and an eighth of one on average.
    """
    import torch

    require(out.shape == ref.shape and out.dtype == ref.dtype,
            f"{tag}: {tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} {ref.dtype}")
    o, r = out.float(), ref.float()
    require(bool(torch.isfinite(o).all()), f"{tag}: non-finite kernel output")
    d = (o - r).abs()
    top = float(r.abs().max())
    err, mean = float(d.max()), float(d.mean())
    if out.dtype == torch.float32:
        ok = bool((d <= 1e-5 * top + 1e-4 * r.abs()).all())
    else:
        ulp = 2.0 ** -10 if out.dtype == torch.float16 else 2.0 ** -7  # relative, f16 / bf16
        ok = err <= 8 * ulp * top and mean <= ulp / 8 * top
    print(f"   {tag} [{tier}]: max|d| {err:.3e} mean|d| {mean:.3e} max|ref| {top:.3e} "
          f"-> {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"{tag} [{tier}] kernel disagrees with its plain version")
    return err


def plain_forward(model, x, tier: str):
    """``model(x)`` with the kernels' plain versions in place of the
    kernels, under ``tier``; ``model`` is RLFN or a wrapper around it."""
    import torch
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.models import rlfn as rlfn_mod
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail

    with mock.patch.object(rlfn_mod, "fused_conv3x3_chain", conv_chain.conv3x3_chain_plain), \
            mock.patch.object(rlfn_mod, "fused_conv3x3_pixelshuffle",
                              tail.conv3x3_pixelshuffle_plain), \
            config.numerics_mode(tier), torch.inference_mode():
        return model(x)


def level_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    require(a.shape == b.shape, f"shapes {a.shape} vs {b.shape}")
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


def protocol_phase(model, dr: float, smi: str) -> None:
    """Phase 7: the challenge protocol through the port's harness (see the
    module docstring). ``model`` is phase 1's RLFN on the card."""
    import torch
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import cli, data, ensemble, graphs, runner, tiling
    from ntire2022_esr_tpu_torch.utils import image as img_util
    from ntire2022_esr_tpu_torch.utils import metrics

    work = os.path.join(HERE, "build", "protocol_smoke")
    shutil.rmtree(work, ignore_errors=True)
    data_dir = os.path.join(work, "div2k")
    tw = time.perf_counter()
    pairs = data.write_synthetic_div2k(data_dir, PROTOCOL_VALID, PROTOCOL_TEST, seed=0)
    valid, test = pairs[:len(PROTOCOL_VALID)], pairs[len(PROTOCOL_VALID):]
    modes = ["valid"] * len(valid) + ["test"] * len(test)
    lr_of = {hr: img_util.imread_uint(lr) for lr, hr in pairs}
    hr_of = {hr: img_util.imread_uint(hr) for _, hr in pairs}
    widths = sorted({w % 4 for _, w in PROTOCOL_VALID + PROTOCOL_TEST})
    print(f"   wrote and read back {len(pairs)} synthetic pairs in {time.perf_counter() - tw:.1f} s; "
          f"LR W mod 4 in {widths}")
    require(widths == [0, 1, 2, 3], "the LR widths do not cover W mod 4 = 0..3")
    logger = logging.getLogger("NTIRE2022-EfficientSR")

    graphs0 = [0, 0]

    def reset():
        reset_counts()
        graphs0[:] = [graphs.captures, graphs.replays]

    def check_launches(tag: str, forwards: int, tier: str) -> None:
        got = total_counts()
        path = path_of(tier)
        print(f"   {tag}: {got[0]} chain and {got[1]} tail launches over {forwards} forwards "
              f"({path} path)")
        require(got == (4 * forwards, forwards) and path_counts(path) == got,
                f"{tag}: not 4 chain launches and 1 tail launch per forward on the {path} path")

    def check_graphs(tag: str, replays: int, tier: str) -> None:
        """A graph-timed run: the kernels launch in each warm-up and capture
        (the counters move at capture, not at replay), once a shape."""
        captures = graphs.captures - graphs0[0]
        got = graphs.replays - graphs0[1]
        print(f"   {tag}: {captures} graphs captured, {got} replays")
        require(got == replays, f"{tag}: {got} replays, not {replays}")
        check_launches(f"{tag} (warm-up and capture of each graph)", 2 * captures, tier)

    def saved(save_dir: str, mode: str, hr: str) -> np.ndarray:
        return img_util.imread_uint(os.path.join(save_dir, "04_RLFN", mode, os.path.basename(hr)))

    def to_u8(y) -> np.ndarray:
        return img_util.nhwc2uint(y.cpu().numpy(), dr)

    def lr_tensor(hr: str):
        return torch.from_numpy(img_util.uint2nhwc(lr_of[hr], dr)).cuda()

    # the CLI under parity ------------------------------------------------
    save = os.path.join(work, "sr_parity")
    reset()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        tc = time.perf_counter()
        cli.main(["--data_dir", data_dir, "--save_dir", save, "--model_id", "4", "--ssim",
                  "--include_test", "--mode", "parity"])
        cli_s = time.perf_counter() - tc
    finally:
        os.chdir(cwd)
    check_graphs("harness.cli parity run", len(pairs), "parity")
    with open(os.path.join(work, "results.json")) as fh:
        res = json.load(fh)
    require(list(res) == ["04_RLFN"], f"results.json holds {list(res)}, not 04_RLFN")
    e = res["04_RLFN"]
    require(sorted(e) == PROTOCOL_KEYS, f"results.json keys {sorted(e)} are not the JAX CLI's")
    require(os.path.exists(os.path.join(work, "results.txt")), "no results.txt")
    for (_, hr), mode, ms in zip(pairs, modes, e["valid_runtime"] + e["test_runtime"]):
        h, w = lr_of[hr].shape[:2]
        print(f"   {mode} {os.path.basename(hr)}: LR {h}x{w} (W mod 4 = {w % 4}) {ms:.3f} ms")
    print(f"   valid: ave runtime {e['valid_ave_runtime']:.3f} ms, memory {e['valid_memory']:.1f} MB, "
          f"PSNR {e['valid_ave_psnr']:.4f} dB, SSIM {e['valid_ave_ssim']:.4f}; test: ave runtime "
          f"{e['test_ave_runtime']:.3f} ms, memory {e['test_memory']:.1f} MB "
          f"(parity, CUDA events around the forward, on {smi}); CLI run {cli_s:.1f} s")
    comp = {k: e[k] for k in RLFN_COMPLEXITY}
    print(f"   complexity at 256x256: {comp}")
    require(comp == RLFN_COMPLEXITY, "the complexity report differs from the JAX package's")
    require(e["valid_memory"] > 0 and e["test_memory"] > 0, "no peak device memory")

    # runner.run under fasthi16 ------------------------------------------
    save16 = os.path.join(work, "sr_fasthi16")
    reset()
    r16: dict = {}
    with config.numerics_mode("fasthi16"):
        for mode, sel in (("valid", valid), ("test", test)):
            r16.update(runner.run(model, "04_RLFN", dr, None, logger,
                                  types.SimpleNamespace(save_dir=save16, ssim=False),
                                  mode=mode, pairs=sel))
    check_graphs("runner.run fasthi16", len(pairs), "fasthi16")
    print(f"   fasthi16: valid ave runtime {r16['valid_ave_runtime']:.3f} ms, memory "
          f"{r16['valid_memory']:.1f} MB; per image "
          f"{[round(t, 3) for t in r16['valid_runtime'] + r16['test_runtime']]} ms")

    # one graph alive at a time: six shapes peak as high as the largest alone
    big = max(valid, key=lambda p: lr_of[p[1]].shape[0] * lr_of[p[1]].shape[1])
    with config.numerics_mode("fasthi16"):
        r_big = runner.run(model, "04_RLFN", dr, None, logger,
                           types.SimpleNamespace(save_dir=os.path.join(work, "sr_big"), ssim=False),
                           mode="valid", pairs=[big])
    print(f"   graph-timed peak memory, fasthi16: {r16['valid_memory']:.1f} MB over "
          f"{len(valid)} shapes, {r_big['valid_memory']:.1f} MB for the largest "
          f"({'x'.join(map(str, lr_of[big[1]].shape[:2]))}) alone")
    require(r16["valid_memory"] <= 1.02 * r_big["valid_memory"],
            "graph-timed peak memory grows with the number of shapes")

    # eager against graph at batch 1, with the device-busy share ---------
    from ntire2022_esr_tpu_torch.tools import forward_trace

    x = lr_tensor(valid[0][1])
    for tier in ("parity", "fasthi16"):
        for mode in ("eager", "graph"):
            rec = forward_trace.measure(model, x, tier, mode, 5,
                                        os.path.join(work, f"trace_{tier}_{mode}"))
            print(f"   {forward_trace.describe('04_RLFN', rec)}; on {smi}")
            require(0.0 < rec["busy_share"] <= 1.0 + 1e-6, f"busy share {rec['busy_share']}")

    # each image's PSNR against the plain forward on the card ------------
    for tier, save_dir, r in (("parity", save, e), ("fasthi16", save16, r16)):
        deltas, shares = [], []
        for (_, hr), mode, p in zip(pairs, modes, r["valid_psnr"] + r["test_psnr"]):
            ref = to_u8(plain_forward(model, lr_tensor(hr), tier))
            d = level_diff(saved(save_dir, mode, hr), ref)
            p_plain = metrics.calculate_psnr(ref, hr_of[hr], border=4)
            deltas.append(p - p_plain)
            shares.append((float((d > 0).mean()), float((d > 1).mean())))
            print(f"   [{tier}] {mode} {os.path.basename(hr)}: PSNR {p:.4f} dB, plain {p_plain:.4f} dB, "
                  f"delta {p - p_plain:+.6f} dB; max {int(d.max())} levels, "
                  f"{shares[-1][0]:.2e} of values 1+ apart, {shares[-1][1]:.2e} 2+ apart")
            require(abs(p - p_plain) <= PSNR_BAR_DB, f"[{tier}] {hr}: PSNR off the plain forward's")
            # d is over the whole saved image, so the LR edge rows and
            # columns that the PSNR's border shaves off are held too
            if tier == "parity":
                require(int(d.max()) <= 1, f"[parity] {hr}: more than 1 level from the plain forward")
            else:  # phase 5's bar for fasthi16's one-ulp flips
                require(shares[-1][1] < 1e-4 and shares[-1][0] < 0.2,
                        f"[fasthi16] {hr}: too many values off the plain forward")
        print(f"   [{tier}] PSNR delta against the plain forward: max |d| "
              f"{max(abs(v) for v in deltas):.6f} dB over {len(deltas)} images; values 1+ apart "
              f"{np.mean([a for a, _ in shares]):.2e}, 2+ apart {np.mean([b for _, b in shares]):.2e}")

    # x8 ensemble and tiled_apply on one image, parity ---------------------
    hr0 = valid[0][1]
    x = lr_tensor(hr0)
    h, w = lr_of[hr0].shape[:2]
    ens = ensemble.self_ensemble_x8(model)
    reset()
    with config.numerics_mode("parity"), torch.inference_mode():
        out = to_u8(ens(x))
    check_launches("x8 ensemble", 8, "parity")
    d = level_diff(out, to_u8(plain_forward(ens, x, "parity")))
    print(f"   x8 on LR {h}x{w}: max {int(d.max())} levels from the plain path; PSNR "
          f"{metrics.calculate_psnr(out, hr_of[hr0], border=4):.4f} dB")
    require(int(d.max()) <= 1, "x8: more than 1 level from the plain path")

    def tiled(v):
        return tiling.tiled_apply(model, v, 128, 32, max_tiles_per_call=16)

    n_tiles = len(tiling._tile_starts(h, 128, 96)) * len(tiling._tile_starts(w, 128, 96))
    reset()
    with config.numerics_mode("parity"), torch.inference_mode():
        out = to_u8(tiled(x))
    check_launches(f"tiled_apply ({n_tiles} tiles of 128, 16 a call)", math.ceil(n_tiles / 16),
                   "parity")
    d = level_diff(out, to_u8(plain_forward(tiled, x, "parity")))
    print(f"   tiled on LR {h}x{w}: max {int(d.max())} levels from the plain path; PSNR "
          f"{metrics.calculate_psnr(out, hr_of[hr0], border=4):.4f} dB")
    require(int(d.max()) <= 1, "tiled_apply: more than 1 level from the plain path")

    # run_batched(u8_io=True) under fasthi16, held to runner.run ---------
    dup = [p for p in valid for _ in range(4)]
    saveb = os.path.join(work, "sr_batched")
    reset()
    with config.numerics_mode("fasthi16"):
        rb = runner.run_batched(model, "04_RLFN", dr, logger,
                                types.SimpleNamespace(save_dir=saveb, ssim=False),
                                mode="valid", pairs=dup, u8_io=True)
    check_graphs("run_batched u8_io fasthi16", len(set(PROTOCOL_VALID)), "fasthi16")
    for k, (_, hr) in enumerate(valid):
        d = level_diff(saved(saveb, "valid", hr), saved(save16, "valid", hr))
        pb, p1 = rb["valid_psnr"][4 * k], r16["valid_psnr"][k]
        print(f"   batched {os.path.basename(hr)}: {rb['valid_runtime'][4 * k]:.3f} ms an image "
              f"(batch 4), PSNR {pb:.4f} dB vs run {p1:.4f} dB; max {int(d.max())} levels, "
              f"{float((d > 0).mean()):.2e} of values 1+ apart")
        require(int(d.max()) <= 1 and abs(pb - p1) <= PSNR_BAR_DB,
                f"run_batched {hr}: off runner.run's output")
    print(f"   batched: memory {rb['valid_memory']:.1f} MB")

    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    shutil.rmtree(work)


def zoo_phase(smi: str):
    """Phase 8: the 41 zoo models besides RLFN (see the module docstring).
    Returns a record per model and the tail's launches on the HR tails'
    x2 upsamplers in their served forwards, by (cin, conv channels)."""
    import torch
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import (data, graphs, profiling, registry, runner, serving,
                                                 tiling)
    from ntire2022_esr_tpu_torch.ops import fused
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail
    from ntire2022_esr_tpu_torch.utils import image as img_util
    from ntire2022_esr_tpu_torch.utils import metrics

    work = os.path.join(HERE, "build", "zoo_smoke")
    shutil.rmtree(work, ignore_errors=True)
    (lr_path, hr_path), = data.write_synthetic_div2k(os.path.join(work, "div2k"),
                                                     [PROTOCOL_VALID[0]], seed=1)
    lr = img_util.imread_uint(lr_path)
    hr = img_util.modcrop(img_util.imread_uint(hr_path), 4)
    logger = logging.getLogger("chip_smoke_zoo")
    logger.propagate = False
    logger.addHandler(logging.NullHandler())
    dev = torch.device("cuda")
    records = []
    r2_launches: dict = {}
    for mid in ZOO_IDS:
        model, name, dr, tile = registry.build_model(mid, device=dev)
        per_call = registry.get_spec(mid).max_tiles_per_call
        tier = serving.gated_tier(name)
        require(tier in config.modes(), f"{name}: gated tier {tier!r} is not a tier of the port")
        err = 0.0
        for stem in NLFFC_GOLDENS if mid == 2 else (f"model_{mid:02d}",):
            g = np.load(os.path.join(HERE, "tests", "goldens", f"{stem}.npz"))
            x = torch.from_numpy(g["input_u8"].astype(np.float32) / (255.0 / float(g["data_range"])))
            with config.numerics_mode("parity"), torch.inference_mode():
                out = model(x[None].to(dev)).cpu().numpy()[0]
            e = float(np.abs(out - g["output"]).max())
            require(out.shape == g["output"].shape and e < 2e-4 * dr,
                    f"{name}: golden {stem} max|d| {e:.3e} over 2e-4 * {dr}")
            err = max(err, e)
        xl = torch.from_numpy(img_util.uint2nhwc(lr, dr)).to(dev)

        def forward(v):
            return tiling.forward(model, v, tile, max_tiles_per_call=per_call)

        hr_tail = mid in HR_TAILS
        with config.numerics_mode(tier):
            if hr_tail:
                # the warm-up packs the tail's weights; nothing packs after it
                with torch.inference_mode():
                    model(xl)
                packs0 = conv_chain.packs
            reset_counts()
            graphs0 = graphs.captures
            res = runner.run(model, name, dr, tile, logger,
                             types.SimpleNamespace(save_dir=os.path.join(work, "sr"), ssim=False),
                             mode="valid", pairs=[(lr_path, hr_path)], max_tiles_per_call=per_call)
            if hr_tail:
                # each captured forward launches in its warm-up and its capture
                forwards = 2 * (graphs.captures - graphs0)
                path = path_of("fast")
                by_path = {k: v for k, v in tail.launches_by_path.items() if v}
                print(f"   {name}: tail launches {by_path} and {total_counts()[0]} chain "
                      f"launches over {forwards} captured forwards; by shape "
                      f"{dict(tail.launches_by_shape)}")
                require(by_path == {path: len(HR_TAILS[mid]) * forwards}
                        and total_counts()[0] == 0,
                        f"{name}: not {len(HR_TAILS[mid])} {path} tail launches a captured forward")
                for cin, nch in set(HR_TAILS[mid]):
                    got = tail.launches_by_shape.get((path, cin, nch, 2), 0)
                    require(got == HR_TAILS[mid].count((cin, nch)) * forwards,
                            f"{name}: {got} launches at {cin} -> {nch}")
                    r2_launches[(cin, nch)] = r2_launches.get((cin, nch), 0) + got
            else:
                require(graphs.captures > graphs0 and total_counts() == (0, 0),
                        f"{name}: {total_counts()} (chain, tail) kernel launches in "
                        f"{graphs.captures - graphs0} captured forwards, where none is due")
            timer = profiling.Timer(dev)
            with torch.inference_mode():
                forward(xl)
                timer.start()
                y = forward(xl)
                eager_ms = timer.stop()
            sr = img_util.nhwc2uint(y.float().cpu().numpy(), dr)
        p_graph, p_eager = res["valid_psnr"][0], metrics.calculate_psnr(sr, hr, border=4)
        rec = {"model": name, "tier": tier, "golden_max_abs_err": err,
               "graph_ms": res["valid_runtime"][0], "eager_ms": eager_ms,
               "peak_mb": res["valid_memory"], "psnr": p_graph, "psnr_eager": p_eager}
        if mid == 2:
            rec.update(nlffc_readings(forward, xl, sr, dr, tier, smi))
        if hr_tail:
            require(conv_chain.packs == packs0, f"{name}: weights packed after the warm-up")
            # the same forward on the kernels' plain versions
            with mock.patch.object(fused, "fused_conv3x3_pixelshuffle",
                                   tail.conv3x3_pixelshuffle_plain), \
                    config.numerics_mode(tier), torch.inference_mode():
                yp = img_util.nhwc2uint(model(xl).float().cpu().numpy(), dr)
            rec["psnr_plain"] = metrics.calculate_psnr(yp, hr, border=4)
            d = level_diff(sr, yp)
            print(f"   {name}: PSNR graph {p_graph:.4f} dB, plain versions "
                  f"{rec['psnr_plain']:.4f} dB (delta {p_graph - rec['psnr_plain']:+.6f}); eager "
                  f"against plain: max {int(d.max())} levels, "
                  f"{float((d > 0).mean()):.2e} 1+ apart; "
                  f"no pack after the warm-up ({packs0} packs)")
            require(abs(p_graph - rec["psnr_plain"]) <= PSNR_BAR_DB,
                    f"{name}: served PSNR off the plain-version forward's")
        records.append(rec)
        print(f"   {name}: tier {tier} (gated); "
              f"golden max|d| {err:.2e} (bar {2e-4 * dr:.1e}); LR {lr.shape[0]}x{lr.shape[1]} "
              f"graph {rec['graph_ms']:.3f} ms, eager {eager_ms:.3f} ms, peak "
              f"{rec['peak_mb']:.1f} MB; PSNR {p_graph:.4f} dB, eager {p_eager:.4f} dB"
              + (f"; DFT share {rec['dft_share']:.1%} of the eager forward, "
                 f"{rec['softmax_maps_inf']} of {rec['softmax_maps']} softmax maps overflow, "
                 f"PSNR against parity {rec['psnr_vs_parity']:.3f} dB" if mid == 2 else ""),
              flush=True)
        require(abs(p_graph - p_eager) <= PSNR_BAR_DB, f"{name}: graph PSNR off the eager forward's")
        del model, y
    shutil.rmtree(work)
    return records, r2_launches


def nlffc_readings(forward, xl, sr_fast16, dr: float, tier: str, smi: str) -> dict:
    """NLFFC's extra readings in phase 8 on the LR image ``xl``: the DFT
    products' share of an eager tiled forward's device time (the profiler
    span ``spectral.dft``, ``tools/forward_trace.py``), how many of its
    global-context softmax maps overflow under ``tier`` (their f32 sum
    rounds to inf in f16, so the map is 0), the PSNR of the ``tier`` image
    ``sr_fast16`` against parity's forward of the same image, and the DFT
    products beside cuFFT (``torch.fft.rfft``/``irfft``) on one 2-tile
    chunk's global half."""
    import torch
    from ntire2022_esr_tpu_torch import config, ops
    from ntire2022_esr_tpu_torch.harness import profiling
    from ntire2022_esr_tpu_torch.ops import spectral
    from ntire2022_esr_tpu_torch.tools import forward_trace
    from ntire2022_esr_tpu_torch.utils import image as img_util
    from ntire2022_esr_tpu_torch.utils import metrics

    rec = forward_trace.measure(forward, xl, tier, "eager", 2,
                                os.path.join(HERE, "build", "zoo_smoke", "trace_nlffc"))
    dft_ms = rec["spans"].get(spectral.SPAN, 0.0)
    require(dft_ms > 0, "no device time in the spectral.dft span")
    print(f"   02_NLFFC: {forward_trace.describe('02_NLFFC', rec)}; on {smi}")

    softmax, maps = ops.softmax, {"all": 0, "inf": 0}

    def counting(x, dim):
        # the sum as ops.softmax takes it: exp in the map's dtype, summed in f32
        s = torch.exp(x - x.amax(dim, keepdim=True)).sum(dim, dtype=torch.float32)
        maps["all"] += s.numel()
        if x.dtype == torch.float16:
            maps["inf"] += int((s >= F16_INF).sum())
        return softmax(x, dim)

    with mock.patch.object(ops, "softmax", counting), config.numerics_mode(tier), \
            torch.inference_mode():
        forward(xl)
    with config.numerics_mode("parity"), torch.inference_mode():
        sr_parity = img_util.nhwc2uint(forward(xl).float().cpu().numpy(), dr)
    psnr_vs_parity = metrics.calculate_psnr(sr_fast16, sr_parity, border=4)
    print(f"   02_NLFFC [{tier}]: {maps['inf']} of {maps['all']} global-context softmax maps "
          f"overflow in f16 (their sum >= {F16_INF:g}; the map is 0); {tier} image against "
          f"parity's forward: PSNR {psnr_vs_parity:.3f} dB, "
          f"max {int(level_diff(sr_fast16, sr_parity).max())} levels")

    gen = torch.Generator(device=xl.device).manual_seed(2)
    x = torch.randn(NLFFC_DFT_SHAPE, generator=gen, device=xl.device)
    h = NLFFC_DFT_SHAPE[1]

    def ms(fn, *args):
        return profiling.device_timer(fn, *args, iters=5, warmup=2)[0] * 1e3

    with torch.inference_mode():
        re, im = spectral.rfft_h(x)
        ref = torch.fft.rfft(x, dim=1, norm="ortho")
        err = max(float((re - ref.real).abs().max()), float((im - ref.imag).abs().max()))
        require(err <= 1e-4 * float(ref.abs().max()), f"rfft_h off cuFFT's rfft by {err:.3e}")
        times = {"rfft_h": ms(spectral.rfft_h, x),
                 "cufft_rfft": ms(lambda v: torch.fft.rfft(v, dim=1, norm="ortho"), x)}
        z = torch.complex(re.contiguous(), im.contiguous())
        for tier_i in ("parity", "fast16"):
            with config.numerics_mode(tier_i):
                times[f"irfft_h[{tier_i}]"] = ms(lambda a, b: spectral.irfft_h(a, b, h), re, im)
        times["cufft_irfft"] = ms(lambda v: torch.fft.irfft(v, n=h, dim=1, norm="ortho"), z)
    print(f"   DFT products against cuFFT at NHWC {NLFFC_DFT_SHAPE} f32 (TF32 off; CUDA events, "
          f"median of 5): " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f"; rfft_h max|d| against cuFFT {err:.2e}; on {smi}")
    return {"dft_ms": dft_ms, "dft_share": dft_ms / rec["ms_median"],
            "eager_traced_ms": rec["ms_median"], "softmax_maps": maps["all"],
            "softmax_maps_inf": maps["inf"], "psnr_vs_parity": psnr_vs_parity,
            "dft_vs_cufft_ms": times}


def serve_phase(smi: str) -> list:
    """Phase 9: ``harness.serve.main`` in-process (see the module
    docstring). Returns each run's JSON summary."""
    import contextlib
    import io
    import torch
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import (envelope, graphs, profiling, registry, serve,
                                                 serving, stagesplit, tiling)
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail
    from ntire2022_esr_tpu_torch.utils import image as img_util

    work = os.path.join(HERE, "build", "serve_smoke")
    shutil.rmtree(work, ignore_errors=True)
    dev = torch.device("cuda")
    summaries = []

    def run(argv, save=None) -> list:
        """``serve.main(argv)``; its output printed, its summary kept."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv + (["--save_dir", save] if save else []))
        lines = buf.getvalue().strip().splitlines()
        require(rc == 0 and lines, f"serve {argv}: exit code {rc}")
        for line in lines:
            print(f"   {line}")
        if argv != ["--list"]:
            summaries.append(json.loads(lines[-1]))
        return lines

    def synthetic(argv):
        """The frames ``serve --synthetic N --hw H W`` makes (numpy seed 0)."""
        n, h, w = (int(argv[argv.index(k) + o]) for k, o in
                   (("--synthetic", 1), ("--hw", 1), ("--hw", 2)))
        rng = np.random.RandomState(0)
        return [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]

    def saved(save, n):
        return [img_util.imread_uint(os.path.join(save, f"frame_{i:04d}_sr.png")) for i in range(n)]

    table = "\n".join(run(["--list"]))
    names = [spec.name for spec in registry._REGISTRY.values()]
    require(all(f"| {n} |" in table for n in names) and "TPU ms/img" in table,
            "serve --list lacks a model of the registry")

    # a chain plan: RLFN through both kernels
    plan = envelope.plan_for(4)
    frames = synthetic(SERVE_CHAIN)
    save = os.path.join(work, "sr_04")
    reset_counts()
    run(SERVE_CHAIN, save)
    forwards = 1 + math.ceil(len(frames) / plan.batch)  # the warm-up batch, then the stream's
    got = total_counts()
    print(f"   serve 04_RLFN [{plan.tier}]: {got[0]} chain, {got[1]} tail launches over "
          f"{forwards} forwards (warm-up and {len(frames)} frames at batch {plan.batch})")
    require(got == (4 * forwards, forwards) and path_counts(path_of(plan.tier)) == got,
            "serve --model_id 4: not 4 chain and 1 tail launch a forward")
    srv = serving.SRServer(model_id=4, max_batch=plan.batch, device=dev)
    require(srv.tier == plan.tier, f"SRServer(4) tier {srv.tier} is not the plan's {plan.tier}")
    d = level_diff(np.stack(saved(save, len(frames))), np.stack(list(srv.process_stream(frames))))
    print(f"   serve 04_RLFN against SRServer(4) on the same frames: max {int(d.max())} levels")
    require(int(d.max()) == 0, "serve --model_id 4 differs from SRServer(4)")
    del srv

    # a split plan: NASNetBN's body at the batch, its tail over chunks
    plan = envelope.plan_for(28)
    frames = synthetic(SERVE_SPLIT)
    save = os.path.join(work, "sr_28")
    warm: dict = {}
    warmup = serving.SRServer.warmup

    def warmup_then_read(self, *args, **kwargs):
        warmup(self, *args, **kwargs)
        torch.cuda.synchronize()
        warm.update(packs=conv_chain.packs, launches=total_counts())

    reset_counts()
    with mock.patch.object(serving.SRServer, "warmup", warmup_then_read):
        run(SERVE_SPLIT, save)
    batch = min(plan.batch, len(frames))
    chunks = 2 * math.ceil(batch / plan.chunk)  # the warm-up batch's and the stream's
    path = path_of("fast")
    got = total_counts()
    print(f"   serve 28_NASNetBN [{plan.tier}, split/{plan.chunk}]: {got[1]} tail launches "
          f"({dict((k, v) for k, v in tail.launches_by_path.items() if v)}) over {chunks} tail "
          f"chunks, {got[1] / chunks:g} a chunk; {warm['launches'][1]} in the warm-up; "
          f"{conv_chain.packs - warm['packs']} weight packs after it")
    require(got == (0, SPLIT_TAIL_LAUNCHES * chunks)
            and tail.launches_by_path[path] == SPLIT_TAIL_LAUNCHES * chunks,
            f"serve --model_id 28: not {SPLIT_TAIL_LAUNCHES} {path} tail launches a chunk")
    require(conv_chain.packs == warm["packs"], "serve --model_id 28 packed weights after the warm-up")
    whole = serving.SRServer(model_id=28, max_batch=batch, device=dev, tier=plan.tier)
    d = level_diff(np.stack(saved(save, len(frames))), np.stack(list(whole.process_stream(frames))))
    print(f"   serve 28_NASNetBN split against the unsplit server (batch {batch}): max "
          f"{int(d.max())} levels, {float((d > 0).mean()):.2e} of values 1+ apart")
    require(int(d.max()) <= 1 and float((d > 0).mean()) < 1e-3,
            "serve --model_id 28 (split) too far from the unsplit server")
    # the shipped schedule against the whole forward at its body batch,
    # each a chain of forwards fenced once (host clock)
    body_batch, chunk = stagesplit.SHIPPED[28]
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((body_batch,) + SPLIT_TIMING_HW + (3,), generator=g, device=dev) * whole._dr
    with config.numerics_mode(plan.tier):
        split_s = stagesplit.split_chain_timer(*stagesplit.get_split(28), whole._model, x, chunk,
                                               reps=SPLIT_TIMING_REPS)
        whole_s = profiling.chain_timer(whole._model, x, reps=SPLIT_TIMING_REPS)
    split_ms, whole_ms = (1e3 * t / (SPLIT_TIMING_REPS * body_batch) for t in (split_s, whole_s))
    print(f"   28_NASNetBN [{plan.tier}] at LR {SPLIT_TIMING_HW[0]}x{SPLIT_TIMING_HW[1]}, batch "
          f"{body_batch}: split {body_batch}/{chunk} {split_ms:.4f} ms an image, whole forward "
          f"{whole_ms:.4f} (chain of {SPLIT_TIMING_REPS}, host clock, median of 3; {smi})")
    require(all(math.isfinite(t) and t > 0 for t in (split_ms, whole_ms)),
            "the split or whole chain timing failed")
    del whole, x

    # the tiled plan: NLFFC through ChunkedTiler, one chunk graph for every shape
    plan = envelope.plan_for(2)
    model, _, dr, tile = registry.build_model(2, device=dev)
    per_call = registry.get_spec(2).max_tiles_per_call

    def tiled_reference(frame):
        with config.numerics_mode(plan.tier), torch.inference_mode():
            x = torch.from_numpy(img_util.uint2nhwc(frame, dr)).to(dev)
            y = tiling.tiled_apply(model, x, tile, max_tiles_per_call=per_call)
        return img_util.nhwc2uint(y.float().cpu().numpy(), dr)

    frames = synthetic(SERVE_TILED)
    second = np.random.RandomState(1).randint(0, 256, TILED_SECOND + (3,), dtype=np.uint8)
    frames_dir = os.path.join(work, "frames_02")
    os.makedirs(frames_dir)
    img_util.imsave(frames[0], os.path.join(frames_dir, "a.png"))
    img_util.imsave(second, os.path.join(frames_dir, "b.png"))
    checks = []
    for argv, save, outs in (
            (SERVE_TILED, os.path.join(work, "sr_02"), None),
            (["--model_id", "2", "--images", frames_dir], os.path.join(work, "sr_02_shapes"),
             ("a_sr.png", "b_sr.png"))):
        captures0 = graphs.captures
        reset_counts()
        run(argv, save)
        n_graphs = graphs.captures - captures0
        shapes = sorted({f.shape[:2] for f in (frames if outs is None else [frames[0], second])})
        print(f"   serve 02_NLFFC [{plan.tier}] LR shapes {shapes}: {n_graphs} graph captured, "
              f"{total_counts()} (chain, tail) launches")
        require(n_graphs == 1, f"serve --model_id 2: {n_graphs} graphs over {shapes}")
        require(total_counts() == (0, 0), "serve --model_id 2 launched a kernel")
        if outs is None:
            checks += list(zip(frames, saved(save, len(frames))))
        else:
            checks += [(f, img_util.imread_uint(os.path.join(save, o)))
                       for f, o in zip((frames[0], second), outs)]
    for frame, got in checks:
        d = level_diff(got, tiled_reference(frame))
        print(f"   serve 02_NLFFC LR {frame.shape[0]}x{frame.shape[1]} against tiled_apply: "
              f"max {int(d.max())} levels, {float((d > 0).mean()):.2e} of values 1+ apart")
        require(int(d.max()) <= 1, "serve --model_id 2 more than 1 level off tiled_apply")
    shutil.rmtree(work)
    return summaries


def mesh_phase(smi: str) -> dict:
    """Phase 10: the multi-device paths on meshes that list the one card
    several times (see the module docstring). Returns the kernels' launches
    by kernels-line name."""
    import torch
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import (cli, data, graphs, profiling, registry, runner,
                                                 serving)
    from ntire2022_esr_tpu_torch.ops.kernels import tail
    from ntire2022_esr_tpu_torch.parallel import (PipelinedSR, data_space_mesh, make_mesh,
                                                  make_spatial_apply, sharded_batch_apply)
    from ntire2022_esr_tpu_torch.utils import image as img_util
    from ntire2022_esr_tpu_torch.utils import metrics

    work = os.path.join(HERE, "build", "mesh_smoke")
    shutil.rmtree(work, ignore_errors=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    launches = {"conv3x3_chain": 0, "conv3x3_pixelshuffle": 0,
                "conv3x3_pixelshuffle_bf16x1_r2_32to128": 0}

    def count_f16(tag: str, forwards: int, tier: str = "fasthi16") -> None:
        """RLFN's 4 chain and 1 tail launches a device forward, all on the
        tier's path (the f16 path under fasthi16)."""
        got = total_counts()
        print(f"   {tag}: {got[0]} chain, {got[1]} tail launches over {forwards} device forwards "
              f"({path_of(tier)} path)")
        require(got == (4 * forwards, forwards) and path_counts(path_of(tier)) == got,
                f"{tag}: not 4 chain and 1 tail {path_of(tier)} launches a device forward")
        for kname, n in (("conv3x3_chain", got[0]), ("conv3x3_pixelshuffle", got[1])):
            launches[entry_of(kname, tier)] = launches.get(entry_of(kname, tier), 0) + n

    def count_r2(tag: str, forwards: int) -> None:
        """NASNetBN's 2 bf16x1 tail launches at 32 -> 128 a device forward."""
        by_path = {k: v for k, v in tail.launches_by_path.items() if v}
        got = tail.launches_by_shape.get(("bf16x1", 32, 128, 2), 0)
        print(f"   {tag}: tail launches {by_path} over {forwards} device forwards")
        require(by_path == {"bf16x1": 2 * forwards} and got == 2 * forwards
                and total_counts()[0] == 0,
                f"{tag}: not 2 bf16x1 tail launches at 32 -> 128 a device forward")
        launches["conv3x3_pixelshuffle_bf16x1_r2_32to128"] += got

    def u8(y) -> np.ndarray:
        return torch.round(y.float().clamp(0, 1) * 255.0).to(torch.uint8).cpu().numpy()

    # (a) the CLI, --batched with and without --mesh 1 ----------------------
    data_dir = os.path.join(work, "div2k")
    tw = time.perf_counter()
    data.write_synthetic_div2k(data_dir, PROTOCOL_VALID, seed=0)
    print(f"   wrote phase 7's {len(PROTOCOL_VALID)} valid pairs in {time.perf_counter() - tw:.1f} s")
    cwd = os.getcwd()

    def cli_run(tag: str, tier: str, extra: list, patched: bool) -> dict:
        """``cli.main`` for RLFN with ``--batched`` and ``extra``; its
        results.json entry. ``patched``: the tier is set around the CLI and
        kept through its own ``set_mode`` (the CLI's ``--mode`` offers
        JAX's four tiers, and fasthi16 is not one); else ``--mode tier``."""
        run_dir = os.path.join(work, f"{tier}_{tag.replace(' ', '_').strip('-')}")
        os.makedirs(run_dir)
        argv = ["--data_dir", data_dir, "--save_dir", os.path.join(run_dir, "sr"),
                "--model_id", "4", "--batched"] + ([] if patched else ["--mode", tier]) + extra
        reset_counts()
        captures0 = graphs.captures
        tc = time.perf_counter()
        os.chdir(run_dir)
        try:
            if patched:
                with config.numerics_mode(tier), \
                        mock.patch.object(config, "set_mode", lambda mode: None):
                    cli.main(argv)
            else:
                cli.main(argv)
        finally:
            os.chdir(cwd)
        with open(os.path.join(run_dir, "results.json")) as fh:
            res = json.load(fh)
        require("04_RLFN" in res, f"CLI {tag} [{tier}]: no 04_RLFN entry in results.json "
                                  f"({list(res)})")
        e = res["04_RLFN"]
        captures = graphs.captures - captures0
        # each captured graph launches in its warm-up and its capture
        count_f16(f"CLI --batched {tag} [{tier}] ({captures} graphs)", 2 * captures, tier)
        print(f"   CLI --batched {tag} [{tier}{', set_mode patched' if patched else ''}]: valid "
              f"ave runtime {e['valid_ave_runtime']:.3f} ms an image, per image "
              f"{[round(t, 3) for t in e['valid_runtime']]} ms, memory {e['valid_memory']:.1f} "
              f"MB, PSNR {e['valid_ave_psnr']:.4f} dB (CUDA events; with a mesh from a common "
              f"synchronised start; CLI run {time.perf_counter() - tc:.1f} s)")
        return e

    # the CLI as users run it, at its own parity tier; then, as an extra
    # check, at RLFN's served fasthi16 through a patched set_mode
    for tier, patched in (("parity", False), ("fasthi16", True)):
        a = cli_run("no mesh", tier, [], patched)
        b = cli_run("--mesh 1", tier, ["--mesh", "1"], patched)
        dp = max(abs(p - q) for p, q in zip(a["valid_psnr"], b["valid_psnr"]))
        print(f"   --mesh 1 against no mesh [{tier}]: max |PSNR delta| {dp:.6f} dB over "
              f"{len(a['valid_psnr'])} images; ave runtime "
              f"{b['valid_ave_runtime'] / a['valid_ave_runtime']:.4f}x; on {smi}")
        require(len(a["valid_psnr"]) == len(b["valid_psnr"]) == len(PROTOCOL_VALID)
                and dp <= PSNR_BAR_DB, f"CLI --mesh 1 [{tier}]: PSNR off the run without a mesh")

    # (b) RLFN data-parallel over [cuda:0, cuda:0] ---------------------------
    mesh2 = make_mesh(devices=[dev] * 2)
    frames = list(np.random.RandomState(0).randint(0, 256, (MESH_SERVE_FRAMES, SIZE, SIZE, 3),
                                                    dtype=np.uint8))
    srv = serving.SRServer(model_id=4, max_batch=SERVE_BATCH, device=dev)
    dr = srv._dr
    srv.warmup((SIZE, SIZE))
    torch.cuda.synchronize()
    ts = time.perf_counter()
    ref = np.stack(list(srv.process_stream(frames)))
    ref_s = time.perf_counter() - ts
    sharded = sharded_batch_apply(srv._model, mesh2,
                                  fn=lambda m, v: serving.u8_forward(m, v, dr))
    batch = torch.from_numpy(np.stack(frames[:SERVE_BATCH])).to(dev)
    timer = profiling.MeshTimer(mesh2.distinct)
    with config.numerics_mode(srv.tier), torch.inference_mode():
        sharded(batch)
        reset_counts()
        timer.start()
        out = sharded(batch)
        sharded_ms = timer.stop()
        count_f16(f"sharded_batch_apply, batch {SERVE_BATCH} over 2 entries", 2)
        timer.start()
        serving.u8_forward(srv._model, batch, dr)
        whole_ms = timer.stop()
    d = level_diff(out.cpu().numpy(), ref[:SERVE_BATCH])
    print(f"   RLFN [{srv.tier}] batch {SERVE_BATCH} at {SIZE}x{SIZE}: sharded over [{dev}] * 2 "
          f"{sharded_ms:.3f} ms, one forward {whole_ms:.3f} ms (CUDA events from a synchronised "
          f"start); against SRServer: max {int(d.max())} levels, {float((d > 0).mean()):.2e} 1+ "
          f"apart, {float((d > 1).mean()):.2e} 2+ apart; on {smi}")
    require(float((d > 1).mean()) < 1e-4 and float((d > 0).mean()) < 0.2,
            "sharded_batch_apply too far from SRServer's output (phase 5's bar)")

    # (e) SRServer(mesh=) streaming ------------------------------------------
    msrv = serving.SRServer(model_id=4, max_batch=SERVE_BATCH, device=dev, mesh=mesh2)
    msrv.warmup((SIZE, SIZE))
    torch.cuda.synchronize()
    reset_counts()
    ts = time.perf_counter()
    mouts = np.stack(list(msrv.process_stream(frames)))
    serve_s = time.perf_counter() - ts
    count_f16(f"SRServer(mesh=[{dev}] * 2), {len(frames)} frames at batch {SERVE_BATCH}",
              2 * len(frames) // SERVE_BATCH)
    d = level_diff(mouts, ref)
    print(f"   SRServer(mesh) [{msrv.tier}]: {len(frames)} frames in {serve_s:.3f} s, "
          f"{len(frames) / serve_s:.1f} images/s, SRServer without a mesh on the same frames "
          f"{len(frames) / ref_s:.1f} (host clock); against SRServer: max "
          f"{int(d.max())} levels, {float((d > 0).mean()):.2e} 1+ apart, "
          f"{float((d > 1).mean()):.2e} 2+ apart; on {smi}")
    require(mouts.shape == ref.shape and float((d > 1).mean()) < 1e-4
            and float((d > 0).mean()) < 0.2, "SRServer(mesh=) too far from SRServer's output")
    del srv, msrv, sharded, out, batch

    # (c) NASNetBN H-sharded: halo, windowed, composed ------------------------
    model, name, dr28, _ = registry.build_model(28, device=dev)
    require(dr28 == 1.0, "NASNetBN's data range is not 1")
    spec = registry.get_spec(28)
    nas_pairs = data.write_synthetic_div2k(os.path.join(work, "nas"),
                                           list(MESH_NAS_HW) + [MESH_NAS_HW[0]], seed=2)
    lrs = [torch.from_numpy(img_util.uint2nhwc(img_util.imread_uint(lr), dr28)).to(dev)
           for lr, _ in nas_pairs]
    hrs = [img_util.modcrop(img_util.imread_uint(hr), 4) for _, hr in nas_pairs]

    def chaos_check(tag: str, got: np.ndarray, whole: np.ndarray, moved: np.ndarray,
                    hr_list) -> None:
        """``high`` runs the HR tail under fast (bf16): held to the tier's own
        chaos, the whole forward against itself on an input moved by 1e-4,
        and each image's PSNR within 0.01 dB of the whole forward's."""
        dd, cd = level_diff(got, whole), level_diff(whole, moved)
        dps = [metrics.calculate_psnr(g, h, border=4) - metrics.calculate_psnr(w, h, border=4)
               for g, w, h in zip(got, whole, hr_list)]
        print(f"   {tag}: against the whole forward max {int(dd.max())} levels, "
              f"{float((dd > 0).mean()):.2e} 1+ apart, mean {float(dd.mean()):.4f}; the tier's "
              f"own move {float((cd > 0).mean()):.2e} 1+ apart, mean {float(cd.mean()):.4f}; "
              f"PSNR delta {max(abs(v) for v in dps):.6f} dB")
        require(float(dd.mean()) <= 2 * float(cd.mean()) + 1e-3
                and float((dd > 1).mean()) <= 2 * float((cd > 1).mean()) + 1e-5
                and max(abs(v) for v in dps) <= PSNR_BAR_DB,
                f"{tag}: further from the whole forward than the tier's own scale")

    cases = [(f"halo, LR {MESH_NAS_HW[0][0]}x{MESH_NAS_HW[0][1]}", mesh2, None, [0], "halo"),
             (f"windowed, LR {MESH_NAS_HW[1][0]}x{MESH_NAS_HW[1][1]}", mesh2, None, [1],
              "windowed"),
             (f"composed (2, 2), 2 images at LR {MESH_NAS_HW[0][0]}x{MESH_NAS_HW[0][1]}",
              data_space_mesh(2, 2, devices=[dev] * 4), "data", [0, 2], "halo")]
    with config.numerics_mode("high"), torch.inference_mode():
        for tag, mesh, batch_axis, idx, scheme in cases:
            x = torch.cat([lrs[i] for i in idx])
            fn = make_spatial_apply(model, mesh, overlap=spec.halo,
                                    axis="space" if batch_axis else "data", batch_axis=batch_axis)
            require(fn.plan(x.shape) == scheme, f"{tag}: plan {fn.plan(x.shape)}, not {scheme}")
            fn(x)
            model(x)  # the whole forward's first call at this shape, untimed
            timer = profiling.MeshTimer([dev])
            reset_counts()
            timer.start()
            y = fn(x)
            ms = timer.stop()
            count_r2(f"NASNetBN [high] {tag}", mesh.devices.size)
            timer.start()
            whole = model(x)
            whole_ms = timer.stop()
            moved = model(x + 1e-4 * dr28)
            print(f"   NASNetBN [high] {tag}: sharded {ms:.3f} ms, whole {whole_ms:.3f} ms "
                  f"(CUDA events); on {smi}")
            chaos_check(f"NASNetBN {tag}", u8(y), u8(whole), u8(moved), [hrs[i] for i in idx])
            del y, whole, moved

    # the runner's spatial branch: each entry's slab forward a CUDA graph,
    # fed LR 340x512, 339x510, 340x512: each entry holds one graph, so the
    # third image captures again, in prepare, outside the timed window
    logger = logging.getLogger("chip_smoke_mesh")
    logger.propagate = False
    logger.setLevel(logging.INFO)
    graphs_at = []

    class GraphsPerImage(logging.Handler):
        """graphs.captures at each image's PSNR line, logged after its forward."""

        def emit(self, record):
            if " - PSNR: " in record.getMessage():
                graphs_at.append(graphs.captures)

    logger.addHandler(GraphsPerImage())
    res = {}
    with config.numerics_mode("high"):
        for tag, smesh in (("one device", None), (f"[{dev}] * 2", mesh2)):
            reset_counts()
            graphs_at.clear()
            captures0 = graphs.captures
            res[tag] = runner.run(model, name, dr28, None, logger,
                                  types.SimpleNamespace(save_dir=os.path.join(work, "sr_nas"),
                                                        ssim=False),
                                  mode="valid", pairs=nas_pairs, spatial_mesh=smesh,
                                  spatial_overlap=spec.halo)
            captures = graphs.captures - captures0
            per_image = [int(v) for v in np.diff([captures0] + graphs_at)]
            t = res[tag]["valid_runtime"]
            if smesh is not None:
                count_r2(f"runner.run(spatial_mesh) NASNetBN ({captures} graphs)", 2 * captures)
            print(f"   runner.run NASNetBN [high] {tag}, LR {[hw for hw in MESH_NAS_HW]} then "
                  f"{MESH_NAS_HW[0]}: per image {[round(v, 3) for v in t]} ms, graphs captured "
                  f"per image {per_image}, PSNR {[round(p, 4) for p in res[tag]['valid_psnr']]} "
                  f"dB, memory {res[tag]['valid_memory']:.1f} MB (CUDA events, with a mesh from "
                  f"a synchronised start); on {smi}")
            want = 1 if smesh is None else mesh2.devices.size
            require(per_image == [want] * len(nas_pairs),
                    f"runner.run {tag}: graphs captured per image {per_image}, not {want} each")
            require(abs(t[2] / t[0] - 1.0) <= MESH_REPEAT_TIME_BAR,
                    f"runner.run {tag}: the repeated shape took {t[2]:.3f} ms against "
                    f"{t[0]:.3f} ms the first time (a capture in the timed window?)")
    dps = [abs(p - q) for p, q in zip(res["one device"]["valid_psnr"],
                                       res[f"[{dev}] * 2"]["valid_psnr"])]
    require(len(dps) == len(nas_pairs) and max(dps) <= PSNR_BAR_DB,
            "runner.run(spatial_mesh=): PSNR off the one-device run")

    # (d) PipelinedSR(28) over [cuda:0, cuda:0] -------------------------------
    rs = np.random.RandomState(3)
    batches = [rs.rand(*MESH_PIPE_SHAPE).astype(np.float32) * dr28
               for _ in range(MESH_PIPE_BATCHES)]
    pipe = PipelinedSR(28, devices=[dev, dev], model=model)
    with config.numerics_mode("high"):
        pipe.process_one(batches[0])
        torch.cuda.synchronize()
        reset_counts()
        tp = time.perf_counter()
        outs = list(pipe.process_stream(batches))
        pipe_s = time.perf_counter() - tp
        count_r2(f"PipelinedSR(28), {len(batches)} batches", len(batches))
        with torch.inference_mode():
            wholes = [model(torch.from_numpy(b_).to(dev)).float().cpu().numpy() for b_ in batches]
            moved = [model(torch.from_numpy(b_).to(dev) + 1e-4 * dr28).float().cpu().numpy()
                     for b_ in batches]
    require(len(outs) == len(batches), f"PipelinedSR gave {len(outs)} batches of {len(batches)}")

    def u8n(a: np.ndarray) -> np.ndarray:
        return np.round(np.clip(a, 0, 1) * 255.0).astype(np.uint8)

    for k, (o, w_, m_) in enumerate(zip(outs, wholes, moved)):
        dd, cd = level_diff(u8n(o), u8n(w_)), level_diff(u8n(w_), u8n(m_))
        print(f"   PipelinedSR batch {k}: against its whole forward max {int(dd.max())} levels, "
              f"mean {float(dd.mean()):.4f}; the tier's own move mean {float(cd.mean()):.4f}")
        require(float(dd.mean()) <= 2 * float(cd.mean()) + 1e-3
                and float((dd > 1).mean()) <= 2 * float((cd > 1).mean()) + 1e-5,
                f"PipelinedSR batch {k}: off its own whole forward (order or values)")
    print(f"   PipelinedSR(28) [high] over [{dev}] * 2: {len(batches)} batches of "
          f"{MESH_PIPE_SHAPE} in {pipe_s:.3f} s (host clock, to host arrays); on {smi}")
    del pipe, model, lrs
    shutil.rmtree(work)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from ntire2022_esr_tpu_torch import config
        from ntire2022_esr_tpu_torch.harness import profiling, registry, serving
        from ntire2022_esr_tpu_torch.ops.kernels import build, conv_chain, tail
        from ntire2022_esr_tpu_torch.tools import chain_check
    except ImportError as e:
        print(f"chip_smoke: the port's package is not here ({e})", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    t_all = time.perf_counter()
    dev = torch.device("cuda")

    # 1. device and build --------------------------------------------------
    t0 = phase("1. device and build")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"   torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")
    tb = time.perf_counter()
    logs = build.build(verbose=True)
    build_s = time.perf_counter() - tb
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"   [{name}] {line.strip()}")
    print(f"   built {sorted(logs)} in {build_s:.1f} s (parallel nvcc)")
    model, name, dr, _ = registry.build_model(4, device=dev)
    print(f"   phase 1: {time.perf_counter() - t0:.1f} s")

    max_err = {}

    # 2. chain kernel vs plain ---------------------------------------------
    t0 = phase("2. conv3x3_chain kernels vs plain")
    # cuDNN's 2-byte convs, which the plain versions of fast and fast16 call,
    # sum in f32 on this card: each output within one ulp of the f64 sum
    # of the same rounded operands, rounded to the dtype
    convs = (model.B1.c1_r, model.B1.c2_r, model.B1.c3_r)
    for dt, ulp in ((torch.bfloat16, 2.0 ** -7), (torch.float16, 2.0 ** -10)):
        with torch.inference_mode():
            x = chain_args(model, (8, SIZE, SIZE, 46), dt, seed=1)[0]
            w = convs[0].weight.to(dt)
            out = F.conv2d(x, w, padding=1).float()
            ref = F.conv2d(x.double(), w.double(), padding=1).to(dt).float()
            scale = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1.0))))
            ulps = float(((out - ref).abs() / (ulp * scale)).max())
            rate = flip_rate(out, ref)
            print(f"   stock {str(dt)[6:]} conv 46->48 (cuDNN) against f64 rounded to "
                  f"{str(dt)[6:]}: max {ulps:.2f} ulps, {rate:.3e} of values differ -> "
                  f"{'ok' if ulps <= 1.0 and rate <= 1e-2 else 'FAIL'}", flush=True)
            require(ulps <= 1.0 and rate <= 1e-2, f"cuDNN's {dt} conv does not sum in f32")
            del x, out, ref, scale
    f64_ratios = {}
    for tier in ("parity", "high", "mixed", "fasthi16", "fasthi", "fast", "fast16"):
        with config.numerics_mode(tier), torch.inference_mode():
            dt = config.numerics().activation_dtype
            for shape in ((8, SIZE, SIZE, 46), (2, 63, 41, 46)):
                x, ws, bs = chain_args(model, shape, dt, seed=1)
                out = conv_chain.fused_conv3x3_chain(x, ws, bs, slope=0.05, residual=True)
                ref = conv_chain.conv3x3_chain_plain(x, ws, bs, slope=0.05, residual=True)
                torch.cuda.synchronize()
                err = compare(f"chain {shape}", out, ref, tier)
                if tier in F32_TIERS:
                    f64_ratios[f"chain {shape} [{tier}]"] = f64_check(
                        f"chain {shape} [{tier}]", out, ref, chain_f64(x, ws, bs))
                else:
                    one = (chain_check.one_rounding("chain", ws, bs)(x)
                           if tier in TWO_BYTE_TIERS else None)
                    flip_check(f"chain {shape}", "chain", out, ref, tier, one)
                    del one
                if shape[0] == 8 and tier not in ("high", "mixed"):
                    max_err[entry_of("conv3x3_chain", tier)] = err
                del out, ref
    for tier in ("fasthi16", "parity", "fasthi", "fast", "fast16"):
        with config.numerics_mode(tier), torch.inference_mode():
            dt = config.numerics().activation_dtype
            x = chain_args(model, (2, 40, 52, 46), dt, seed=5)[0]
            cases = [("1 stage 46->48", x, [convs[0].weight], [convs[0].bias], False),
                     ("2 stages 46->48->46", x, [convs[0].weight, convs[2].weight],
                      [convs[0].bias, None], True)]
            for shape, chans in (((2, 64, 64, 24), [(24, 24)] * 2),
                                 ((1, 40, 40, 20), [(20, 24), (24, 24), (24, 20)]),
                                 ((1, 33, 47, 5), [(5, 7), (7, 5)])):
                cases.append((f"{shape} {chans}", *random_chain(shape, chans, seed=6, dtype=dt),
                              True))
            for tag, x, ws, bs, residual in cases:
                out = conv_chain.fused_conv3x3_chain(x, ws, bs, slope=0.05, residual=residual)
                ref = conv_chain.conv3x3_chain_plain(x, ws, bs, slope=0.05, residual=residual)
                torch.cuda.synchronize()
                compare(f"chain {tag}", out, ref, tier)
    end_phase_checks("phase 2")
    print(f"   phase 2: {time.perf_counter() - t0:.1f} s")

    # 3. tail kernel vs plain ----------------------------------------------
    t0 = phase("3. conv3x3_pixelshuffle kernels vs plain")
    for tier in ("parity", "high", "mixed", "fasthi16", "fasthi", "fast", "fast16"):
        with config.numerics_mode(tier), torch.inference_mode():
            dt = config.numerics().activation_dtype
            for shape in ((8, SIZE, SIZE, 46), (2, 63, 41, 46)):
                x, w, b = tail_args(model, shape, dt, seed=2)
                out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=4)
                ref = tail.conv3x3_pixelshuffle_plain(x, w, b, r=4)
                torch.cuda.synchronize()
                err = compare(f"tail {shape}", out, ref, tier)
                if tier in F32_TIERS:
                    f64_ratios[f"tail {shape} [{tier}]"] = f64_check(
                        f"tail {shape} [{tier}]", out, ref, tail_f64(x, w, b))
                else:
                    one = (chain_check.one_rounding("tail", [w], [b])(x)
                           if tier in TWO_BYTE_TIERS else None)
                    flip_check(f"tail {shape}", "tail", out, ref, tier, one)
                    del one
                if shape[0] == 8 and tier not in ("high", "mixed"):
                    max_err[entry_of("conv3x3_pixelshuffle", tier)] = err
                del out, ref
    for tier in ("fasthi16", "parity", "fasthi", "fast", "fast16"):
        with config.numerics_mode(tier), torch.inference_mode():
            dt = config.numerics().activation_dtype
            for shape, cout, r, bias in (((2, 63, 41, 50), 3, 4, True), ((2, 40, 52, 40), 3, 4, True),
                                         ((2, 40, 52, 42), 3, 4, True), ((2, 40, 52, 64), 3, 4, True),
                                         ((2, 40, 52, 24), 3, 3, True), ((1, 33, 47, 5), 3, 2, True),
                                         ((2, 5, 3, 46), 3, 4, True), ((1, 40, 40, 46), 3, 4, False),
                                         ((1, 24, 32, 16), 4, 4, True)):
                x, w, b = random_tail(shape, cout, r, seed=7, bias=bias, dtype=dt)
                out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=r)
                ref = tail.conv3x3_pixelshuffle_plain(x, w, b, r=r)
                torch.cuda.synchronize()
                tag = f"tail {shape} -> {cout * r * r} r={r}{'' if bias else ' no bias'}"
                compare(tag, out, ref, tier)
                if tier == "parity" and shape[3] in (40, 42, 50, 64):  # the zoo's upsamplers
                    f64_ratios[f"{tag} [{tier}]"] = f64_check(f"{tag} [{tier}]", out, ref,
                                                              tail_f64(x, w, b, r))
    # the HR tails' x2 upsamplers (ops/fused.py), 52 -> 208 and 64 -> 256 in
    # channel groups, with RLFN's tail's checks
    r2_err = {}
    for tier in ("fasthi16", "parity", "fasthi", "fast", "fast16"):
        with config.numerics_mode(tier), torch.inference_mode():
            dt = config.numerics().activation_dtype
            for cin, cout in R2_WIDTHS:
                for shape in ((2, 37, 29, cin), (4, 64, 64, cin)):
                    x, w, b = random_tail(shape, cout, 2, seed=9, dtype=dt)
                    out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=2)
                    ref = tail.conv3x3_pixelshuffle_plain(x, w, b, r=2)
                    torch.cuda.synchronize()
                    tag = f"tail {shape} -> {4 * cout} r=2"
                    err = compare(tag, out, ref, tier)
                    if tier == "parity":
                        f64_ratios[f"{tag} [{tier}]"] = f64_check(f"{tag} [{tier}]", out, ref,
                                                                  tail_f64(x, w, b, 2))
                    else:
                        one = (chain_check.one_rounding("tail", [w], [b], r=2)(x)
                               if tier in TWO_BYTE_TIERS else None)
                        r2_flip_check(tag, out, ref, x, w, b, tier, one)
                        del one
                    if tier == "fast" and shape[0] == 4:
                        r2_err[(cin, 4 * cout)] = err
                    del out, ref
    print(json.dumps({"f64_error_ratios": f64_ratios}))
    end_phase_checks("phase 3")
    print(f"   phase 3: {time.perf_counter() - t0:.1f} s")

    # 4. golden parity on the card -----------------------------------------
    t0 = phase("4. golden parity (parity tier, TF32 off)")
    with config.numerics_mode("parity"), torch.inference_mode():
        require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
                "TF32 is on")
        for stem in ("model_04", "model_04_63x41"):
            g = np.load(os.path.join(HERE, "tests", "goldens", f"{stem}.npz"))
            x = torch.from_numpy(g["input_u8"].astype(np.float32) / (255.0 / float(g["data_range"])))
            before = total_counts()
            out = model(x[None].to(dev)).cpu().numpy()[0]
            after = total_counts()
            require((after[0] - before[0], after[1] - before[1]) == (4, 1),
                    "the golden forward did not run through the kernels")
            err = float(np.abs(out - g["output"]).max())
            print(f"   {stem}: max|d| vs torch reference {err:.3e} (bar {2e-4 * dr:.3e})")
            require(out.shape == g["output"].shape and err < 2e-4 * dr, f"{stem} golden parity")
    print(f"   phase 4: {time.perf_counter() - t0:.1f} s")

    # 5. serving ------------------------------------------------------------
    t0 = phase("5. serving SRServer(model_id=4)")
    srv = serving.SRServer(model_id=4, max_batch=SERVE_BATCH, device=dev)
    print(f"   tier {srv.tier} (results/protocol/zoo_sustained_gated.json), "
          f"max_batch {SERVE_BATCH}, depth 2")
    rs = np.random.RandomState(0)
    frames = list(rs.randint(0, 256, (SERVE_BATCH * SERVE_BATCHES, SIZE, SIZE, 3), dtype=np.uint8))
    srv.warmup((SIZE, SIZE))
    torch.cuda.synchronize()
    reset_counts()
    packs_warm = conv_chain.packs
    ts = time.perf_counter()
    outs = list(srv.process_stream(frames))
    serve_s = time.perf_counter() - ts
    print(f"   weight packs: {packs_warm} before the stream (build, phases 2-4, warm-up), "
          f"{conv_chain.packs - packs_warm} during it")
    require(conv_chain.packs == packs_warm, "the serving stream packed weights again")
    got = total_counts()
    launches = {"conv3x3_chain": got[0], "conv3x3_pixelshuffle": got[1]}
    print(f"   launches in the serving run: {got[0]} chain, {got[1]} tail")
    require(got == (4 * SERVE_BATCHES, SERVE_BATCHES)
            and path_counts("f16") == (4 * SERVE_BATCHES, SERVE_BATCHES),
            "serving did not run 4 chain launches and 1 tail launch per forward on the f16 path")
    require(len(outs) == len(frames) and all(o.shape == (4 * SIZE, 4 * SIZE, 3) and
                                             o.dtype == np.uint8 for o in outs),
            "serving output shape/dtype")
    ips = len(frames) / serve_s
    print(f"   {len(frames)} frames in {serve_s:.3f} s: {ips:.1f} images/sec "
          f"(host clock, batch {SERVE_BATCH}, {srv.tier}) on {smi}")

    def plain_served(u8: np.ndarray, tier: str, shift: float = 0.0) -> np.ndarray:
        y = plain_forward(model, torch.from_numpy(u8).to(dev).float() / (255.0 / dr) + shift, tier)
        return torch.round(y.clamp(0, dr) * (255.0 / dr)).to(torch.uint8).cpu().numpy()

    ref = np.concatenate([plain_served(np.stack(frames[i:i + SERVE_BATCH]), srv.tier)
                          for i in range(0, len(frames), SERVE_BATCH)])
    d = np.abs(np.stack(outs).astype(np.int16) - ref.astype(np.int16))
    print(f"   served vs plain forward on the card [{srv.tier}]: max {int(d.max())} levels, "
          f"{float((d > 0).mean()):.2e} of values 1+ apart, {float((d > 1).mean()):.2e} 2+ apart")
    far = np.argwhere(d > 1)
    if len(far):
        print(f"   values 2+ apart: {len(far)}; first (frame, y, x, c): {far[:8].tolist()}; "
              f"their (y % 64, x % 88) in the 64x88 output tile of one 16x22 block of the tail: "
              f"{[(int(v[1]) % 64, int(v[2]) % 88) for v in far[:8]]}")
    # fasthi16 rounds every conv output to f16. Where the kernel's f32 sum
    # and cuDNN's differ in their last bits, a store rounds the other way,
    # and the network carries and amplifies that one-ulp flip (JAX's own
    # fasthi16 output moves by mean 0.12 / max 1.0 on an f32 input moved by
    # 1e-4), so some outputs land across a rounding boundary. A fault in a
    # kernel would move whole tiles: bound the share of values 2+ apart.
    require(float((d > 1).mean()) < 1e-4 and float((d > 0).mean()) < 0.2,
            "served output too far from the plain forward")
    # every other path: the split-TF32 kernels with 3 (parity, mixed) and 2
    # (fasthi) products, and the m16n8k16 kernels' one product with the
    # two-rounding epilogue (fast: bf16, fast16: f16)
    few = np.stack(frames[:8])
    for tier in ("parity", "mixed", "fasthi", "fast", "fast16"):
        tsrv = serving.SRServer(model_id=4, max_batch=8, device=dev, tier=tier)
        reset_counts()
        tout = np.stack(list(tsrv.process_stream(frames[:8])))
        got = path_counts(path_of(tier))
        print(f"   launches serving 8 frames [{tier}]: {got[0]} chain, {got[1]} tail on the "
              f"{path_of(tier)} path (of {total_counts()})")
        require(got == (4, 1) and total_counts() == got,
                f"[{tier}] serving did not run its path's kernels once a block")
        launches[entry_of("conv3x3_chain", tier)] = got[0]
        launches[entry_of("conv3x3_pixelshuffle", tier)] = got[1]
        td = level_diff(tout, plain_served(few, tier))
        print(f"   served vs plain forward on the card [{tier}]: max {int(td.max())} levels, "
              f"{float((td > 0).mean()):.2e} of values 1+ apart, {float((td > 1).mean()):.2e} "
              f"2+ apart, mean {float(td.mean()):.4f}")
        if tier in F32_TIERS:
            require(int(td.max()) <= 1,
                    f"{tier} serving differs from the plain forward by more than 1 level")
        else:
            # 2-byte storage is chaotic per pixel (ROADMAP §3 item 5): hold
            # the kernels to the tier's own scale, how far the plain forward
            # moves when its input moves by 1e-4 of the data range
            cd = level_diff(plain_served(few, tier), plain_served(few, tier, shift=1e-4 * dr))
            print(f"   the tier's own scale [{tier}]: plain forward against itself on an input "
                  f"moved by 1e-4 * dr: max {int(cd.max())} levels, {float((cd > 0).mean()):.2e} "
                  f"1+ apart, {float((cd > 1).mean()):.2e} 2+ apart, mean {float(cd.mean()):.4f}")
            require(float(td.mean()) <= 2 * float(cd.mean()) + 1e-3
                    and float((td > 1).mean()) <= 2 * float((cd > 1).mean()) + 1e-5,
                    f"{tier} serving is further from the plain forward than the tier's own scale")
    print(f"   phase 5: {time.perf_counter() - t0:.1f} s")

    # 6. times at the served shape -----------------------------------------
    t0 = phase(f"6. times at batch {TIME_BATCH}, {SIZE}x{SIZE}, fasthi16")

    def cuda_ms(fn, *args) -> float:
        """Median of 5 CUDA-event times of ``fn(*args)`` after 2 warm-ups, in ms."""
        return profiling.device_timer(fn, *args, iters=5, warmup=2)[0] * 1e3

    def library_dtype(tier: str, two_byte: bool = False):
        """The dtype of ``tier``'s library call (``LIBRARY_DTYPE``); with
        ``two_byte`` under fasthi16 and fasthi, their storage dtype."""
        if tier in LIBRARY_DTYPE:
            return getattr(torch, LIBRARY_DTYPE[tier])
        return config._MODES[tier].activation_dtype if two_byte else torch.float32

    def library_chain(tier: str, ws, bs, two_byte: bool = False):
        """cuDNN's chain: each conv in the library dtype, its output rounded
        to the tier's storage dtype, then LeakyReLU; then + x."""
        dt, store = library_dtype(tier, two_byte), config._MODES[tier].activation_dtype
        lw, lb = [w.to(dt) for w in ws], [b.to(dt) for b in bs]

        def run(v):
            h = v
            for w, b in zip(lw, lb):
                h = F.leaky_relu(F.conv2d(h.to(dt), w, b, padding=1).to(store), 0.05)
            return h + v
        return run

    def library_tail(tier: str, w, b, r: int = 4, two_byte: bool = False):
        dt, store = library_dtype(tier, two_byte), config._MODES[tier].activation_dtype
        lw, lb = w.to(dt), b.to(dt)
        return lambda v: F.pixel_shuffle(F.conv2d(v.to(dt), lw, lb, padding=1).to(store), r)

    records = []
    npix = TIME_BATCH * SIZE * SIZE
    with config.numerics_mode("fasthi16"), torch.inference_mode():
        x, ws, bs = chain_args(model, (TIME_BATCH, SIZE, SIZE, 46), torch.float16, seed=3)
        out = conv_chain.fused_conv3x3_chain(x, ws, bs)
        ref = conv_chain.conv3x3_chain_plain(x, ws, bs)
        torch.cuda.synchronize()
        compare(f"chain (batch {TIME_BATCH})", out, ref, "fasthi16")
        chain_flips = flip_rate(out, ref)
        del out, ref
        c = CHAIN_WIDTHS
        macs = 9 * sum(c[k] * c[k + 1] for k in range(3)) * npix
        nbytes = npix * (c[0] + c[-1]) * 2 + sum(w.numel() * 4 + b.numel() * 4 for w, b in zip(ws, bs))
        ms = cuda_ms(conv_chain.fused_conv3x3_chain, x, ws, bs)
        plain_ms = cuda_ms(conv_chain.conv3x3_chain_plain, x, ws, bs)
        lib_ms = cuda_ms(library_chain("fasthi16", ws, bs), x)
        lib2_ms = cuda_ms(library_chain("fasthi16", ws, bs, two_byte=True), x)
        records.append(("conv3x3_chain", "ntire2022_esr_tpu_torch/csrc/conv_chain.cu",
                        "ntire2022_esr_tpu/ops/pallas/conv_chain.py:166", macs, nbytes,
                        ms, plain_ms, lib_ms, lib2_ms))
        x_chain = x  # its f32 copy is the split-TF32 rows' input

        x, w, b = tail_args(model, (TIME_BATCH, SIZE, SIZE, 46), torch.float16, seed=4)
        out = tail.fused_conv3x3_pixelshuffle(x, w, b)
        ref = tail.conv3x3_pixelshuffle_plain(x, w, b)
        torch.cuda.synchronize()
        compare(f"tail (batch {TIME_BATCH})", out, ref, "fasthi16")
        tail_flips = flip_rate(out, ref)
        del out, ref
        macs = 9 * 46 * 48 * npix
        nbytes = npix * 46 * 2 + npix * 48 * 2 + w.numel() * 4 + b.numel() * 4
        ms = cuda_ms(tail.fused_conv3x3_pixelshuffle, x, w, b)
        plain_ms = cuda_ms(tail.conv3x3_pixelshuffle_plain, x, w, b)
        lib_ms = cuda_ms(library_tail("fasthi16", w, b), x)
        lib2_ms = cuda_ms(library_tail("fasthi16", w, b, two_byte=True), x)
        records.append(("conv3x3_pixelshuffle", "ntire2022_esr_tpu_torch/csrc/tail.cu",
                        "ntire2022_esr_tpu/ops/pallas/tail.py:71", macs, nbytes,
                        ms, plain_ms, lib_ms, lib2_ms))
        x_tail = x
    kernels = []
    products, rate, form = F32_GRADE_BOUND["fasthi16"]
    for kname, src, replaces, macs, nbytes, ms, plain_ms, lib_ms, lib2_ms in records:
        t_ops = 2 * macs * products / rate * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        print(f"   {kname}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library (cuDNN f32 on "
              f"the upcast f16, f32 weights, rounded to f16: the same function) {lib_ms:.3f} ms "
              f"({lib_ms / ms:.2f}x the kernel); cuDNN f16 (weights rounded to f16: another "
              f"function) {lib2_ms:.3f} ms; bound {bound:.3f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
              f"{2 * macs / 1e9:.1f} GFLOP, {form} {t_ops:.3f} ms, "
              f"{nbytes / 1e6:.1f} MB {t_bytes:.3f} ms) = {bound / ms:.1%} of the bound; "
              f"f32 CUDA-core bound {2 * macs / PEAK_F32_FLOPS * 1e3:.3f} ms; on {smi}")
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_err[kname],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
        })
    print(f"   phase 6: {time.perf_counter() - t0:.1f} s")
    for kname, flips in (("conv3x3_chain", chain_flips), ("conv3x3_pixelshuffle", tail_flips)):
        print(f"   {kname} flip rate (batch {TIME_BATCH}, fasthi16): {flips:.3e} of f16 "
              f"outputs differ between the kernel and its plain version")

    # the split-TF32 paths under parity and fasthi, beside cuDNN f32 (TF32
    # off); fast and fast16 (one bf16 or f16 m16n8k16 product, two
    # roundings) beside cuDNN in their own dtype
    rows = []
    convs = (model.B1.c1_r, model.B1.c2_r, model.B1.c3_r)
    cws, cbs = [cv.weight for cv in convs], [cv.bias for cv in convs]

    c = CHAIN_WIDTHS
    x_base = x_chain.float()
    del x_chain
    for tier in ("parity", "fasthi", "fast", "fast16"):
        with config.numerics_mode(tier), torch.inference_mode():
            x = x_base.to(config.numerics().activation_dtype)
            out = conv_chain.fused_conv3x3_chain(x, cws, cbs)
            compare(f"chain [{tier}] (batch {TIME_BATCH})", out,
                    conv_chain.conv3x3_chain_plain(x, cws, cbs), tier)
            del out
            rows.append(("conv3x3_chain", "46->48->48->46", tier,
                         9 * sum(c[k] * c[k + 1] for k in range(3)),
                         (c[0] + c[-1]) * x.element_size(), cws + cbs,
                         cuda_ms(conv_chain.fused_conv3x3_chain, x, cws, cbs),
                         cuda_ms(conv_chain.conv3x3_chain_plain, x, cws, cbs),
                         cuda_ms(library_chain(tier, cws, cbs), x),
                         cuda_ms(library_chain(tier, cws, cbs, True), x)
                         if tier in TWO_BYTE_LIBRARY else None, npix))
            del x
    del x_base
    # RLFN's tail, then every other upsampler width of the ported zoo
    for cin in (46, 40, 42, SKELETON_NF, 64):
        if cin == 46:
            x_base, w, b = x_tail.float(), model.upsampler[0].weight, model.upsampler[0].bias
            del x_tail
        else:  # the input drawn on the card: numpy would take seconds at this size
            _, w, b = random_tail((1, 8, 8, cin), 3, 4, seed=8)
            gen = torch.Generator(device=dev).manual_seed(8)
            x_base = torch.randn((TIME_BATCH, cin, SIZE, SIZE), generator=gen, device=dev) * 8
            x_base = x_base.contiguous(memory_format=torch.channels_last)
        # every tier's path (fasthi16 at 46 is the f16 record above)
        tiers = ("parity", "fasthi", "fast", "fast16") + (() if cin == 46 else ("fasthi16",))
        for tier in tiers:
            with config.numerics_mode(tier), torch.inference_mode():
                x = x_base.to(config.numerics().activation_dtype)
                out = tail.fused_conv3x3_pixelshuffle(x, w, b)
                compare(f"tail {cin}->48 [{tier}] (batch {TIME_BATCH})", out,
                        tail.conv3x3_pixelshuffle_plain(x, w, b), tier)
                del out
                rows.append(("conv3x3_pixelshuffle", f"{cin}->48 r=4", tier, 9 * cin * 48,
                             (cin + 48) * x.element_size(), [w, b],
                             cuda_ms(tail.fused_conv3x3_pixelshuffle, x, w, b),
                             cuda_ms(tail.conv3x3_pixelshuffle_plain, x, w, b),
                             cuda_ms(library_tail(tier, w, b), x),
                             cuda_ms(library_tail(tier, w, b, two_byte=True), x)
                             if tier in TWO_BYTE_LIBRARY else None, npix))
                del x
        del x_base
    # the HR tails' x2 upsamplers under fast and fast16 (and fasthi and
    # fasthi16, whose library call is cuDNN f32), at batch R2_BATCH and the
    # size each sees for a 256x256 LR input
    r2_rows = {}  # widths -> (cin, conv channels)
    for cin, cout, side in R2_TIMED:
        _, w, b = random_tail((1, 8, 8, cin), cout, 2, seed=10)
        gen = torch.Generator(device=dev).manual_seed(10)
        x_base = torch.randn((R2_BATCH, cin, side, side), generator=gen, device=dev) * 8
        x_base = x_base.contiguous(memory_format=torch.channels_last)
        widths = f"{cin}->{4 * cout} r=2 at {R2_BATCH}x{side}x{side}"
        r2_rows[widths] = (cin, 4 * cout)
        for tier in ("fast", "fast16", "fasthi", "fasthi16"):
            with config.numerics_mode(tier), torch.inference_mode():
                x = x_base.to(config.numerics().activation_dtype)
                out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=2)
                compare(f"tail {widths} [{tier}]", out,
                        tail.conv3x3_pixelshuffle_plain(x, w, b, r=2), tier)
                del out
                rows.append(("conv3x3_pixelshuffle", widths, tier, 9 * cin * 4 * cout,
                             (cin + 4 * cout) * x.element_size(), [w, b],
                             cuda_ms(lambda v: tail.fused_conv3x3_pixelshuffle(v, w, b, r=2), x),
                             cuda_ms(lambda v: tail.conv3x3_pixelshuffle_plain(v, w, b, r=2), x),
                             cuda_ms(library_tail(tier, w, b, 2), x),
                             cuda_ms(library_tail(tier, w, b, 2, two_byte=True), x)
                             if tier in TWO_BYTE_LIBRARY else None, R2_BATCH * side * side))
                del x
        del x_base
    rows_json = []
    for (kname, widths, tier, macs_px, bytes_px, params, ms, plain_ms, lib_ms, lib2_ms,
         row_px) in rows:
        macs = macs_px * row_px
        nbytes = bytes_px * row_px + sum(t.numel() * 4 for t in params)
        products, rate, form = F32_GRADE_BOUND[tier]
        t_ops = 2 * macs * products / rate * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        k_products, k_rate, k_type = KERNEL_FORM[tier]
        own = f"{k_type} x{k_products}"
        own_bound = max(2 * macs * k_products / k_rate * 1e3, t_bytes)
        old_bound = max(2 * macs / PEAK_F32_FLOPS * 1e3, t_bytes)
        store = str(config._MODES[tier].activation_dtype)[6:]
        lib = (f"cuDNN {LIBRARY_DTYPE[tier]}" if tier in LIBRARY_DTYPE else
               "cuDNN f32 (TF32 off)" + (f" rounded to {store}" if store != "float32" else ""))
        verdict = (f"beats {lib} by {lib_ms / ms:.2f}x" if ms < lib_ms
                   else f"loses to {lib} by {ms / lib_ms:.2f}x")
        if lib2_ms is not None:
            verdict += (f"; cuDNN {store} (weights rounded to {store}: another function) "
                        f"{lib2_ms:.3f} ms")
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"   {kname} {widths} [{tier}, {'split ' if k_products > 1 else ''}{own}]: kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, {lib}{' + shuffle' if 'r=' in widths else ''} "
              f"{lib_ms:.3f} ms ({verdict}); bound {bound:.3f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}: {2 * macs / 1e9:.1f} GFLOP, "
              f"{form} {t_ops:.3f} ms, {nbytes / 1e6:.1f} MB {t_bytes:.3f} ms) = "
              f"{bound / ms:.1%} of it; the kernel's own form ({own}) "
              f"{own_bound:.3f} ms; f32 CUDA-core bound {old_bound:.3f} ms; on {smi}", flush=True)
        rows_json.append({"kernel": kname, "widths": widths, "tier": tier, "ms": ms,
                          "plain_ms": plain_ms, "library": lib, "library_ms": lib_ms,
                          "library_2byte_ms": lib2_ms,
                          "bound_ms": bound, "bound_by": bound_by, "bound_form": form,
                          "kernel_form_bound_ms": own_bound,
                          "f32_cuda_core_bound_ms": old_bound})
        if widths in ("46->48->48->46", "46->48 r=4"):
            entry = entry_of(kname, tier)
            kernels.append({
                "name": entry, "route": "cuda",
                "source": records[0 if kname == "conv3x3_chain" else 1][1],
                "replaces": records[0 if kname == "conv3x3_chain" else 1][2],
                "launches": launches[entry], "max_abs_err": max_err[entry],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": lib_ms,
            })
        elif widths in r2_rows and tier == "fast":
            # the HR tails' path under high; launches: phase 8's served forwards
            cin, nch = r2_rows[widths]
            kernels.append({
                "name": f"conv3x3_pixelshuffle_bf16x1_r2_{cin}to{nch}", "route": "cuda",
                "source": records[1][1], "replaces": records[1][2], "launches": None,
                "max_abs_err": r2_err[(cin, nch)], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            })
    print(json.dumps({"rows": rows_json}))
    print(f"   phase 6 with the split-TF32, fast and fast16 rows: {time.perf_counter() - t0:.1f} s")

    # 7. challenge protocol ---------------------------------------------------
    t0 = phase("7. challenge protocol (harness.cli, runner, x8, tiling; model 04)")
    protocol_phase(model, dr, smi)
    print(f"   phase 7: {time.perf_counter() - t0:.1f} s")

    # 8. the zoo ------------------------------------------------------------
    t0 = phase(f"8. the zoo ({len(ZOO_IDS)} models besides RLFN)")
    zoo, r2_launches = zoo_phase(smi)
    print(json.dumps({"zoo": zoo}))
    for rec in kernels:
        if rec["launches"] is None:  # an x2 upsampler's: its served forwards in phase 8
            cin, nch = (int(v) for v in rec["name"].rsplit("_", 1)[1].split("to"))
            rec["launches"] = r2_launches.get((cin, nch), 0)
            require(rec["launches"] > 0, f"{rec['name']} never launched on the main path")
    print(f"   phase 8: {time.perf_counter() - t0:.1f} s")

    # 9. serving CLI --------------------------------------------------------
    t0 = phase("9. serving CLI (harness.serve: chain, split and tiled plans)")
    serve_phase(smi)
    print(f"   phase 9: {time.perf_counter() - t0:.1f} s")

    # 10. multi-device paths on the one card ----------------------------------
    t0 = phase("10. multi-device paths on the one card (parallel/, --mesh, SRServer(mesh=))")
    mesh_launches = mesh_phase(smi)
    for rec in kernels:
        if rec["name"] in mesh_launches:
            rec["mesh_launches"] = mesh_launches[rec["name"]]
            require(rec["mesh_launches"] > 0, f"{rec['name']} never launched in phase 10")
    print(json.dumps({"mesh_launches": mesh_launches}))
    print(f"   phase 10: {time.perf_counter() - t0:.1f} s")
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
