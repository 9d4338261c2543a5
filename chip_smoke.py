#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ntire2022_esr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device and build: the card's name and power limit; both CUDA kernels
   compiled from ``ntire2022_esr_tpu_torch/csrc`` (nvcc, sm_90a), with the
   ptxas register/shared-memory report, no ``wgmma`` that ptxas
   serialized, and ``HGMMA`` (``cuobjdump -sass``) in each of the three
   instantiations of the 2-byte chain on warpgroup MMA, each of the three
   of each 2-byte tail kernel (weights resident, and streamed through the
   ring), each of the four of
   the split-TF32 chain's and each of the ten of the split-TF32 tail's
   (``WGMMA_KERNELS``);
2. first one stock bf16 and one f16 conv (cuDNN, RLFN's 46 -> 48) against
   an f64 conv of the same rounded operands, rounded to the dtype: within
   one ulp, so cuDNN sums 2-byte convs in f32 on this card. Then the
   conv-chain kernels against their plain PyTorch version on the card, at
   (8, 256, 256, 46) with widths 46 -> 48 -> 48 -> 46 and at (2, 63, 41,
   46), under parity, high, mixed, fasthi16, fasthi, fast and fast16 (f32
   activations: the split-TF32 kernel on TF32 warpgroup MMA,
   ``conv3x3_chain_wgmma_tf32_kernel``, with 3 products; bf16 with f32
   weights (fasthi): the same kernel with 2; f16 with f32 weights
   (fasthi16): the 2-byte wgmma kernel with two f16 products; fast16 and
   fast: the 2-byte wgmma kernel with one f16 or bf16 product on weights
   packed rounded to the dtype, and the bias added after the sum's
   rounding), each launch held to the kernel of its path
   (``conv_chain.launches_by_kernel``; no width takes another kernel) and,
   under the split-TF32 tiers, the library's shared memory for the widths
   to the plan that ``conv_chain.wgmma_tf32_plan`` reckons;
   under parity, high and
   mixed each kernel's largest error against an f64 chain (cuDNN in
   float64) at most 4x the plain f32 chain's (cuDNN f32, TF32 off), under
   the 2-byte tiers the flip rate (under fasthi, fast and fast16 at most
   ``tools/chain_check.py``'s ``FLIP_BARS``; under fast and fast16 also the
   flip rate against a plain version that adds the bias inside one
   rounding, which must be at least 10x as high); under fasthi16, parity,
   fasthi, fast and fast16 also chains of one and two stages and of the
   other widths of ``tools/chain_check.py``'s ``CHAIN_WIDTHS`` (24 -> 24 ->
   24, 20 -> 24 -> 24 -> 20, 5 -> 7 -> 5, 64 -> 56 -> 64 and 112 -> 112 in
   two and three steps a stage, the depth-4 16 -> 40 -> 32 -> 8 -> 16, and
   under parity, fasthi, fast and fast16 160 -> 160; 112 and 160 take the
   2-byte wgmma kernel's 8x8 tile, where a warpgroup has no m-block, and
   the split-TF32 kernel takes 8x16 for 64, 112 and the depth-4 chain and
   4x4 and 8x8 for 160), so that the padding, step and tile paths run,
   under fast and fast16 each also held to the flip bar or,
   where the plain version sums in another order, to the f64 sums, as far
   from them as the plain version on those widths or on the widths padded
   to 16s (``order_check``);
3. the conv+PixelShuffle kernels against their plain version, same shapes,
   tiers and checks, each launch served in one channel group by the
   kernel of its tier's path (the 2-byte wgmma kernel under fasthi16, fast
   and fast16, the split-TF32 wgmma kernel under parity, high, mixed and
   fasthi; ``served_tail``), each launch's plan and shared memory held
   to those that ``tail.wgmma_plan`` reckons; under fasthi16, parity,
   fasthi, fast and fast16 also other widths and factors (the zoo's upsamplers 40, 42, 50, 64 -> 48
   r=4, 24 -> 27 r=3, 5 -> 12 r=2, 16 -> 64 r=4), an image smaller than one
   tile and a missing bias, so that the padding, general-row, second-chunk
   and plain-copy paths run beside the tensor copies; and under the same five
   tiers the HR tails' x2 upsamplers (``R2_WIDTHS``: 24 -> 96, 32 -> 128,
   52 -> 208, 64 -> 256, r = 2, the last two with their 2-byte weights
   streamed through the ring) at
   (2, 37, 29), an image no tile divides, and at (4, 64, 64), held by the
   same checks as RLFN's tail: the flip bars, the one-rounding control
   under fast and fast16, f64 under parity; and under the same five tiers
   with the same checks the zoo's x4 upsamplers (``ZOO_R4_WIDTHS``: 29, 32,
   36, 40, 42, 46, 48, 50, 56, 64 and 3 -> 48, and SCET's 64 -> 64 and 3 -> 64
   to 4 channels) at one LR 339x510 frame (odd widths take the plain-copy
   loads);
4. golden parity: the port's RLFN under parity on the card against
   ``tests/goldens/model_04*.npz`` within 2e-4 * 255;
5. serving: ``SRServer(model_id=4)`` at its card plan's tier streams three
   batches of 32 random 256x256 uint8 frames (numpy seed 0) through the
   kernels (launch counts checked: 4 chain launches and 1 tail launch per
   forward; both kernels' weights are packed during warm-up and never in
   the stream), and its output is held against the same forward built from
   the plain versions on the card; then 8 frames served under each other
   tier with a path of its own (fasthi16 too, where the plan is not it):
   parity and mixed (the 3-product split-TF32 kernels, at most 1 level
   from the plain forward), fasthi (2 products),
   fast and fast16 (one bf16 or f16 product, the two-rounding
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
   upsamplers under parity, fast, fast16, fasthi and fasthi16 at batch 16
   at the size each sees for a 256x256 LR input (``R2_TIMED``), beside the
   same library calls + PixelShuffle(2); then each (width, tier) that a zoo
   model's x4 upsampler serves (``ZOO_TAILS`` at its tier in JAX's envelope) at one LR
   339x510 frame under a CUDA graph, beside its library call + PixelShuffle
   under a graph of its own;
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
   through the graph-timed ``runner.run`` at its card plan's tier (NLFFC tiled
   at 256, 2 tiles a call, as the registry says), whose PSNR must be
   within 0.01 dB of an eager forward's; a line per model with the graph
   and eager times and the peak memory. The 34 models whose x4 upsampler
   is a 3x3 conv + PixelShuffle(4) (``ZOO_TAILS``; all but AALN, MobileSR,
   RLCSR, NLFFC and the HR tails) launch the tail kernel at each of their
   upsamplers once a captured forward, by path and shape exactly, on their
   card plan's tier's path, and the chain never; their goldens do so on parity's
   path (``tf32x3``); no weight pack after the warm-up; the served PSNR
   within 0.01 dB of the same forward on the kernel's plain version; and
   the forward's graph timed beside the same forward with
   ``blocks.conv_shuffle`` on ``ops.conv`` + ``pixel_shuffle`` (before and
   after routing, one after the other, in this run). AALN, MobileSR, RLCSR and
   NLFFC launch no kernel. For the HR tails (27, 28,
   33, gated at ``high``, their tails under ``fast``) instead: the
   launches of each captured forward (2 tail launches on ``bf16x1``,
   nothing else), no weight pack after the warm-up, and the served PSNR
   within 0.01 dB of the same forward on the kernels' plain versions.
   Every model's parity screen, at its tier in JAX's envelope (an eager
   forward where the card's plan takes another tier, whose served PSNR
   must then be within 0.01 dB of parity's too): the PSNR of a parity
   forward of the same image beside that tier's; a model whose tier misses it by
   more than 0.01 dB fails the phase unless the mean of its gaps over
   ``ZOO_SCREEN_FRAMES`` synthetic frames (this image first, eager
   forwards) is JAX's mean over the same frames on the CPU
   (``tests/goldens/zoo_tier_gaps.json``, written by
   ``tests/make_zoo_tier_gaps.py``; ``tests/test_torch_parity_screen.py``
   holds the port's gap to JAX's there) within 0.002 dB: the loss is then
   the tier's own arithmetic. One frame's gap is too noisy for that bar
   (see ``ZOO_SCREEN_FRAMES``). The frames are smooth synthetic fields,
   not DIV2K, so this is a screen and not the challenge's gate. For
   NLFFC also: the DFT products' share of an eager forward's device time
   (the ``spectral.dft`` profiler span), how many of its global-context
   softmax maps overflow in f16 under fast16 (their map is 0), the fast16
   image's PSNR against parity's forward of it, and the DFT products
   beside cuFFT's ``rfft``/``irfft`` on one 2-tile chunk's global half;
9. serving: ``harness.serve.main`` in-process, each run's JSON summary
   printed: ``--list`` (every registry model has a plan); ``--model_id 4
   --synthetic 64 --hw 256 256`` (the chain plan: 4 chain launches and 1
   tail launch a forward, warm-up included, and the saved frames equal
   ``SRServer(4)``'s); ``--synthetic 16 --hw 128 128`` for the lowest id
   the card's envelope plans ``split`` (LWFANet) and for NASNetBN (28), each
   at its card plan (a split plan: 2 ``bf16x1`` tail launches a tail chunk;
   a chain plan: 2 a forward; no weight pack after the warm-up; a split
   plan at most 1 level and under 1e-3 of values off the unsplit server, a
   chain plan equal to it; phase 13 times NASNetBN's split against its
   whole forward);
   ``--model_id 2 --synthetic 2 --hw 339 510`` and then
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
   (``profiling.MeshTimer``), the streams on the host clock;
11. the w8 tier (int8 weights, one f32 scale per (cin, cout) pair,
   dequantized at use; ``porter/quant.py``): both kernels against their
   plain versions on seeded f32 weights quantized by
   ``porter.quantize_array_int8`` at RLFN's widths (chain 46 -> 48 -> 48
   -> 46 at (8, 256, 256), tail 46 -> 48 r = 4) under fasthi16, parity,
   fast and fast16 with the bars of phases 2-3 (f64 under parity, the flip
   bars and the one-rounding control), one pack per weight set over two
   calls, and an int8 weight without its scale refused; ``SRServer(4)``
   built under ``config.set_weights_int8(True)`` at fasthi16 streaming 64
   frames of 256x256 at batch 32 beside the f32 server (4 ``f16`` chain
   launches and 1 tail launch a forward, no pack in the stream, the uint8
   output at phase 5's bar against the plain w8 forward and at least 44 dB
   from the f32 server's; images/s, peak memory, the model's and its
   packs' bytes); NASNetBN (28) under w8 at ``high`` through the
   graph-timed ``runner.run`` on one LR 339x510 image (2 ``bf16x1`` tail
   launches a captured forward, no pack after the first forward, graph
   PSNR within 0.01 dB of the eager one and of the plain versions'); and
   ``python -m ntire2022_esr_tpu_torch.harness.cli --model_id 4`` in a
   process of its own with ``NTIRE_W8=1`` (its model's ``B1.c1_r.weight``
   int8) beside one without, on phase 7's six valid pairs, each image's
   PSNR printed side by side;
12. the reference block library (``models/blocks.py``, JAX
   ``models/blocks.py:182-431``) at KAIR ``basicblock.py``'s default widths
   with seeded weights: ``res_block`` CRC, ``rcab`` (reduction 16) and
   ``rca_group`` (nb 12) at 64 channels, ``residual_dense_block_5c`` and
   ``rrdb`` (nc 64, gc 32), ``cfrb`` at 50, ``non_local_block_2d`` at 64,
   ``upsample_pixelshuffle`` 2R (64 -> 256 r = 2) and 4 (64 -> 48 r = 4),
   ``upsample_upconv`` and ``upsample_convtranspose`` 2R, the three
   ``downsample_*`` and ``mode_conv`` CIL and CBR, each on the card against
   the same block on the CPU under parity at 64x64 within the goldens'
   2e-4 * data_range; that run's tail launches (one a pixel-shuffle
   upsampler, on ``tf32x3``, nothing else); the two upsamplers again under
   parity, fast, fast16 and fasthi16, their launches by path (2 a tier) and
   the library's kernel calls (``blocks.conv_shuffle``) held to the tail's
   plain version with phase 3's bars (f64 under parity, the flip bars and
   the one-rounding control under fast and fast16), and the tail at the
   goldens' width cin = 8 (8 -> 16 and 8 -> 12 at r = 2, 8 -> 48 at r = 4);
   ``rrdb``, ``rca_group`` and the two upsamplers timed under a CUDA graph
   at 256x256, batch 1 (the upsamplers beside ``ops.conv`` +
   ``pixel_shuffle`` on cuDNN); ``imresize_matlab`` at x1/4 on a seeded
   2040x1356 frame against ``imresize_matlab_np`` on the host within 1e-5,
   timed; and ``.pth`` files of RLFN (04) and BSRN (18, whose linears the
   porter transposes; wrapped under ``params`` with DataParallel's prefix)
   made from the shipped npz by inverting its layout rules
   (``porter.reference_state_dict``), which ``registry.build_model(id,
   weights_dir=<empty>, zoo_dir=<the .pth directory>)`` ports on the card:
   the npz it writes equal to the shipped one in every key, dtype and
   value, and ``SRServer`` on the model equal in every uint8 value to the
   one built from the shipped cache;
13. the serving plans: the card's envelope
   (``results/h100/zoo_sustained_gated.json``) rebuilt by
   ``tools/make_gated_envelope.py`` from the committed rows
   (``results/h100/zoo_sustained.json``) must equal the committed file,
   and every row must name an NVIDIA card and its power limit (printed
   beside this card's); then ``tools/sweep_zoo_sustained.py`` times again,
   at 3 reps and 3 iterations and each row's batch, the candidates of three
   models, each beside its committed row: RLFN at fasthi16 and high; the
   lowest id whose card tier differs from JAX's envelope's, at both tiers
   (FMEN at high and fasthi where none does); NASNetBN at high, split
   against chain. Where a pair's committed rows differ by more than
   ``PLAN_ORDER_GAP``, the two new times keep their order. Phases 5, 8 and
   9 serve at the card's plans; phase 8's parity screen and phases 6 and
   12 keep the tiers of JAX's envelope, for which the goldens were made.

The line before the last is one JSON object with a record per kernel and
path (``conv3x3_chain`` and ``conv3x3_pixelshuffle`` for the split-f16
path under fasthi16, ``_f16x1`` and ``_bf16x1`` for the one-product path
under fast16 and fast, and ``_tf32x3`` and ``_tf32x2`` for the split-TF32
ones; ``conv3x3_pixelshuffle_bf16x1_r2_<cin>to<channels>`` for the HR
tails' x2 upsamplers under fast, whose launches are counted in phase 8's
served forwards); the kernels launched in phase 10 carry ``mesh_launches``,
their launches there, and those of phase 11's served w8 forwards
``w8_launches``, and the tail's paths that phase 12's library upsamplers
took ``library_launches``, and the tail's paths that phase 8's x4
upsamplers took ``zoo_launches`` (their launches in the served forwards).
The last line is ``{"ok": true, "device": {...}}``.
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
# type); fast and fast16 run one product on their 2-byte operands
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
# phase 8's synthetic LR frames (PROTOCOL_VALID[0]) are written from this
# seed; the first is the one served. Its parity screen: each model's gated-
# tier PSNR on the first frame within PSNR_BAR_DB of its parity PSNR, or
# the mean of its gaps over ZOO_SCREEN_FRAMES frames within
# SCREEN_JAX_BAR_DB of JAX's mean over the same frames on the CPU
# (tests/make_zoo_tier_gaps.py writes ZOO_TIER_GAPS). One frame's gap moves
# with where the two frameworks' f32 sums round a 2-byte store the other
# way: the card's and JAX's gaps differ by up to 0.0052 dB on one frame and
# by 0.0000 on another of the same model (PERF.md section 5). The frames
# are smooth synthetic fields, not DIV2K (RLFN reads 54.5 dB on the
# first): a screen, not the challenge's gate
ZOO_SCREEN_SEED = 1
ZOO_SCREEN_FRAMES = 8
ZOO_TIER_GAPS = os.path.join("tests", "goldens", "zoo_tier_gaps.json")
SCREEN_JAX_BAR_DB = 0.002
NLFFC_DFT_SHAPE = (2, 1024, 1024, 32)
F16_INF = 65520.0  # the least f32 value that rounds to inf in f16
# phase 9: serve.main runs (argv, the test frame shapes)
SERVE_CHAIN = ["--model_id", "4", "--synthetic", "64", "--hw", "256", "256"]
SERVE_HR = ["--synthetic", "16", "--hw", "128", "128"]  # the HR-tail models' frames
SERVE_TILED = ["--model_id", "2", "--synthetic", "2", "--hw", "339", "510"]
TILED_SECOND = (300, 420)  # a second frame shape for NLFFC's one chunk graph
# the HR tails and their x2 upsamplers (cin, conv channels): each captured
# forward of the served model launches the tail kernel on each once
HR_TAILS = {27: ((64, 256), (64, 256)), 28: ((32, 128), (32, 128)), 33: ((52, 208), (24, 96))}
# the zoo's x4 upsamplers (cin, conv channels), r = 4, in call order
# (models.blocks.conv_shuffle; tests/test_torch_zoo_tails.py holds the same
# sites on the CPU): each captured forward of the served model launches the
# tail kernel on each once, on its gated tier's path, and the chain never.
# AALN (11), MobileSR (20) and RLCSR (42) upsample on stock ops
ZOO_TAILS = {
    -1: ((64, 48),), 0: ((50, 48),), 1: ((48, 48),), 3: ((50, 48),), 5: ((42, 48),),
    6: ((50, 48),), 8: ((50, 48),), 9: ((64, 48),), 10: ((48, 48),), 12: ((50, 48),),
    13: ((64, 48),), 14: ((50, 48),), 15: ((46, 48),), 16: ((40, 48),), 17: ((29, 48),),
    18: ((48, 48),), 19: ((64, 48),), 22: ((40, 48),), 23: ((48, 48),), 24: ((64, 48),),
    25: ((64, 48),), 26: ((64, 48),), 29: ((32, 48),), 30: ((64, 64), (3, 64)), 31: ((32, 48),),
    34: ((3, 48), (32, 48)), 35: ((50, 48),), 36: ((32, 48),), 37: ((40, 48),), 38: ((50, 48),),
    39: ((36, 48),), 40: ((40, 48),), 43: ((48, 48),), 44: ((56, 48),),
}
# phases 3 and 6: the widths of ZOO_TAILS as (cin, cout) of the shuffle,
# RLFN's (AFDN's) 46 first; phase 3 holds each at one LR frame of
# PROTOCOL_VALID[0] under five tiers, phase 6 times each beside its library
# call (at batch TIME_BATCH those timed so before this slice and SCET's
# 64 -> 64, whose routing rests on its time at its serving plan's batch,
# R4_FULL_BATCH; the others at ZOO_TIME_BATCH) and each served (width,
# path) at one such frame under a CUDA graph
ZOO_R4_WIDTHS = ((46, 3), (29, 3), (32, 3), (36, 3), (40, 3), (42, 3), (48, 3), (50, 3),
                 (56, 3), (64, 3), (3, 3), (64, 4), (3, 4))
R4_FULL_BATCH = ((46, 3), (40, 3), (42, 3), (50, 3), (64, 3), (64, 4))
ZOO_TIME_BATCH = 16
# phase 3: the x2 upsamplers as (cin, cout) of the shuffle; phase 6 times them
# at batch R2_BATCH on the LR side each sees for a 256x256 input
R2_WIDTHS = ((24, 24), (32, 32), (52, 52), (64, 64))
R2_BATCH = 16
R2_TIMED = ((24, 24, 512), (32, 32, 256), (52, 52, 256), (64, 64, 256))
# phase 1: (library, kernel, instantiations) of the kernels on warpgroup
# MMA, each of which must issue HGMMA: the 2-byte chain (fasthi16, fast16,
# fast) and tail (the same, with its weights resident, and streamed
# through the ring),
# the split-TF32 chain (f32 and bf16 activations, unrolled
# at RLFN's 3 k-chunks and at any width) and the split-TF32 tail (f32 and
# bf16 activations, per tap at 2, 3 and 4 k-chunks and at any number, and
# folded). No other kernel is in the tail's library: every tail launch
# runs one of these three
WGMMA_KERNELS = (("conv_chain", "conv3x3_chain_wgmma_kernel", 3),
                 ("conv_chain", "conv3x3_chain_wgmma_tf32_kernel", 4),
                 ("tail", "conv3x3_pixelshuffle_wgmma_kernel", 3),
                 ("tail", "conv3x3_pixelshuffle_wgmma_ring_kernel", 3),
                 ("tail", "conv3x3_pixelshuffle_wgmma_tf32_kernel", 10))
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
# phase 11: the w8 tier. The kernels against their plain versions on int8
# weights under these tiers; SRServer(4) under w8 at fasthi16 on
# W8_FRAMES frames, held to the JAX package's whole-model floor against
# the f32 server (tests/test_quant.py); NASNetBN (28) under high
W8_TIERS = ("fasthi16", "parity", "fast", "fast16")
W8_FRAMES = 64
W8_PSNR_FLOOR_DB = 44.0
W8_HR_TAIL = 28
# phase 12: the reference library (models/blocks.py) at KAIR basicblock.py's
# default widths: each block on the card against the CPU at LIB_HW under
# parity within the goldens' bar (2e-4 * data_range, data_range 1); the
# pixel-shuffle upsamplers' tail launches, by path, under LIB_TIERS; four
# blocks timed under a CUDA graph at LIB_TIME_HW, batch 1
LIB_HW = 64
LIB_BAR = 2e-4
LIB_TIERS = ("parity", "fast", "fast16", "fasthi16")
LIB_TIMED = ("rrdb", "rca_group", "upsample_pixelshuffle 2R", "upsample_pixelshuffle 4")
LIB_TIME_HW = 256
# the goldens' width (tests/goldens/blocks.npz): the tail at cin = 8
LIB_NARROW = ((8, 4, 2), (8, 3, 2), (8, 3, 4))  # (cin, cout, r)
RESIZE_HR = (1356, 2040)  # a DIV2K HR frame, H x W, resized by 1/4 on the card
RESIZE_BAR = 1e-5
CKPT_IDS = (4, 18)  # RLFN, and BSRN with its linear_keys
# phase 13: the serving plans. Re-timed at fewer reps than the sweep's 8;
# where a pair's committed times differ by more than the gap (the larger
# over the smaller, less 1), the new pair keeps their order. FMEN stands
# for a model whose card tier differs from JAX's where none does.
PLAN_RETIME = {"reps": 3, "iters": 3}
PLAN_ORDER_GAP = 0.15
PLAN_FLIP_DEFAULT = (3, ("high", "fasthi"))


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
        for counts in (mod.launches_by_path, mod.launches_by_kernel):
            for k in counts:
                counts[k] = 0
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
    ``dtype``) and f32 weights and biases from numpy ``seed``
    (``tools/chain_check.py`` random_chain)."""
    import torch
    from ntire2022_esr_tpu_torch.tools import chain_check

    return chain_check.random_chain(shape, chans, seed, dtype or torch.float16)


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


def order_check(tag: str, kernel: str, out, ref, tier: str, one, exact, padded=None) -> None:
    """``flip_check``'s bar against the plain version. Under fast and
    fast16 a kernel over its bar passes only where the plain version sums
    the products in another order than the kernel: then both are held to
    ``exact()``, the f64 sums of the same rounded operands, rounded as the
    tier rounds: the kernel's flip rate against it at most 1.5x the plain
    version's, and the one-rounding control ``one`` at least 10x the
    kernel's rate against the plain version. ``padded()``, if given, is the
    plain version on the widths zero-padded to 16s, which the library
    computes with its tensor-core algorithm: the kernel may then be as far
    from the f64 sums as the further of the two (at 5 -> 7 -> 5 cuDNN takes
    another algorithm, 1.3e-4 from them; on the padded widths it gives the
    kernel's result bit for bit, 6.4e-4 from them; PERF.md §6)."""
    from ntire2022_esr_tpu_torch.tools.chain_check import FLIP_BARS

    rate = flip_rate(out, ref)
    if tier not in TWO_BYTE_TIERS or rate <= FLIP_BARS[tier][kernel]:
        flip_check(tag, kernel, out, ref, tier, one)
        return
    ex = exact()
    k_ex, p_ex, rate1 = flip_rate(out, ex), flip_rate(ref, ex), flip_rate(out, one)
    q_ex = flip_rate(padded(), ex) if padded is not None else 0.0
    ok = k_ex <= 1.5 * max(p_ex, q_ex) and rate1 >= 10 * rate
    q_txt = f", plain on widths padded to 16s {q_ex:.3e}" if padded is not None else ""
    print(f"   {tag} [{tier}]: flip rate {rate:.3e} over the bar {FLIP_BARS[tier][kernel]:.0e}: "
          f"another sum order; against the f64 sums rounded as {tier} rounds: kernel {k_ex:.3e}, "
          f"plain {p_ex:.3e}{q_txt} (at most 1.5x); against one rounding {rate1:.3e} "
          f"(at least 10x) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        FLIP_FAILURES.append(f"{tag} [{tier}]")


def tail_flip_check(tag: str, out, ref, x, w, b, tier: str, one, r: int = 2) -> None:
    """The flip check of the x2 upsamplers (phase 3) and of the library's
    upsamplers (phase 12, r = 2 and 4). ``flip_check``'s bar against
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
    from ntire2022_esr_tpu_torch.tools.chain_check import exact_two_byte

    order_check(tag, "tail", out, ref, tier, one,
                lambda: exact_two_byte(x, w, b, r, config.numerics().compute_dtype))


def served_tail(tail, before: dict, tag: str, tier: str, cin: int, nch: int, r: int) -> None:
    """The tail launch made since ``before`` (a copy of
    ``tail.launches_by_kernel``) ran, in one channel group, the kernel of
    its tier's path: the 2-byte wgmma kernel under fasthi16, fast and
    fast16, the split-TF32 wgmma kernel under the others; and the
    library's plan (tile, ring buffers, step result buffers) and shared
    memory for ``cin -> nch`` channels at ``r`` are those that
    ``tail.wgmma_plan`` reckons."""
    import ctypes

    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.ops.kernels import build

    served = [k for k, v in tail.launches_by_kernel.items() if v != before[k]]
    want = [tail.kernel_of(path_of(tier))]
    require(served == want, f"{tag} [{tier}]: served by {served}, not {want}")
    nm = config._MODES[tier]
    cout, code, fast = nch // (r * r), build.dtype_code(nm.activation_dtype), int(
        nm.two_byte_compute)
    plan = tail.wgmma_plan(cin, cout, r, nm.activation_dtype, nm.compute_dtype)
    lib = tail._lib()
    got = (ctypes.c_int * 4)()
    lib.conv3x3_pixelshuffle_plan(code, fast, cin, cout, r, got)
    nbytes = lib.conv3x3_pixelshuffle_smem_bytes(code, fast, cin, cout, r)
    mirror = (*plan["tile"], plan["nbuf"], plan["nres"], plan["bytes"])
    require((*got, nbytes) == mirror and plan["kernel"] == want[0],
            f"{tag} [{tier}]: the kernel plans {tuple(got)} and {nbytes} bytes of shared "
            f"memory, wgmma_plan {plan}")


def served_chain(conv_chain, before: dict, tag: str, tier: str, widths) -> None:
    """The chain launch made since ``before`` (a copy of
    ``conv_chain.launches_by_kernel``) ran the kernel of its tier's path:
    the split-TF32 wgmma kernel under parity, high, mixed and fasthi, the
    2-byte wgmma kernel under the others; no width takes another kernel.
    Under the split-TF32 tiers the library's shared memory for ``widths``
    is the plan's of ``conv_chain.wgmma_tf32_plan``."""
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.ops.kernels import build

    served = [k for k, v in conv_chain.launches_by_kernel.items() if v != before[k]]
    want = [conv_chain.kernel_of(path_of(tier))]
    require(served == want, f"{tag} [{tier}]: served by {served}, not {want}")
    if want == ["wgmma_tf32"]:
        dt = config._MODES[tier].activation_dtype
        plan = conv_chain.wgmma_tf32_plan(widths, dt.itemsize)
        got = conv_chain._lib().conv3x3_chain_smem_bytes(
            build.dtype_code(dt), 0, len(widths) - 1, *(list(widths) + [0] * (5 - len(widths))))
        require(plan is not None and got == plan["bytes"],
                f"{tag} [{tier}]: the kernel plans {got} bytes of shared memory, "
                f"wgmma_tf32_plan {plan}")


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
    Returns a record per model, the tail's launches on the HR tails' x2
    upsamplers in their served forwards, by (cin, conv channels), those of
    the x4 upsamplers (ZOO_TAILS), by the kernels line's name of their path,
    and the checks that failed: the phase reads every model before it
    fails, so that one call shows all of them."""
    import collections

    import torch
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import (data, envelope, graphs, profiling, registry,
                                                 runner, serving, tiling)
    from ntire2022_esr_tpu_torch.models import blocks
    from ntire2022_esr_tpu_torch.ops import fused
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail
    from ntire2022_esr_tpu_torch.utils import image as img_util
    from ntire2022_esr_tpu_torch.utils import metrics

    with open(os.path.join(HERE, ZOO_TIER_GAPS)) as fh:
        gaps_file = json.load(fh)
    require(gaps_file["image"]["frames"] == ZOO_SCREEN_FRAMES
            and gaps_file["image"]["seed"] == ZOO_SCREEN_SEED,
            f"{ZOO_TIER_GAPS} holds other frames than phase 8's")
    jax_gaps = gaps_file["models"]
    work = os.path.join(HERE, "build", "zoo_smoke")
    shutil.rmtree(work, ignore_errors=True)
    written = data.write_synthetic_div2k(os.path.join(work, "div2k"),
                                         [PROTOCOL_VALID[0]] * ZOO_SCREEN_FRAMES,
                                         seed=ZOO_SCREEN_SEED)
    frames = [(img_util.imread_uint(lr_p), img_util.modcrop(img_util.imread_uint(hr_p), 4))
              for lr_p, hr_p in written]
    (lr_path, hr_path), (lr, hr) = written[0], frames[0]
    logger = logging.getLogger("chip_smoke_zoo")
    logger.propagate = False
    logger.addHandler(logging.NullHandler())
    dev = torch.device("cuda")
    hrs = [torch.from_numpy(h).to(dev) for _, h in frames[1:]]
    records, failures = [], []

    def check(cond: bool, msg: str) -> None:
        if not cond:
            print(f"   FAIL: {msg}", flush=True)
            failures.append(msg)

    r2_launches: dict = {}
    zoo_launches = collections.Counter()

    def stock_shuffle(p, x, r, *, stride=1, padding=1):
        from ntire2022_esr_tpu_torch import ops
        return ops.pixel_shuffle(ops.conv(p, x, stride=stride, padding=padding), r)

    def card_psnr(y, hr_t, dr: float) -> float:
        """metrics.calculate_psnr(img_util.nhwc2uint(y, dr), hr, border=4)
        on the card: the same f32 scaling and rounding, and the squared
        differences of integers summed exactly in f64."""
        u8 = torch.round(y[0].float().clamp(0, dr) * (255.0 / dr))
        d = (u8.double() - hr_t.double())[4:-4, 4:-4]
        return 20 * math.log10(255.0 / math.sqrt(float((d * d).mean())))

    def graph_ms(fn, x) -> float:
        """Median of 10 CUDA-event times of one replay of ``fn``'s graph."""
        g = graphs.GraphedForward(fn, dev)
        g.prepare(x)
        return profiling.device_timer(lambda _: g.replay(), x, iters=10, warmup=2)[0] * 1e3

    for mid in ZOO_IDS:
        model, name, dr, tile = registry.build_model(mid, device=dev)
        per_call = registry.get_spec(mid).max_tiles_per_call
        # served, timed and counted at the card's plan; screened at the
        # tier of JAX's envelope, where tests/goldens/zoo_tier_gaps.json is
        tier = serving.gated_tier(name)
        screen_tier = serving.gated_tier(name, envelope.TPU_PATH)
        require(tier in config.modes() and screen_tier in config.modes(),
                f"{name}: tier {tier!r} or {screen_tier!r} is not a tier of the port")
        sites = ZOO_TAILS.get(mid, ())
        err = 0.0
        for stem in NLFFC_GOLDENS if mid == 2 else (f"model_{mid:02d}",):
            g = np.load(os.path.join(HERE, "tests", "goldens", f"{stem}.npz"))
            x = torch.from_numpy(g["input_u8"].astype(np.float32) / (255.0 / float(g["data_range"])))
            reset_counts()
            with config.numerics_mode("parity"), torch.inference_mode():
                out = model(x[None].to(dev)).cpu().numpy()[0]
            e = float(np.abs(out - g["output"]).max())
            check(out.shape == g["output"].shape and e < 2e-4 * dr,
                  f"{name}: golden {stem} max|d| {e:.3e} over 2e-4 * {dr}")
            if sites:  # the goldens run through the kernel, on parity's path
                want = collections.Counter(("tf32x3", cin, nch, 4) for cin, nch in sites)
                check(dict(tail.launches_by_shape) == want and total_counts()[0] == 0,
                      f"{name}: golden {stem} launched {dict(tail.launches_by_shape)}, "
                      f"want {dict(want)}")
            err = max(err, e)
        xl = torch.from_numpy(img_util.uint2nhwc(lr, dr)).to(dev)

        def forward(v):
            return tiling.forward(model, v, tile, max_tiles_per_call=per_call)

        hr_tail = mid in HR_TAILS
        path = path_of(tier)
        with config.numerics_mode(tier):
            if hr_tail or sites:
                # the warm-up packs the tail's weights; nothing packs after it
                with torch.inference_mode():
                    model(xl)
                packs0 = conv_chain.packs
            reset_counts()
            graphs0 = graphs.captures
            res = runner.run(model, name, dr, tile, logger,
                             types.SimpleNamespace(save_dir=os.path.join(work, "sr"), ssim=False),
                             mode="valid", pairs=[(lr_path, hr_path)], max_tiles_per_call=per_call)
            # each captured forward launches in its warm-up and its capture
            forwards = 2 * (graphs.captures - graphs0)
            require(forwards > 0, f"{name}: no graph captured")
            if hr_tail:
                # the HR tail's scope stores bf16 under high and mixed
                path = path_of("fast" if tier in ("high", "mixed") else tier)
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
                want = {(path, cin, nch, 4): n * forwards for (cin, nch), n in
                        collections.Counter(sites).items()}
                got = dict(tail.launches_by_shape)
                print(f"   {name}: tail launches by (path, cin, channels, r) {got} and "
                      f"{total_counts()[0]} chain launches over {forwards} captured forwards "
                      f"(want {want})")
                check(got == want and total_counts()[0] == 0,
                      f"{name}: tail launches {got} and {total_counts()[0]} chain launches in "
                      f"{forwards // 2} captured forwards; want {want} and none")
                zoo_launches["conv3x3_pixelshuffle" + ("" if path == "f16" else f"_{path}")] += \
                    sum(got.values())
            timer = profiling.Timer(dev)
            with torch.inference_mode():
                forward(xl)
                timer.start()
                y = forward(xl)
                eager_ms = timer.stop()
            sr = img_util.nhwc2uint(y.float().cpu().numpy(), dr)
        p_graph, p_eager = res["valid_psnr"][0], metrics.calculate_psnr(sr, hr, border=4)
        # the parity screen: the same image's parity forward
        with config.numerics_mode("parity"), torch.inference_mode():
            sr_parity = img_util.nhwc2uint(forward(xl).float().cpu().numpy(), dr)
        p_parity = metrics.calculate_psnr(sr_parity, hr, border=4)
        p_screen, p_screen_eager = p_graph, p_eager
        if screen_tier != tier:
            with config.numerics_mode(screen_tier), torch.inference_mode():
                p_screen = p_screen_eager = metrics.calculate_psnr(
                    img_util.nhwc2uint(forward(xl).float().cpu().numpy(), dr), hr, border=4)
        gap = p_screen - p_parity
        jx = jax_gaps.get(name)
        jx = jx if jx is not None and jx["tier"] == screen_tier else None
        gaps, jax_mean = None, None
        if abs(gap) > PSNR_BAR_DB:
            # the gap on every frame (eager forwards), beside JAX's
            gaps = [p_screen_eager - p_parity]
            for (lr_k, _), hr_t in zip(frames[1:], hrs):
                xk = torch.from_numpy(img_util.uint2nhwc(lr_k, dr)).to(dev)
                ps = []
                for t in (screen_tier, "parity"):
                    with config.numerics_mode(t), torch.inference_mode():
                        ps.append(card_psnr(forward(xk), hr_t, dr))
                gaps.append(ps[0] - ps[1])
            if jx is not None:
                jax_mean = float(np.mean(jx["gaps_db"]))
        screened = abs(gap) <= PSNR_BAR_DB or (
            jax_mean is not None and abs(float(np.mean(gaps)) - jax_mean) <= SCREEN_JAX_BAR_DB)
        check(screened, f"{name}: parity screen, {screen_tier} misses parity by {gap:+.4f} dB")
        # the served tier, where the card's plan differs from JAX's, against
        # parity on the same image (no golden: such a tier is high)
        served_gap = p_graph - p_parity
        if screen_tier != tier:
            check(abs(served_gap) <= PSNR_BAR_DB,
                  f"{name}: served tier {tier} misses parity by {served_gap:+.4f} dB")
        rec = {"model": name, "tier": tier, "screen_tier": screen_tier, "golden_max_abs_err": err,
               "graph_ms": res["valid_runtime"][0], "eager_ms": eager_ms,
               "peak_mb": res["valid_memory"], "psnr": p_graph, "psnr_eager": p_eager,
               "psnr_parity": p_parity, "psnr_screen": p_screen, "gap_db": gap,
               "served_gap_db": served_gap,
               "jax_gap_db": None if jx is None else jx["gap_db"],
               "jax_gap_db_jax_ops": None if jx is None else jx["gap_db_jax_ops"],
               "gaps_db": gaps, "jax_gaps_db": None if jx is None else jx["gaps_db"]}
        if mid == 2:
            rec.update(nlffc_readings(forward, xl, sr, sr_parity, dr, tier, smi))
        if hr_tail or sites:
            check(conv_chain.packs == packs0, f"{name}: weights packed after the warm-up")
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
            check(abs(p_graph - rec["psnr_plain"]) <= PSNR_BAR_DB,
                  f"{name}: served PSNR off the plain-version forward's")
        if sites:
            # before and after routing, in this run: the forward's graph with
            # conv_shuffle on stock ops (ops.conv + pixel_shuffle on cuDNN),
            # then as served
            def stock_forward(v):
                with mock.patch.object(blocks, "conv_shuffle", stock_shuffle):
                    return forward(v)
            with config.numerics_mode(tier), torch.inference_mode():
                rec["graph_ms_stock_tail"], rec["graph_ms_routed"] = (
                    graph_ms(fn, xl) for fn in (stock_forward, forward))
        records.append(rec)
        print(f"   {name}: tier {tier} (the card's plan; JAX's {screen_tier}); "
              f"golden max|d| {err:.2e} (bar {2e-4 * dr:.1e}); LR {lr.shape[0]}x{lr.shape[1]} "
              f"graph {rec['graph_ms']:.3f} ms, eager {eager_ms:.3f} ms, peak "
              f"{rec['peak_mb']:.1f} MB; PSNR {p_graph:.4f} dB, eager {p_eager:.4f} dB"
              + (f"; graph A/B stock tail {rec['graph_ms_stock_tail']:.3f} ms, routed "
                 f"{rec['graph_ms_routed']:.3f} ms ({rec['graph_ms_stock_tail'] - rec['graph_ms_routed']:+.3f})"
                 if sites else "")
              + (f"; DFT share {rec['dft_share']:.1%} of the eager forward, "
                 f"{rec['softmax_maps_inf']} of {rec['softmax_maps']} softmax maps overflow"
                 if mid == 2 else ""),
              flush=True)
        jax_line = "none"
        if jx is not None:
            jax_line = f"{jx['gap_db']:+.4f} dB (JAX's own ops {jx['gap_db_jax_ops']:+.4f})"
        if gaps is not None and jax_mean is not None:
            card_mean = float(np.mean(gaps))
            jax_line += (f"; over {len(gaps)} frames card - JAX "
                         + " ".join(f"{a - b:+.4f}" for a, b in zip(gaps, jx["gaps_db"]))
                         + f", means {card_mean:+.4f} and {jax_mean:+.4f} dB: "
                         f"{card_mean - jax_mean:+.4f} (bar {SCREEN_JAX_BAR_DB})")
        print(f"   {name}: parity screen: {screen_tier} {p_screen:.4f} dB, "
              f"parity {p_parity:.4f} dB, gap "
              f"{gap:+.4f} dB (bar {PSNR_BAR_DB}); JAX's gap on the CPU {jax_line}"
              f" -> {'ok' if screened else 'FAIL'}"
              + (f"; served {tier} {p_graph:.4f} dB, gap {served_gap:+.4f} dB (bar {PSNR_BAR_DB})"
                 if screen_tier != tier else ""), flush=True)
        check(abs(p_graph - p_eager) <= PSNR_BAR_DB, f"{name}: graph PSNR off the eager forward's")
        del model, y
    shutil.rmtree(work)
    return records, r2_launches, dict(zoo_launches), failures


def nlffc_readings(forward, xl, sr_fast16, sr_parity, dr: float, tier: str, smi: str) -> dict:
    """NLFFC's extra readings in phase 8 on the LR image ``xl``: the DFT
    products' share of an eager tiled forward's device time (the profiler
    span ``spectral.dft``, ``tools/forward_trace.py``), how many of its
    global-context softmax maps overflow under ``tier`` (their f32 sum
    rounds to inf in f16, so the map is 0), the PSNR of the ``tier`` image
    ``sr_fast16`` against parity's forward of the same image (``sr_parity``), and the DFT
    products beside cuFFT (``torch.fft.rfft``/``irfft``) on one 2-tile
    chunk's global half."""
    import torch
    from ntire2022_esr_tpu_torch import config, ops
    from ntire2022_esr_tpu_torch.harness import profiling
    from ntire2022_esr_tpu_torch.ops import spectral
    from ntire2022_esr_tpu_torch.tools import forward_trace
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


def serve_phase() -> list:
    """Phase 9: ``harness.serve.main`` in-process (see the module
    docstring). Returns each run's JSON summary."""
    import contextlib
    import io
    import torch
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import envelope, graphs, registry, serve, serving, tiling
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
    header = table.splitlines()[0]
    require(all(f"| {n} |" in table for n in names), "serve --list lacks a model of the registry")
    require("TPU" not in header and "NVIDIA" in header,
            f"serve --list does not time the card's plans: {header}")

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

    # the HR tails on the card's plans: the lowest id the card plans split
    # (its body at the batch, its tail over chunks) and NASNetBN, whatever
    # its plan; each through ``serve`` as users run it, against SRServer
    split_mid = min((p.model_id for p in envelope.load_envelope().values()
                     if p.method == "split"), default=None)
    require(split_mid in HR_TAILS, f"the card plans no HR-tail model split ({split_mid})")
    warm: dict = {}
    warmup = serving.SRServer.warmup

    def warmup_then_read(self, *args, **kwargs):
        warmup(self, *args, **kwargs)
        torch.cuda.synchronize()
        warm.update(packs=conv_chain.packs, launches=total_counts())

    frames = synthetic(SERVE_HR)
    for mid in sorted({split_mid, 28}):
        plan = envelope.plan_for(mid)
        save = os.path.join(work, f"sr_{mid:02d}")
        reset_counts()
        with mock.patch.object(serving.SRServer, "warmup", warmup_then_read):
            run(["--model_id", str(mid)] + SERVE_HR, save)
        batch = min(plan.batch, len(frames))
        split = plan.method == "split"
        # the warm-up batch's and the stream's forwards, or their tail chunks
        forwards = 1 + math.ceil(len(frames) / batch)
        calls = forwards * math.ceil(batch / plan.chunk) if split else forwards
        n_tails, path = len(HR_TAILS[mid]), path_of("fast" if plan.tier in ("high", "mixed")
                                                      else plan.tier)
        got = total_counts()
        print(f"   serve {plan.name} [{plan.tier}, {plan.method}"
              f"{f'/{plan.chunk}' if split else ''}]: {got[1]} tail launches "
              f"({dict((k, v) for k, v in tail.launches_by_path.items() if v)}) over {calls} "
              f"{'tail chunks' if split else 'forwards'}, {got[1] / calls:g} each; "
              f"{warm['launches'][1]} in the warm-up; "
              f"{conv_chain.packs - warm['packs']} weight packs after it")
        require(got == (0, n_tails * calls) and tail.launches_by_path[path] == n_tails * calls,
                f"serve --model_id {mid}: not {n_tails} {path} tail launches "
                f"a {'chunk' if split else 'forward'}")
        require(conv_chain.packs == warm["packs"],
                f"serve --model_id {mid} packed weights after the warm-up")
        whole = serving.SRServer(model_id=mid, max_batch=batch, device=dev, tier=plan.tier)
        d = level_diff(np.stack(saved(save, len(frames))),
                       np.stack(list(whole.process_stream(frames))))
        print(f"   serve {plan.name} against the unsplit server (batch {batch}): max "
              f"{int(d.max())} levels, {float((d > 0).mean()):.2e} of values 1+ apart")
        require(int(d.max()) <= int(split) and float((d > 0).mean()) < 1e-3,
                f"serve --model_id {mid} too far from the unsplit server")
        del whole

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


def w8_phase(smi: str) -> dict:
    """Phase 11: the w8 int8-weight tier on the card (see the module
    docstring). Returns the kernels' launches in its served forwards, by
    the kernels line's names."""
    import torch
    from ntire2022_esr_tpu_torch import config, porter
    from ntire2022_esr_tpu_torch.harness import data, graphs, registry, runner, serving
    from ntire2022_esr_tpu_torch.ops import fused
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail
    from ntire2022_esr_tpu_torch.tools import chain_check
    from ntire2022_esr_tpu_torch.utils import image as img_util
    from ntire2022_esr_tpu_torch.utils import metrics

    dev = torch.device("cuda")
    launches: dict = {}

    # (a) both kernels against their plain versions on int8 weights: the
    # seeded f32 weights of RLFN's widths quantized by porter.quantize_array_int8
    rs = np.random.RandomState(11)

    def q_layer(cin, cout):
        w = (rs.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
        b = (rs.standard_normal(cout) * 0.1).astype(np.float32)
        q, scale = porter.quantize_array_int8(w)
        sd = porter.to_torch({"l": {"weight": q, "weight_scale": scale, "bias": b}}, device=dev)
        return sd["l.weight"], sd["l.bias"], sd["l.weight_scale"]

    with torch.inference_mode(False):  # the packed-weight cache refuses inference tensors
        chain = [q_layer(ci, co) for ci, co in zip(CHAIN_WIDTHS[:-1], CHAIN_WIDTHS[1:])]
        tw, tb, ts = q_layer(46, 48)
    ws, bs, ss = ([c[k] for c in chain] for k in range(3))
    require(all(w.dtype == torch.int8 for w in ws + [tw]), "the w8 weights are not int8")
    x_base = torch.from_numpy(np.random.RandomState(12).standard_normal(
        (8, SIZE, SIZE, 46)).astype(np.float32) * 8).to(dev).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
    for tier in W8_TIERS:
        with config.numerics_mode(tier), torch.inference_mode():
            nm = config.numerics()
            x = x_base.to(nm.activation_dtype)
            packs0 = conv_chain.packs
            out = conv_chain.fused_conv3x3_chain(x, ws, bs, scales=ss)
            again = conv_chain.fused_conv3x3_chain(x, ws, bs, scales=ss)
            tout = tail.fused_conv3x3_pixelshuffle(x, tw, tb, scale=ts)
            tail.fused_conv3x3_pixelshuffle(x, tw, tb, scale=ts)
            torch.cuda.synchronize()
            require(conv_chain.packs == packs0 + 2,
                    f"[{tier}] w8: {conv_chain.packs - packs0} packs for one chain and one tail "
                    f"called twice each (2 due)")
            require(torch.equal(out, again), f"[{tier}] w8 chain differs between two calls")
            ref = conv_chain.conv3x3_chain_plain(x, ws, bs, scales=ss)
            tref = tail.conv3x3_pixelshuffle_plain(x, tw, tb, scale=ts)
            compare("w8 chain (8, 256, 256, 46)", out, ref, tier)
            compare("w8 tail (8, 256, 256, 46) -> 48 r=4", tout, tref, tier)
            deq = conv_chain.dequantized(ws, ss, nm.compute_dtype)
            tdeq = conv_chain.dequantized([tw], [ts], nm.compute_dtype)[0]
            if tier in F32_TIERS:
                f64_check(f"w8 chain [{tier}]", out, ref, chain_f64(x, deq, bs))
                f64_check(f"w8 tail [{tier}]", tout, tref, tail_f64(x, tdeq, tb))
            else:
                two = tier in TWO_BYTE_TIERS
                flip_check("w8 chain", "chain", out, ref, tier,
                           chain_check.one_rounding("chain", deq, bs)(x) if two else None)
                flip_check("w8 tail", "tail", tout, tref, tier,
                           chain_check.one_rounding("tail", [tdeq], [tb])(x) if two else None)
            del x, out, again, tout, ref, tref
    # no fallback: an int8 weight without its scale raises on the card too
    with config.numerics_mode("fasthi16"), torch.inference_mode():
        try:
            conv_chain.fused_conv3x3_chain(x_base[:1].half(), ws, bs)
            require(False, "an int8 chain without its scales ran on the card")
        except TypeError as e:
            print(f"   int8 weights without scales refused on the card: {e}")
    del x_base
    end_phase_checks("phase 11 (a)")

    # (b) SRServer(model_id=4) under w8 at fasthi16, against the f32 server
    frames = list(np.random.RandomState(13).randint(0, 256, (W8_FRAMES, SIZE, SIZE, 3),
                                                    dtype=np.uint8))
    served = {}
    for w8 in (False, True):
        tag = "w8" if w8 else "f32"
        config.set_weights_int8(w8)
        try:
            srv = serving.SRServer(model_id=4, max_batch=SERVE_BATCH, device=dev)
        finally:
            config.set_weights_int8(False)
        model = srv._model
        require((model.B1.c1_r.weight.dtype == torch.int8) == w8
                and (getattr(model.B1.c1_r, "weight_scale", None) is not None) == w8,
                f"the {tag} server's RLFN holds {model.B1.c1_r.weight.dtype} weights")
        keys0 = set(conv_chain._cache)
        srv.warmup((SIZE, SIZE))
        torch.cuda.synchronize()
        pack_bytes = sum(t.numel() * t.element_size() for k in set(conv_chain._cache) - keys0
                         for t in conv_chain._cache[k][0])
        model_bytes = sum(t.numel() * t.element_size()
                          for t in list(model.parameters()) + list(model.buffers()))
        reset_counts()
        packs0 = conv_chain.packs
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = np.stack(list(srv.process_stream(frames)))
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        fwd = W8_FRAMES // SERVE_BATCH
        got = path_counts("f16")
        print(f"   SRServer(4) {tag} [{srv.tier}]: {W8_FRAMES} frames in {secs:.3f} s, "
              f"{W8_FRAMES / secs:.1f} images/s (host clock, batch {SERVE_BATCH}); "
              f"max_memory_allocated {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} over "
              f"the {base / 2**20:.1f} MiB resident before the stream); model tensors "
              f"{model_bytes} bytes, its packs {pack_bytes} bytes; launches {got[0]} chain, "
              f"{got[1]} tail on the f16 path over {fwd} forwards; packs in the stream "
              f"{conv_chain.packs - packs0}; on {smi}", flush=True)
        require(srv.tier == "fasthi16" and got == (4 * fwd, fwd) and total_counts() == got,
                f"{tag}: not 4 chain and 1 tail launches on the f16 path a forward")
        require(conv_chain.packs == packs0, f"{tag}: the stream packed weights again")
        served[tag] = outs
        if w8:
            launches = {"conv3x3_chain": got[0], "conv3x3_pixelshuffle": got[1]}
            ref = np.concatenate([serving.u8_out(plain_forward(model, serving.u8_in(
                torch.from_numpy(np.stack(frames[i:i + SERVE_BATCH])).to(dev), 255.0), srv.tier),
                255.0).cpu().numpy() for i in range(0, W8_FRAMES, SERVE_BATCH)])
            d = level_diff(outs, ref)
            print(f"   w8 served vs the plain w8 forward on the card: max {int(d.max())} levels, "
                  f"{float((d > 0).mean()):.2e} of values 1+ apart, {float((d > 1).mean()):.2e} "
                  f"2+ apart (phase 5's bar: under 1e-4 2+ apart, under 0.2 1+)")
            require(float((d > 1).mean()) < 1e-4 and float((d > 0).mean()) < 0.2,
                    "the w8 server is too far from its plain forward")
        del srv, model
        torch.cuda.empty_cache()
    mse = float(np.mean((served["w8"].astype(np.float64) - served["f32"]) ** 2))
    db = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
    print(f"   w8 against f32 server output: {db:.2f} dB (floor {W8_PSNR_FLOOR_DB} dB, the JAX "
          f"package's), max {int(level_diff(served['w8'], served['f32']).max())} levels")
    require(db >= W8_PSNR_FLOOR_DB, f"w8 server only {db:.2f} dB from the f32 one")

    # (c) NASNetBN under w8 at high: its HR tail's x2 upsamplers on int8
    # weights through the tail kernel, in the graph-timed runner
    work = os.path.join(HERE, "build", "w8_smoke")
    shutil.rmtree(work, ignore_errors=True)
    (lr_path, hr_path), = data.write_synthetic_div2k(os.path.join(work, "div2k"),
                                                     [PROTOCOL_VALID[0]], seed=1)
    lr = img_util.imread_uint(lr_path)
    hr = img_util.modcrop(img_util.imread_uint(hr_path), 4)
    logger = logging.getLogger("chip_smoke_w8")
    logger.propagate = False
    logger.addHandler(logging.NullHandler())
    config.set_weights_int8(True)
    try:
        model, name, dr, tile = registry.build_model(W8_HR_TAIL, device=dev)
    finally:
        config.set_weights_int8(False)
    require(model.upconv1.weight.dtype == torch.int8, f"{name}: not int8 under w8")
    xl = torch.from_numpy(img_util.uint2nhwc(lr, dr)).to(dev)
    with config.numerics_mode("high"):
        with torch.inference_mode():
            model(xl)  # the first forward packs the tail's weights
        packs0 = conv_chain.packs
        reset_counts()
        graphs0 = graphs.captures
        res = runner.run(model, name, dr, tile, logger,
                         types.SimpleNamespace(save_dir=os.path.join(work, "sr"), ssim=False),
                         mode="valid", pairs=[(lr_path, hr_path)])
        forwards = 2 * (graphs.captures - graphs0)
        path = path_of("fast")
        by_path = {k: v for k, v in tail.launches_by_path.items() if v}
        launches["conv3x3_pixelshuffle_bf16x1_r2_32to128"] = tail.launches_by_shape.get(
            (path, 32, 128, 2), 0)
        with torch.inference_mode():
            sr = img_util.nhwc2uint(model(xl).float().cpu().numpy(), dr)
        torch.cuda.synchronize()
    p_graph, p_eager = res["valid_psnr"][0], metrics.calculate_psnr(sr, hr, border=4)
    print(f"   {name} w8 [high, tail bf16]: tail launches {by_path} over {forwards} captured "
          f"forwards, {total_counts()[0]} chain; packs after the first forward "
          f"{conv_chain.packs - packs0}; graph {res['valid_runtime'][0]:.3f} ms, peak "
          f"{res['valid_memory']:.1f} MB; PSNR graph {p_graph:.4f} dB, eager {p_eager:.4f} dB; "
          f"on {smi}", flush=True)
    require(by_path == {path: 2 * forwards} and total_counts()[0] == 0,
            f"{name} w8: not 2 {path} tail launches a captured forward")
    require(conv_chain.packs == packs0, f"{name} w8: weights packed after the first forward")
    require(abs(p_graph - p_eager) <= PSNR_BAR_DB, f"{name} w8: graph PSNR off the eager one")
    with mock.patch.object(fused, "fused_conv3x3_pixelshuffle", tail.conv3x3_pixelshuffle_plain), \
            config.numerics_mode("high"), torch.inference_mode():
        p_plain = metrics.calculate_psnr(img_util.nhwc2uint(model(xl).float().cpu().numpy(), dr),
                                         hr, border=4)
    f32 = registry.build_model(W8_HR_TAIL, device=dev)[0]
    with config.numerics_mode("high"), torch.inference_mode():
        p_f32 = metrics.calculate_psnr(img_util.nhwc2uint(f32(xl).float().cpu().numpy(), dr),
                                       hr, border=4)
    print(f"   {name} w8: PSNR on the plain versions {p_plain:.4f} dB; f32 weights {p_f32:.4f} dB")
    require(abs(p_graph - p_plain) <= PSNR_BAR_DB, f"{name} w8: served PSNR off the plain one")
    del model, f32

    # (d) the protocol CLI in a process of its own with NTIRE_W8=1, beside
    # one without it, on phase 7's six synthetic valid pairs (seed 0)
    data_dir = os.path.join(work, "protocol")
    data.write_synthetic_div2k(data_dir, PROTOCOL_VALID, PROTOCOL_TEST, seed=0)
    torch.cuda.empty_cache()  # the CLI's processes share the card with this one
    spy = ("import runpy, sys\n"
           "from ntire2022_esr_tpu_torch.harness import registry\n"
           "build = registry.build_model\n"
           "def spy(*a, **k):\n"
           "    out = build(*a, **k)\n"
           "    print('B1.c1_r.weight', out[0].B1.c1_r.weight.dtype, flush=True)\n"
           "    return out\n"
           "registry.build_model = spy\n"
           "sys.argv = ['ntire2022_esr_tpu_torch.harness.cli'] + sys.argv[1:]\n"
           "runpy.run_module('ntire2022_esr_tpu_torch.harness.cli', run_name='__main__')\n")
    psnr = {}
    for tag, w8 in (("f32", "0"), ("w8", "1")):
        run_dir = os.path.join(work, f"cli_{tag}")
        os.makedirs(run_dir)
        env = dict(os.environ, NTIRE_W8=w8, PYTHONPATH=HERE)
        tc = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", spy, "--model_id", "4", "--data_dir",
                               data_dir, "--save_dir", os.path.join(run_dir, "sr")],
                              cwd=run_dir, env=env, capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0, f"the {tag} CLI failed: {proc.stderr[-2000:]}")
        dtype = [ln for ln in proc.stdout.splitlines() if ln.startswith("B1.c1_r.weight")]
        want = "torch.int8" if w8 == "1" else "torch.float32"
        require(dtype == [f"B1.c1_r.weight {want}"], f"the {tag} CLI's model held {dtype}")
        with open(os.path.join(run_dir, "results.json")) as fh:
            e = json.load(fh)["04_RLFN"]
        psnr[tag] = e["valid_psnr"]
        print(f"   harness.cli NTIRE_W8={w8}: {dtype[0]}; {len(e['valid_psnr'])} images, ave "
              f"runtime {e['valid_ave_runtime']:.3f} ms, memory {e['valid_memory']:.1f} MB, "
              f"PSNR {e['valid_ave_psnr']:.4f} dB, #Params {e['num_parameters']:.6f} M "
              f"(run {time.perf_counter() - tc:.1f} s)", flush=True)
    for i, (a, b) in enumerate(zip(psnr["f32"], psnr["w8"])):
        print(f"   image {i} (LR {PROTOCOL_VALID[i][0]}x{PROTOCOL_VALID[i][1]}): PSNR f32 {a:.4f} "
              f"dB, w8 {b:.4f} dB ({b - a:+.4f})")
    require(len(psnr["w8"]) == len(PROTOCOL_VALID) and all(map(math.isfinite, psnr["w8"])),
            "the w8 CLI did not score every image")
    shutil.rmtree(work)
    return launches


def _lib_state(rs, layers: dict) -> dict:
    """Seeded torch-layout tensors for ``layers``: prefix -> ("conv", cin,
    cout, k), ("convT", cin, cout, k), ("bn", c) or ("in", c). Weights are
    normal over the square root of the fan-in, so the blocks keep their
    activations near the input's scale."""
    import torch

    sd = {}
    for prefix, (kind, *dims) in layers.items():
        p = f"{prefix}." if prefix else ""
        if kind in ("conv", "convT"):
            cin, cout, k = dims
            shape = (cout, cin, k, k) if kind == "conv" else (cin, cout, k, k)
            sd[p + "weight"] = rs.standard_normal(shape) / math.sqrt(cin * k * k)
            sd[p + "bias"] = rs.standard_normal(cout) * 0.01
        else:
            (c,) = dims
            sd[p + "weight"] = rs.uniform(0.5, 1.5, c)
            sd[p + "bias"] = rs.standard_normal(c) * 0.1
            if kind == "bn":
                sd[p + "running_mean"] = rs.standard_normal(c) * 0.1
                sd[p + "running_var"] = rs.uniform(0.5, 1.5, c)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


def library_blocks(rs) -> list:
    """(tag, module on the CPU with seeded weights, input channels) of each
    library block phase 12 runs, at KAIR basicblock.py's default widths."""
    from ntire2022_esr_tpu_torch.models import blocks

    def rcab(prefix=""):
        p = f"{prefix}." if prefix else ""
        return {p + "res.0": ("conv", 64, 64, 3), p + "res.2": ("conv", 64, 64, 3),
                p + "ca.conv_fc.0": ("conv", 64, 4, 1), p + "ca.conv_fc.2": ("conv", 4, 64, 1)}

    def rdb(prefix=""):
        p = f"{prefix}." if prefix else ""
        out = {f"{p}conv{i + 1}.0": ("conv", 64 + 32 * i, 32, 3) for i in range(4)}
        out[p + "conv5"] = ("conv", 192, 64, 3)
        return out

    group = {k: v for i in range(12) for k, v in rcab(f"rg.{i}").items()}
    group["rg.12"] = ("conv", 64, 64, 3)
    cfrb = {f"conv{i}_d": ("conv", 50, 25, 1) for i in (1, 2, 3)}
    cfrb.update({f"conv{i}_r": ("conv", 50, 50, 3) for i in (1, 2, 3)})
    cfrb.update({"conv4_d": ("conv", 50, 25, 3), "conv1x1": ("conv", 100, 50, 1),
                 "esa.conv1": ("conv", 50, 12, 1), "esa.conv21": ("conv", 12, 12, 1),
                 "esa.conv6": ("conv", 12, 50, 1)})
    cfrb.update({f"esa.conv{i}": ("conv", 12, 12, 3) for i in (2, 3, 4, 5)})
    conv64 = {"1": ("conv", 64, 64, 3)}
    table = [
        ("res_block CRC", blocks.ResBlock("CRC"), 64,
         {"res.0": ("conv", 64, 64, 3), "res.2": ("conv", 64, 64, 3)}),
        ("rcab", blocks.RCABlock("CRC"), 64, rcab()),
        ("rca_group", blocks.RCAGroup(nb=12), 64, group),
        ("residual_dense_block_5c", blocks.ResidualDenseBlock_5C(), 64, rdb()),
        ("rrdb", blocks.RRDB(), 64, {k: v for n in ("RDB1", "RDB2", "RDB3")
                                     for k, v in rdb(n).items()}),
        ("cfrb", blocks.CFRB(), 50, cfrb),
        ("non_local_block_2d", blocks.NonLocalBlock2D("B"), 64,
         {"theta": ("conv", 64, 32, 1), "phi": ("conv", 64, 32, 1), "g": ("conv", 64, 32, 1),
          "W.0": ("conv", 32, 64, 1), "W.1": ("bn", 64)}),
        ("upsample_pixelshuffle 2R", blocks.Resampler("pixelshuffle", "2R"), 64,
         {"0": ("conv", 64, 256, 3)}),
        ("upsample_pixelshuffle 4", blocks.Resampler("pixelshuffle", "4"), 64,
         {"0": ("conv", 64, 48, 3)}),
        ("upsample_upconv 2R", blocks.Resampler("upconv", "2R"), 64, conv64),
        ("upsample_convtranspose 2R", blocks.Resampler("convtranspose", "2R"), 64,
         {"0": ("convT", 64, 64, 2)}),
        ("downsample_strideconv 2R", blocks.Resampler("strideconv", "2R"), 64,
         {"0": ("conv", 64, 64, 2)}),
        ("downsample_maxpool 2R", blocks.Resampler("maxpool", "2R"), 64, conv64),
        ("downsample_avgpool 2R", blocks.Resampler("avgpool", "2R"), 64, conv64),
        ("mode_conv CIL", blocks.ModeConv("CIL"), 64,
         {"0": ("conv", 64, 64, 3), "1": ("in", 64)}),
        ("mode_conv CBR", blocks.ModeConv("CBR"), 64,
         {"0": ("conv", 64, 64, 3), "1": ("bn", 64)}),
    ]
    out = []
    for tag, module, cin, layers in table:
        module.load_state_dict(_lib_state(rs, layers), strict=True)
        out.append((tag, module.eval(), cin))
    return out


def library_phase(smi: str) -> dict:
    """Phase 12: the reference library, ``imresize_matlab`` and the
    torch-checkpoint path on the card (see the module docstring). Returns
    the tail's launches in the library's pixel-shuffle upsamplers, by the
    kernels line's names."""
    import copy
    import tempfile

    import torch
    from ntire2022_esr_tpu_torch import config, porter
    from ntire2022_esr_tpu_torch.harness import envelope, graphs, profiling, registry, serving
    from ntire2022_esr_tpu_torch.models import blocks
    from ntire2022_esr_tpu_torch.ops import resize
    from ntire2022_esr_tpu_torch.ops.kernels import tail
    from ntire2022_esr_tpu_torch.tools import chain_check

    dev = torch.device("cuda")
    rs = np.random.RandomState(12)
    lib = library_blocks(rs)
    on_card = {tag: copy.deepcopy(m).to(dev) for tag, m, _ in lib}

    # (a) every block on the card against the CPU under parity; the
    # upsamplers' tail launches counted over this run alone
    inputs = {tag: torch.from_numpy(rs.rand(1, cin, LIB_HW, LIB_HW).astype(np.float32))
              .contiguous(memory_format=torch.channels_last) for tag, _, cin in lib}
    with config.numerics_mode("parity"), torch.inference_mode():
        reset_counts()
        outs = {tag: on_card[tag](inputs[tag].to(dev)) for tag, _, _ in lib}
        torch.cuda.synchronize()
        chain_n, tail_n = total_counts()
        shapes = dict(tail.launches_by_shape)
        for tag, m, _ in lib:
            ref = m(inputs[tag])
            got = outs[tag].cpu()
            require(got.shape == ref.shape, f"{tag}: {tuple(got.shape)} vs {tuple(ref.shape)}")
            err = float((got - ref).abs().max())
            print(f"   {tag}: card vs CPU max|d| {err:.3e} (max|ref| "
                  f"{float(ref.abs().max()):.3f}; bar {LIB_BAR:.0e}) -> "
                  f"{'ok' if err <= LIB_BAR else 'FAIL'}", flush=True)
            require(err <= LIB_BAR, f"{tag} on the card is {err:.3e} from the CPU")
    print(f"   parity run: chain launches {chain_n}, tail launches {tail_n} {shapes}")
    want = {("tf32x3", 64, 256, 2): 1, ("tf32x3", 64, 48, 4): 1}
    require(chain_n == 0 and shapes == want,
            f"the library's parity run launched chain {chain_n}, tail {shapes}; want {want}")
    del outs

    # (b) the upsamplers under each tier: their launches by path, then the
    # library's kernel calls (blocks.conv_shuffle) held to the plain version
    launches = {}
    x64 = torch.from_numpy(rs.rand(4, 64, LIB_HW, LIB_HW).astype(np.float32) * 8).to(dev)
    x64 = x64.contiguous(memory_format=torch.channels_last)
    ups = [(on_card[tag], r) for tag, r in (("upsample_pixelshuffle 2R", 2),
                                             ("upsample_pixelshuffle 4", 4))]
    for tier in LIB_TIERS:
        with config.numerics_mode(tier), torch.inference_mode():
            x = x64.to(config.numerics().activation_dtype)
            reset_counts()
            for up, _ in ups:
                up(x)
            torch.cuda.synchronize()
            p = path_of(tier)
            chain_n, tail_n = total_counts()
            require(chain_n == 0 and tail.launches_by_path[p] == tail_n == 2,
                    f"[{tier}] the upsamplers launched chain {chain_n}, tail "
                    f"{dict(tail.launches_by_path)}; want 2 on {p}")
            launches[entry_of("conv3x3_pixelshuffle", tier)] = tail_n
            for up, r in ups:
                layer = up._modules["0"]
                w, b = layer.weight, layer.bias
                out = blocks.conv_shuffle(layer, x, r)
                ref = tail.conv3x3_pixelshuffle_plain(x, w, b, r=r)
                torch.cuda.synchronize()
                tag = f"library tail 64 -> {w.shape[0]} r={r}"
                compare(tag, out, ref, tier)
                if tier == "parity":
                    f64_check(f"{tag} [{tier}]", out, ref, tail_f64(x, w, b, r))
                else:
                    one = (chain_check.one_rounding("tail", [w], [b], r=r)(x)
                           if tier in TWO_BYTE_TIERS else None)
                    tail_flip_check(tag, out, ref, x, w, b, tier, one, r)
                del out, ref
            # the goldens' width, cin = 8, at an odd size and at 64 x 64
            for cin, cout, r in LIB_NARROW:
                for shape in ((2, 12, 10, cin), (1, 64, 64, cin)):
                    xs, w, b = random_tail(shape, cout, r, seed=cin + r,
                                           dtype=config.numerics().activation_dtype)
                    out = tail.fused_conv3x3_pixelshuffle(xs, w, b, r=r)
                    ref = tail.conv3x3_pixelshuffle_plain(xs, w, b, r=r)
                    torch.cuda.synchronize()
                    compare(f"tail {shape} -> {cout * r * r} r={r}", out, ref, tier)
                    if tier == "parity":
                        f64_check(f"tail {shape} -> {cout * r * r} r={r} [{tier}]", out, ref,
                                  tail_f64(xs, w, b, r))
                    del out, ref
    end_phase_checks("phase 12 (b)")
    print("   library tail launches by path: " + json.dumps(launches), flush=True)

    # (c) four blocks under a CUDA graph at LIB_TIME_HW, batch 1, parity; the
    # upsamplers beside ops.conv + ops.pixel_shuffle (cuDNN f32, TF32 off)
    with config.numerics_mode("parity"), torch.inference_mode():
        for tag in LIB_TIMED:
            m = on_card[tag]
            x = torch.from_numpy(rs.rand(1, 64, LIB_TIME_HW, LIB_TIME_HW).astype(np.float32))
            x = x.to(dev).contiguous(memory_format=torch.channels_last)
            g = graphs.GraphedForward(m, dev)
            g.prepare(x)
            ms = profiling.device_timer(lambda _: g.replay(), x, iters=20, warmup=3)[0] * 1e3
            line = f"   {tag} at 1x64x{LIB_TIME_HW}x{LIB_TIME_HW} (parity, graph): {ms:.3f} ms"
            if tag.startswith("upsample"):
                layer, mode = m._modules["0"], m.factory_mode

                def stock(v, layer=layer, mode=mode):
                    y = blocks.ops.pixel_shuffle(blocks.ops.conv(layer, v), int(mode[0]))
                    return blocks.mode_conv(None, y, mode[1:]) if mode[1:] else y
                gs = graphs.GraphedForward(stock, dev)
                gs.prepare(x)
                lib_ms = profiling.device_timer(lambda _: gs.replay(), x, iters=20,
                                                warmup=3)[0] * 1e3
                line += f"; ops.conv + pixel_shuffle (cuDNN f32) {lib_ms:.3f} ms"
                del gs
            print(line + f"; on {smi}", flush=True)
            del g

    # (d) imresize_matlab on the card against the numpy form, x1/4
    hr = np.random.RandomState(13).rand(*RESIZE_HR, 3).astype(np.float32)
    th = time.perf_counter()
    want = resize.imresize_matlab_np(hr, 0.25)
    host_s = time.perf_counter() - th
    xt = torch.from_numpy(hr).to(dev)
    got = resize.imresize_matlab(xt, 0.25)
    err = float(np.abs(got.cpu().numpy() - want).max())
    ms = profiling.device_timer(lambda v: resize.imresize_matlab(v, 0.25), xt, iters=10,
                                warmup=2)[0] * 1e3
    print(f"   imresize_matlab {RESIZE_HR[1]}x{RESIZE_HR[0]} -> {want.shape[1]}x{want.shape[0]}: "
          f"card {ms:.3f} ms, numpy f64 on the host {host_s:.2f} s; max|d| {err:.3e} "
          f"(bar {RESIZE_BAR:.0e}) -> {'ok' if err <= RESIZE_BAR else 'FAIL'}; on {smi}", flush=True)
    require(tuple(got.shape) == want.shape and err <= RESIZE_BAR,
            f"imresize_matlab on the card is {err:.3e} from the numpy form")

    # (e) the checkpoint path: .pth files made from the shipped npz, built
    # through registry.build_model on the card from an empty cache
    root = os.path.join(HERE, "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="library_smoke_", dir=root)
    try:
        zoo, cache = os.path.join(tmp, "zoo"), os.path.join(tmp, "cache")
        os.makedirs(zoo)
        frames = np.random.RandomState(14).randint(0, 256, (4, 64, 64, 3)).astype(np.uint8)
        for mid in CKPT_IDS:
            spec = registry.get_spec(mid)
            sd = porter.reference_state_dict(registry.load_params(spec),
                                             linear_keys=spec.linear_keys)
            if spec.linear_keys:  # a wrapped, DataParallel-prefixed file
                sd = {"params": {"module." + k: v for k, v in sd.items()}, "iter": 1}
            torch.save(sd, os.path.join(zoo, spec.ckpt))
            tc = time.perf_counter()
            model, name, dr, _ = registry.build_model(mid, weights_dir=cache, zoo_dir=zoo,
                                                      device=dev)
            build_s = time.perf_counter() - tc
            with np.load(registry.weights_path(spec, cache)) as got_z, \
                    np.load(registry.weights_path(spec)) as want_z:
                require(sorted(got_z.files) == sorted(want_z.files),
                        f"{name}: the written npz has other keys")
                for k in want_z.files:
                    require(got_z[k].dtype == want_z[k].dtype
                            and np.array_equal(got_z[k], want_z[k]),
                            f"{name}: {k} differs from the shipped npz")
                nkeys = len(want_z.files)
            tier = serving.gated_tier(name, envelope.TPU_PATH)
            served = np.stack(list(serving.SRServer(
                model=model, data_range=dr, device=dev, tier=tier,
                max_batch=4).process_stream(list(frames))))
            shipped = np.stack(list(serving.SRServer(
                model_id=mid, device=dev, tier=tier, max_batch=4).process_stream(list(frames))))
            same = np.array_equal(served, shipped)
            print(f"   {name} from {spec.ckpt}: npz written in {build_s:.2f} s, {nkeys} keys equal "
                  f"to the shipped cache in dtype and value; served at {tier} on 4 frames "
                  f"{served.shape}: {'equal' if same else 'DIFFERENT'}", flush=True)
            require(same, f"{name} from the .pth serves other uint8 values")
            del model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def plans_phase(smi: str) -> dict:
    """Phase 13: the card's envelope rebuilt from its committed rows, and
    three models' candidates re-timed beside them (see the module
    docstring). Returns the readings."""
    import re

    from ntire2022_esr_tpu_torch.harness import envelope, registry
    from ntire2022_esr_tpu_torch.tools import make_gated_envelope as mge
    from ntire2022_esr_tpu_torch.tools import sweep_zoo_sustained as sweep

    with open(mge.ROWS_PATH) as fh:
        rows = json.load(fh)
    with open(envelope.DEFAULT_PATH) as fh:
        committed = json.load(fh)
    devices = sorted({str(r.get("device")) for r in rows.values()})
    print(f"   {len(rows)} committed rows, measured on {devices}; this card: {smi}")
    require(len(devices) == 1 and re.fullmatch(r"NVIDIA .+, [0-9.]+ W", devices[0]) is not None,
            f"the committed rows do not name one NVIDIA card and its power limit: {devices}")
    rebuilt = mge.build()
    require(rebuilt == committed, "the committed rows do not rebuild the committed envelope")
    print(f"   the envelope rebuilt from them equals {os.path.relpath(envelope.DEFAULT_PATH, HERE)}"
          f" ({len(rebuilt)} plans)")
    card, tpu = envelope.load_envelope(), envelope.load_envelope(envelope.TPU_PATH)
    flips = sorted((p.model_id, p.name) for p in card.values() if p.tier != tpu[p.name].tier)
    print(f"   card tier != JAX's envelope's: "
          + (", ".join(f"{n} {tpu[n].tier}->{card[n].tier}" for _, n in flips) or "none"))
    mid, tiers = PLAN_FLIP_DEFAULT
    if flips:
        mid = flips[0][0]
        name = registry.get_spec(mid).name
        tiers = (tpu[name].tier, card[name].tier)

    def committed_row(mid: int, mode: str, method=None) -> dict:
        """The fastest committed row of a model at a tier (and method)."""
        name = registry.get_spec(mid).name
        cands = [r for k, r in rows.items() if k.split("|")[0] == name and r["mode"] == mode
                 and (method is None or r["method"] == method)]
        require(bool(cands), f"no committed row for {name} at {mode} {method or ''}")
        return min(cands, key=lambda r: r["ms_per_image_sustained"])

    pairs = [(4, [committed_row(4, t, "chain") for t in ("fasthi16", "high")]),
             (mid, [committed_row(mid, t) for t in tiers]),
             (28, [committed_row(28, "high", m) for m in ("split", "chain")])]
    work = os.path.join(HERE, "build", "plans_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    readings = []
    try:
        for mid, pair in pairs:
            name = registry.get_spec(mid).name
            got = []
            for row in pair:
                out = sweep.sweep([mid], row["mode"], row["method"],
                                  os.path.join(work, f"{mid}.json"), size=row["size"],
                                  batch=row["batch"], device="cuda", **PLAN_RETIME)
                new = out[sweep.row_key(name, row["mode"], row["method"])]
                got.append(new["ms_per_image_sustained"])
                print(f"   {name} [{row['mode']}, {row['method']}, batch {new['batch']}]: "
                      f"{got[-1]:.4f} ms an image now ({PLAN_RETIME['reps']} reps), committed "
                      f"{row['ms_per_image_sustained']:.4f} ({row['reps']} reps, "
                      f"{row['device']}); on {smi}", flush=True)
            was = [r["ms_per_image_sustained"] for r in pair]
            gap = max(was) / min(was) - 1
            kept = (got[0] < got[1]) == (was[0] < was[1])
            print(f"   {name}: committed {pair[0]['mode']}/{pair[0]['method']} : "
                  f"{pair[1]['mode']}/{pair[1]['method']} = {was[0] / was[1]:.3f}, now "
                  f"{got[0] / got[1]:.3f}; {'order kept' if kept else 'order NOT kept'} (held "
                  f"where the committed pair is more than {PLAN_ORDER_GAP:.0%} apart: "
                  f"{gap:.1%})", flush=True)
            require(gap <= PLAN_ORDER_GAP or kept,
                    f"{name}: the re-timed pair is in another order than the committed rows")
            readings.append({"model": name, "rows": [
                {"mode": r["mode"], "method": r["method"], "batch": r["batch"],
                 "committed_ms": r["ms_per_image_sustained"], "ms": g}
                for r, g in zip(pair, got)], "committed_gap": gap, "order_kept": kept})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"plans": readings, "tier_flips": [n for _, n in flips]}


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
        from ntire2022_esr_tpu_torch import config, ops
        from ntire2022_esr_tpu_torch.harness import envelope, graphs, profiling, registry, serving
        from ntire2022_esr_tpu_torch.ops import fused
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
        fn = ""
        for line in log.splitlines():
            if "Function properties for " in line:
                fn = line.split("Function properties for ")[1].strip()
            # C7519: ptxas fences registers before an MMA (informational)
            if "C7519" not in line and ("registers" in line or "spill" in line
                                        or "error" in line.lower()):
                print(f"   [{name}] {fn[:60]} {line.strip()}")
    print(f"   built {sorted(logs)} in {build_s:.1f} s (parallel nvcc)")
    # no wgmma serialized by ptxas (C7510-C7520 but C7519 say why: every
    # MMA then waits for the last), and HGMMA (warpgroup MMA) instructions
    # in every instantiation of the wgmma kernels (WGMMA_KERNELS)
    serialized = [line.strip() for log in logs.values() for line in log.splitlines()
                  if "serialized" in line]
    for line in serialized:
        print(f"   {line[:200]}")
    require(not serialized, "ptxas serialized the wgmma instructions of a kernel")
    for lib, kname, inst in WGMMA_KERNELS:
        counts, first = chain_check.hgmma_counts(lib)
        mine = {fn: c for fn, c in counts.items() if kname in fn}
        print(f"   HGMMA in {kname}: {sorted(mine.values())} over {len(mine)} instantiations "
              f"(first: {first})")
        require(len(mine) == inst and all(mine.values()), f"{kname} has no HGMMA")
    # the tail's library holds the three one-group kernels and nothing
    # else: no tail launch can reach another (an mma.sync kernel in channel
    # groups)
    tail_fns = chain_check.hgmma_counts("tail")[0]
    others = [fn for fn in tail_fns if not any(
        k in fn for _, k, _ in WGMMA_KERNELS if k.startswith("conv3x3_pixelshuffle"))]
    require(not others, f"the tail's library holds other kernels: {others}")
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
                before = dict(conv_chain.launches_by_kernel)
                out = conv_chain.fused_conv3x3_chain(x, ws, bs, slope=0.05, residual=True)
                served_chain(conv_chain, before, f"chain {shape}", tier, CHAIN_WIDTHS)
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
            for shape, chans, tiers in chain_check.CHAIN_WIDTHS:
                if tiers is None or tier in tiers:
                    cases.append((f"{shape} {list(chans)}",
                                  *random_chain(shape, chans, seed=6, dtype=dt), True))
            for tag, x, ws, bs, residual in cases:
                before = dict(conv_chain.launches_by_kernel)
                out = conv_chain.fused_conv3x3_chain(x, ws, bs, slope=0.05, residual=residual)
                served_chain(conv_chain, before, f"chain {tag}", tier,
                             [x.shape[1]] + [int(w.shape[0]) for w in ws])
                ref = conv_chain.conv3x3_chain_plain(x, ws, bs, slope=0.05, residual=residual)
                torch.cuda.synchronize()
                compare(f"chain {tag}", out, ref, tier)
                if tier in TWO_BYTE_TIERS:
                    # the wgmma kernel's sums against the plain version's
                    # order at every width, settled as the tail's are
                    one = chain_check.one_rounding("chain", ws, bs, residual=residual)(x)
                    order_check(f"chain {tag}", "chain", out, ref, tier, one,
                                lambda: chain_check.exact_chain_two_byte(
                                    x, ws, bs, 0.05, residual, dt),
                                lambda: chain_check.padded_chain_plain(x, ws, bs, 0.05, residual))
                    del one
    print(f"   chain launches by kernel so far: {conv_chain.launches_by_kernel}")
    end_phase_checks("phase 2")
    print(f"   phase 2: {time.perf_counter() - t0:.1f} s")

    # 3. tail kernel vs plain ----------------------------------------------
    t0 = phase("3. conv3x3_pixelshuffle kernels vs plain")
    for tier in ("parity", "high", "mixed", "fasthi16", "fasthi", "fast", "fast16"):
        with config.numerics_mode(tier), torch.inference_mode():
            dt = config.numerics().activation_dtype
            for shape in ((8, SIZE, SIZE, 46), (2, 63, 41, 46)):
                x, w, b = tail_args(model, shape, dt, seed=2)
                before = dict(tail.launches_by_kernel)
                out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=4)
                served_tail(tail, before, f"tail {shape}", tier, 46, 48, 4)
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
                before = dict(tail.launches_by_kernel)
                out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=r)
                ref = tail.conv3x3_pixelshuffle_plain(x, w, b, r=r)
                torch.cuda.synchronize()
                tag = f"tail {shape} -> {cout * r * r} r={r}{'' if bias else ' no bias'}"
                served_tail(tail, before, tag, tier, shape[3], cout * r * r, r)
                compare(tag, out, ref, tier)
                if tier == "parity" and shape[3] in (40, 42, 50, 64):  # the zoo's upsamplers
                    f64_ratios[f"{tag} [{tier}]"] = f64_check(f"{tag} [{tier}]", out, ref,
                                                              tail_f64(x, w, b, r))
    # the zoo's x4 upsamplers (ZOO_R4_WIDTHS) at one LR frame of phase 8's
    # size, with RLFN's tail's checks: f64 under parity, the flip bars (the
    # f64 sum where cuDNN sums in another order) and the one-rounding control
    zoo_in = {}
    for cin, cout in ZOO_R4_WIDTHS:  # the input drawn on the card, the weights by numpy
        _, w, b = random_tail((1, 8, 8, cin), cout, 4, seed=11)
        gen = torch.Generator(device=dev).manual_seed(11)
        x = torch.randn((1, cin, *PROTOCOL_VALID[0]), generator=gen, device=dev) * 8
        zoo_in[(cin, cout)] = (x.contiguous(memory_format=torch.channels_last), w, b)
    for tier in ("fasthi16", "parity", "fasthi", "fast", "fast16"):
        with config.numerics_mode(tier), torch.inference_mode():
            dt = config.numerics().activation_dtype
            for (cin, cout), (x, w, b) in zoo_in.items():
                x = x.to(dt)
                before = dict(tail.launches_by_kernel)
                out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=4)
                ref = tail.conv3x3_pixelshuffle_plain(x, w, b, r=4)
                torch.cuda.synchronize()
                tag = f"tail {tuple(x.shape[2:])} {cin} -> {16 * cout} r=4"
                served_tail(tail, before, tag, tier, cin, 16 * cout, 4)
                compare(tag, out, ref, tier)
                if tier == "parity":
                    f64_ratios[f"{tag} [{tier}]"] = f64_check(f"{tag} [{tier}]", out, ref,
                                                              tail_f64(x, w, b, 4))
                else:
                    one = (chain_check.one_rounding("tail", [w], [b], r=4)(x)
                           if tier in TWO_BYTE_TIERS else None)
                    tail_flip_check(tag, out, ref, x, w, b, tier, one, r=4)
                    del one
                del out, ref, x
    # an f32 input under the tiers that store 2 bytes and contract in f32,
    # as ESAN's upconv0 and SCET's head read the LR image there: the
    # kernel's f32 path (tf32x3), its output rounded into the storage
    # dtype, against the stock conv + shuffle
    for tier in ("fasthi", "fasthi16"):
        with config.numerics_mode(tier), torch.inference_mode():
            for cout in (3, 4):
                x, w, b = zoo_in[(3, cout)]
                key = ("tf32x3", 3, 16 * cout, 4)
                n0 = tail.launches_by_shape.get(key, 0)
                out = fused.conv_pixelshuffle(x, w, b, 4)
                ref = ops.pixel_shuffle(ops.conv2d(x, w, b, padding=1), 4)
                torch.cuda.synchronize()
                tag = f"tail {tuple(x.shape[2:])} f32 input 3 -> {16 * cout} r=4"
                require(tail.launches_by_shape.get(key, 0) == n0 + 1,
                        f"{tag} [{tier}]: not one tf32x3 launch")
                compare(tag, out, ref, tier)
                flip_check(tag, "tail", out, ref, tier)
                del out, ref
    # the HR tails' x2 upsamplers (ops/fused.py), 52 -> 208 and 64 -> 256
    # with their 2-byte weights streamed, with RLFN's tail's checks
    r2_err = {}
    for tier in ("fasthi16", "parity", "fasthi", "fast", "fast16"):
        with config.numerics_mode(tier), torch.inference_mode():
            dt = config.numerics().activation_dtype
            for cin, cout in R2_WIDTHS:
                for shape in ((2, 37, 29, cin), (4, 64, 64, cin)):
                    x, w, b = random_tail(shape, cout, 2, seed=9, dtype=dt)
                    before = dict(tail.launches_by_kernel)
                    out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=2)
                    ref = tail.conv3x3_pixelshuffle_plain(x, w, b, r=2)
                    torch.cuda.synchronize()
                    tag = f"tail {shape} -> {4 * cout} r=2"
                    served_tail(tail, before, tag, tier, cin, 4 * cout, 2)
                    err = compare(tag, out, ref, tier)
                    if tier == "parity":
                        f64_ratios[f"{tag} [{tier}]"] = f64_check(f"{tag} [{tier}]", out, ref,
                                                                  tail_f64(x, w, b, 2))
                    else:
                        one = (chain_check.one_rounding("tail", [w], [b], r=2)(x)
                               if tier in TWO_BYTE_TIERS else None)
                        tail_flip_check(tag, out, ref, x, w, b, tier, one)
                        del one
                    if tier == "fast" and shape[0] == 4:
                        r2_err[(cin, 4 * cout)] = err
                    del out, ref
    print(json.dumps({"f64_error_ratios": f64_ratios}))
    print(f"   tail launches by kernel so far: {tail.launches_by_kernel}")
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
    print(f"   tier {srv.tier} (the card's plan, {os.path.relpath(envelope.DEFAULT_PATH, HERE)}), "
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
    launches = {entry_of("conv3x3_chain", srv.tier): got[0],
                entry_of("conv3x3_pixelshuffle", srv.tier): got[1]}
    print(f"   launches in the serving run: {got[0]} chain, {got[1]} tail")
    require(got == (4 * SERVE_BATCHES, SERVE_BATCHES)
            and path_counts(path_of(srv.tier)) == (4 * SERVE_BATCHES, SERVE_BATCHES),
            f"serving did not run 4 chain launches and 1 tail launch per forward on the "
            f"{path_of(srv.tier)} path")
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
    # (fasthi) products, and the 2-byte kernels' one product with the
    # two-rounding epilogue (fast: bf16, fast16: f16)
    few = np.stack(frames[:8])
    for tier in [t for t in ("fasthi16", "parity", "mixed", "fasthi", "fast", "fast16")
                 if t != srv.tier]:
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
    # off); fast and fast16 (one bf16 or f16 product, two roundings)
    # beside cuDNN in their own dtype
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
    # RLFN's tail, then every other x4 upsampler width of the zoo
    # (R4_FULL_BATCH at TIME_BATCH, the others at ZOO_TIME_BATCH)
    for cin, cout in ZOO_R4_WIDTHS:
        nch = 16 * cout
        batch = TIME_BATCH if (cin, cout) in R4_FULL_BATCH else ZOO_TIME_BATCH
        if cin == 46:
            x_base, w, b = x_tail.float(), model.upsampler[0].weight, model.upsampler[0].bias
            del x_tail
        else:  # the input drawn on the card: numpy would take seconds at this size
            _, w, b = random_tail((1, 8, 8, cin), cout, 4, seed=8)
            gen = torch.Generator(device=dev).manual_seed(8)
            x_base = torch.randn((batch, cin, SIZE, SIZE), generator=gen, device=dev) * 8
            x_base = x_base.contiguous(memory_format=torch.channels_last)
        # every tier's path (fasthi16 at 46 is the f16 record above)
        tiers = ("parity", "fasthi", "fast", "fast16") + (() if cin == 46 else ("fasthi16",))
        for tier in tiers:
            with config.numerics_mode(tier), torch.inference_mode():
                x = x_base.to(config.numerics().activation_dtype)
                out = tail.fused_conv3x3_pixelshuffle(x, w, b)
                compare(f"tail {cin}->{nch} [{tier}] (batch {batch})", out,
                        tail.conv3x3_pixelshuffle_plain(x, w, b), tier)
                del out
                widths = f"{cin}->{nch} r=4" + ("" if batch == TIME_BATCH else f" at batch {batch}")
                rows.append(("conv3x3_pixelshuffle", widths, tier, 9 * cin * nch,
                             (cin + nch) * x.element_size(), [w, b],
                             cuda_ms(tail.fused_conv3x3_pixelshuffle, x, w, b),
                             cuda_ms(tail.conv3x3_pixelshuffle_plain, x, w, b),
                             cuda_ms(library_tail(tier, w, b), x),
                             cuda_ms(library_tail(tier, w, b, two_byte=True), x)
                             if tier in TWO_BYTE_LIBRARY else None, batch * SIZE * SIZE))
                del x
        del x_base
    # the HR tails' x2 upsamplers under fast and fast16 (and parity, fasthi
    # and fasthi16, whose library call is cuDNN f32), at batch R2_BATCH and
    # the size each sees for a 256x256 LR input
    r2_rows = {}  # widths -> (cin, conv channels)
    for cin, cout, side in R2_TIMED:
        _, w, b = random_tail((1, 8, 8, cin), cout, 2, seed=10)
        gen = torch.Generator(device=dev).manual_seed(10)
        x_base = torch.randn((R2_BATCH, cin, side, side), generator=gen, device=dev) * 8
        x_base = x_base.contiguous(memory_format=torch.channels_last)
        widths = f"{cin}->{4 * cout} r=2 at {R2_BATCH}x{side}x{side}"
        r2_rows[widths] = (cin, 4 * cout)
        for tier in ("parity", "fast", "fast16", "fasthi", "fasthi16"):
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
    # each (width, path) the zoo's x4 upsamplers serve, at one LR frame of
    # phase 8's size (phase 3's inputs) under a CUDA graph, beside its
    # library call + PixelShuffle under a graph of its own; medians of 20
    served = sorted({(cin, nch // 16, serving.gated_tier(registry.get_spec(mid).name,
                                                         envelope.TPU_PATH))
                     for mid, sites in ZOO_TAILS.items() for cin, nch in sites})
    served_json = []
    for cin, cout, tier in served:
        xs, w, b = zoo_in[(cin, cout)]
        nch, px = 16 * cout, xs.shape[2] * xs.shape[3]
        with config.numerics_mode(tier), torch.inference_mode():
            x = xs.to(config.numerics().activation_dtype)
            ms_pair = []
            for fn in (lambda v, w=w, b=b: tail.fused_conv3x3_pixelshuffle(v, w, b),
                       library_tail(tier, w, b)):
                g = graphs.GraphedForward(fn, dev)
                g.prepare(x)
                ms_pair.append(profiling.device_timer(lambda _: g.replay(), x, iters=20,
                                                      warmup=3)[0] * 1e3)
                del g
        ms, lib_ms = ms_pair
        products, rate, form = F32_GRADE_BOUND[tier]
        t_ops = 2 * 9 * cin * nch * px * products / rate * 1e3
        t_bytes = ((cin + nch) * x.element_size() * px + (w.numel() + b.numel()) * 4) / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        print(f"   served tail {cin}->{nch} r=4 [{tier}, {path_of(tier)}] at 1x{xs.shape[2]}x"
              f"{xs.shape[3]} (graph): kernel {ms:.4f} ms, library + shuffle {lib_ms:.4f} ms "
              f"({lib_ms / ms:.2f}x); bound {bound:.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}) = {bound / ms:.1%} of it; "
              f"on {smi}", flush=True)
        served_json.append({"widths": f"{cin}->{nch} r=4", "tier": tier, "path": path_of(tier),
                            "ms": ms, "library_ms": lib_ms, "bound_ms": bound,
                            "bound_by": "operations" if t_ops >= t_bytes else "bytes"})
        require(ms > 0 and lib_ms > 0, f"served tail {cin}->{nch} [{tier}] not timed")
    del zoo_in
    print(json.dumps({"served_tail_rows": served_json}))
    print(f"   phase 6 with the split-TF32, fast and fast16 rows: {time.perf_counter() - t0:.1f} s")

    # 7. challenge protocol ---------------------------------------------------
    t0 = phase("7. challenge protocol (harness.cli, runner, x8, tiling; model 04)")
    protocol_phase(model, dr, smi)
    print(f"   phase 7: {time.perf_counter() - t0:.1f} s")

    # 8. the zoo ------------------------------------------------------------
    t0 = phase(f"8. the zoo ({len(ZOO_IDS)} models besides RLFN)")
    zoo, r2_launches, zoo_launches, zoo_failures = zoo_phase(smi)
    print(json.dumps({"zoo": zoo}))
    print(json.dumps({"zoo_launches": zoo_launches}))
    for rec in kernels:
        if rec["launches"] is None:  # an x2 upsampler's: its served forwards in phase 8
            cin, nch = (int(v) for v in rec["name"].rsplit("_", 1)[1].split("to"))
            rec["launches"] = r2_launches.get((cin, nch), 0)
            require(rec["launches"] > 0, f"{rec['name']} never launched on the main path")
        if rec["name"] in zoo_launches:
            rec["zoo_launches"] = zoo_launches[rec["name"]]
    require(all(any(rec["name"] == n for rec in kernels) for n in zoo_launches),
            f"a zoo launch path is not in the kernels line: {sorted(zoo_launches)}")
    require(not zoo_failures, f"phase 8: {len(zoo_failures)} checks failed: {zoo_failures}")
    print(f"   phase 8: {time.perf_counter() - t0:.1f} s")

    # 9. serving CLI --------------------------------------------------------
    t0 = phase("9. serving CLI (harness.serve: chain, split and tiled plans)")
    serve_phase()
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

    # 11. the w8 tier on the card ---------------------------------------------
    t0 = phase("11. w8 on the card (int8 weights through both kernels, SRServer, NASNetBN, CLI)")
    w8_launches = w8_phase(smi)
    for rec in kernels:
        if rec["name"] in w8_launches:
            rec["w8_launches"] = w8_launches[rec["name"]]
            require(rec["w8_launches"] > 0, f"{rec['name']} never launched in phase 11")
    print(json.dumps({"w8_launches": w8_launches}))
    print(f"   phase 11: {time.perf_counter() - t0:.1f} s")

    # 12. the reference library, imresize_matlab, the checkpoint path ---------
    t0 = phase("12. the reference library (blocks, tail launches), imresize_matlab, .pth path")
    library_launches = library_phase(smi)
    for rec in kernels:
        if rec["name"] in library_launches:
            rec["library_launches"] = library_launches[rec["name"]]
    require(all(any(rec["name"] == n for rec in kernels) for n in library_launches),
            f"a library launch path is not in the kernels line: {sorted(library_launches)}")
    print(json.dumps({"library_launches": library_launches}))
    print(f"   phase 12: {time.perf_counter() - t0:.1f} s")

    # 13. the serving plans ---------------------------------------------------
    t0 = phase("13. serving plans (the card's envelope from its rows; three models re-timed)")
    print(json.dumps(plans_phase(smi)))
    print(f"   phase 13: {time.perf_counter() - t0:.1f} s")
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
