#!/usr/bin/env python3
"""The kernels of one checkout against their plain versions, on the card.

    python3 ntire2022_esr_tpu_torch/tools/chain_check.py
        [--kernel chain|tail|both|tail_r2|tail_zoo|chain_widths] [--tiers TIER ...]
        [--root DIR | --turns DIR] [--weights DIR] [--sass] [--one-product]

Imports the port's package from ``DIR`` (default: this checkout), so that two
versions of a kernel can be held to the same inputs in one run: unpack the
other commit somewhere (``git archive``) and pass it as ``--root``, with
``--weights`` pointing at this checkout's ``weights/``; ``--turns DIR``
runs the rest of the command on DIR's package and on this checkout's in
turns, DIR, this, this, DIR, a process each.

Inputs are those of ``chip_smoke.py``, on model 04's weights, in the
activation dtype of each tier (default fasthi16): RLFN's first RLFB chain on
``8 * randn`` from numpy seed 1 at (8, 256, 256, 46) and seed 3 at
(128, 256, 256, 46); its upsampler (conv3x3 + PixelShuffle) on seeds 2 and 4
at the same shapes. Prints, per tier and input, the largest and mean
difference, the flip rate (share of outputs that differ at all from the
plain version's) and the kernel's time (median of 5 CUDA-event timings)
beside its bound (``BOUND_FORM``) and its share of it, with the card's
name and power limit; under parity, high and mixed, at batch 8, also the
kernel's largest error against the f64 result (cuDNN in float64 on the
same operands) over the plain f32 version's, which ``chip_smoke.py``
holds to at most 4. Each flip rate under fasthi, fast and
fast16 is set against ``FLIP_BARS``, the bar that ``chip_smoke.py`` holds
the kernels to; under fast and fast16 the flip rate against a plain
version with one rounding (:func:`one_rounding`, the bias inside the
sum's rounding) is printed beside it.

``--kernel tail_r2`` takes the zoo's x2 upsamplers instead (``R2_WIDTHS``:
cin -> 4 * cout, r = 2, random weights from numpy seed 9): each at
(2, 37, 29), an image no tile divides (under parity, high and mixed
with its error against f64 over the plain f32 version's), and at batch
16 at the size the site sees for a 256x256 LR input (drawn on the card,
seed 9), with the time of the plain version and of cuDNN + PixelShuffle
computing the same
function (in the 2-byte dtype under fast and fast16; f32 with TF32 off on
the upcast activations, rounded to the storage dtype, under the tiers with
f32 weights, with cuDNN in the storage dtype beside it as another
function) beside the kernel's, and the kernel's bound
(``BOUND_FORM``) and its share of it. Under fast and fast16, at
the small shape, it also prints the flip rates of the kernel and of the
plain version against the f64 sum of the same rounded operands, rounded
as the tier rounds (twice, the bias between), those of the plain version
on the input and weights zero-padded to 56 and to 64 input channels, and
of the plain version run one shuffle position (cout channels) at a time,
against the kernel: which sum order the library takes at which width.

``--kernel tail_zoo`` takes the zoo's x4 upsamplers
(``chip_smoke.ZOO_R4_WIDTHS``, cin -> 16 * cout, random weights from
numpy seed 11, the input drawn on the card) at 256 x 256, batch
``chip_smoke.TIME_BATCH`` for ``R4_FULL_BATCH`` and ``ZOO_TIME_BATCH``
for the others: the kernel's time beside cuDNN + PixelShuffle computing the
same function (as ``tail_r2``), the bound and its share, the flip rate
against the plain version and the kernel that served the launch.

``--kernel chain_widths`` takes the chain at the other widths of
``CHAIN_WIDTHS`` (random weights and input from numpy seed 6, as
``chip_smoke.py``'s phase 2 makes them), under each tier that takes the
width: the largest difference from the plain version, the flip rate
against it, and under fast and fast16 the flip rates of the kernel and of
the plain version against the f64 sums of the same rounded operands,
rounded as the tier rounds (:func:`exact_chain_two_byte`), and against
one rounding; then the kernel's time at that small shape. A width that a
kernel refuses prints so.

``--sass`` first prints, for each kernel of both libraries, how many
``HGMMA`` (warpgroup MMA) instructions ``cuobjdump -sass`` finds in it,
and each library's first: the proof that the 2-byte paths issue
``wgmma``.

``--one-product`` measures a control instead: a copy of the package under
``build/chain_check/one_product/`` whose fasthi launches take the
split-TF32 kernels with one product (``P = 1``, an instantiation that no
tier launches) with fasthi's own epilogue and weights: it drops the
``a_hi * w_lo`` product, so fasthi multiplies by TF32 weights alone, one
product a MAC; parity keeps its 3. It shows what the fasthi bar catches.
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
# The same under fast and fast16, whose kernels round each sum to the
# dtype before they add the bias, as the plain version does: 2-3x the
# H100's readings on chip_smoke.py's phase 2-3 inputs when fast ran one
# TF32 product with sums per tap: chain 2.66e-3 and 2.47e-3, tail 7.3e-5
# and 7.7e-5. fast16: chain 0 at batch 8 and 2.27e-4 at (2, 63, 41, 46),
# where cuDNN takes another algorithm; tail 0 at every shape, so its bar
# is half a stock f16 conv's own flip rate against the f64 sum rounded to
# f16 (2.2e-3). On one m16n8k16 product both tiers read 0 at every shape
# but fast16's chain at (2, 63, 41, 46), 2.27e-4. A kernel that adds the
# bias inside one rounding reads 0.49 (chain) and 0.25 (tail) under both
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).
FLIP_BARS = {"fasthi": FASTHI_FLIP_BARS,
             "fast": {"chain": 6e-3, "tail": 2e-4},
             "fast16": {"chain": 6e-4, "tail": 1e-3}}

# The bound of the tail's work under each tier, as chip_smoke.py's
# F32_GRADE_BOUND states it: the cheapest form of its products on the card
# (products a MAC, rate; NVIDIA's H100 SXM data sheet at 700 W), against
# the bytes at the HBM3 rate
BOUND_FORM = {"parity": (3, 495e12), "high": (3, 495e12), "mixed": (3, 495e12),
              "fasthi": (3, 989e12), "fasthi16": (2, 989e12), "fast": (1, 989e12),
              "fast16": (1, 989e12)}
PEAK_BYTES = 3.35e12

# The x2 upsamplers of the HR tails, (cin, cout, side of the LR image the
# site sees for a 256x256 input): m_RFDN's upconv2 (24 -> 96, at 2x) and
# upconv1 (52 -> 208), NASNetBN's upconv1 (32 -> 128; upconv2 runs at 2x) and
# LWFANet's conv_up1 (64 -> 256; conv_up2 runs at 2x)
R2_WIDTHS = ((24, 24, 512), (32, 32, 256), (52, 52, 256), (64, 64, 256))

# The chain at widths other than RLFN's, which chip_smoke.py's phase 2 and
# ``--kernel chain_widths`` run: (NHWC input shape, (cin, cout) of each
# stage, the tiers whose kernels take them, None for every tier). Two or
# more steps a stage (over 48 output channels), a depth of 4, and the
# 2-byte wgmma kernel on the 8x8 tile, where a stage has 2 m-blocks for
# its 3 warpgroups: 112 -> 112 under fasthi16 (3 steps), 160 -> 160 under
# fast and fast16 (4), which fasthi16's two f16 terms a weight fit no
# block at; the split-TF32 kernel takes 160 -> 160 at its 4x4 (f32) and
# 8x8 (bf16) tiles, one m-block a stage.
CHAIN_WIDTHS = (
    ((2, 64, 64, 24), ((24, 24), (24, 24)), None),
    ((1, 40, 40, 20), ((20, 24), (24, 24), (24, 20)), None),
    ((1, 33, 47, 5), ((5, 7), (7, 5)), None),
    ((1, 37, 29, 64), ((64, 56), (56, 64)), None),
    ((1, 35, 33, 16), ((16, 40), (40, 32), (32, 8), (8, 16)), None),
    ((1, 19, 23, 112), ((112, 112),), None),
    ((1, 21, 19, 160), ((160, 160),), ("fast", "fast16", "parity", "fasthi")),
)

# The control's text patches (source, anchor, replacement): fasthi's
# launches take the split-TF32 kernels with one product, with fasthi's
# epilogue.
ONE_PRODUCT_PATCHES = (
    ("conv_chain.cu", "launch_chain_tf32<__nv_bfloat16, 2>", "launch_chain_tf32<__nv_bfloat16, 1>"),
    ("tail.cu", "launch_tail_tf32<__nv_bfloat16, 2>", "launch_tail_tf32<__nv_bfloat16, 1>"),
)


def one_product_copy(dst: str) -> str:
    """A copy of the package under ``dst`` whose fasthi kernels issue
    a_hi * w_hi alone; returns ``dst``. Fails if a patch's anchor is not in
    its source exactly once."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, anchor, new in ONE_PRODUCT_PATCHES:
        path = os.path.join(dst, PKG, "csrc", fname)
        with open(path) as fh:
            text = fh.read()
        if text.count(anchor) != 1:
            raise RuntimeError(f"{path}: anchor not found exactly once: {anchor!r}")
        with open(path, "w") as fh:
            fh.write(text.replace(anchor, new))
    return dst


def one_rounding(kernel: str, ws, bs, slope: float = 0.05, r: int = 4, residual: bool = True):
    """The plain version of ``kernel`` ("chain" or "tail") under the active
    fast or fast16 tier with the bias inside one rounding: each conv sums
    the exact products of the rounded weights and activations in f32 (TF32
    off), adds the rounded bias in f32 and rounds once, saturating f16.
    What a kernel that skipped the tier's double rounding would compute."""
    import torch.nn.functional as F
    from ntire2022_esr_tpu_torch import config, ops
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain

    dt = config.numerics().compute_dtype
    wr, br = conv_chain.rounded(ws, bs, dt)

    def conv(x, w, b):
        return ops.cast_compute(F.conv2d(x.float(), w, b, padding=1), dt)

    if kernel == "tail":
        return lambda x: ops.pixel_shuffle(conv(x, wr[0], br[0]), r)

    def chain(x):
        h = x
        for w, b in zip(wr, br):
            h = ops.leaky_relu(conv(h, w, b), slope)
        return h + x if residual else h

    return chain


def hgmma_counts(name: str):
    """The kernels of the built library ``name`` with their counts of HGMMA
    (warpgroup MMA) instructions in ``cuobjdump -sass``, and the first such
    instruction."""
    from ntire2022_esr_tpu_torch.ops.kernels import build

    build.build([name])
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build._lib_path(name)],
                          capture_output=True, text=True, check=True).stdout
    fn, counts, first = None, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif "HGMMA" in line and fn:
            counts[fn] += 1
            if first is None:  # "/*0a30*/ HGMMA.64x96x16.F32 ... ; /* 0x... */"
                first = line.split("*/", 1)[-1].split("/*")[0].strip()
    return counts, first


def print_hgmma() -> None:
    """Each kernel of both libraries with its count of HGMMA instructions,
    and each library's first such instruction."""
    for name in ("conv_chain", "tail"):
        counts, first = hgmma_counts(name)
        for fn, n in counts.items():
            print(f"  {n:4d} HGMMA in {fn}")
        print(f"  {name}: first {first}")


def cuda_ms(fn, *args) -> float:
    """Median of 5 CUDA-event timings of ``fn(*args)`` after 2 more, in ms."""
    import torch

    times = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[2:]))


def exact_two_byte(x, w, b, r: int, dt):
    """The tail under a 2-byte compute tier from the f64 sum of the rounded
    operands: the sum rounded to ``dt``, the rounded bias added, rounded
    again (f16 saturating), then the shuffle."""
    import torch
    import torch.nn.functional as F

    wr = w.to(dt).double() if dt != torch.float16 else w.clamp(-65504, 65504).to(dt).double()
    s = F.conv2d(x.double(), wr, padding=1)
    y = (s.to(dt).double() + b.to(dt).double().reshape(1, -1, 1, 1))
    if dt == torch.float16:
        y = y.clamp(-65504, 65504)
    return F.pixel_shuffle(y.to(dt), r)


def exact_chain_two_byte(x, ws, bs, slope: float, residual: bool, dt):
    """The chain under a 2-byte compute tier from the f64 sums of the
    rounded operands (``conv_chain.rounded``): each stage's sum rounded to
    ``dt``, the rounded bias added and rounded again (f16 saturating), then
    LeakyReLU with the slope rounded to ``dt`` (the product rounded once);
    then ``+ x``, rounded once."""
    import torch
    import torch.nn.functional as F
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain

    wr, br = conv_chain.rounded(ws, bs, dt)
    slope_t = torch.tensor(slope).to(dt).double()
    h = x
    for w, b in zip(wr, br):
        y = F.conv2d(h.double(), w.double(), padding=1).to(dt).double()
        if b is not None:
            y = y + b.double().reshape(1, -1, 1, 1)
        if dt == torch.float16:
            y = y.clamp(-65504, 65504)
        y = y.to(dt)
        h = torch.where(y < 0, (y.double() * slope_t).to(dt), y)
    return (h.double() + x.double()).to(dt) if residual else h


def padded_chain_plain(x, ws, bs, slope: float, residual: bool, c: int = 16):
    """The chain's plain version with every width zero-padded to a
    multiple of ``c`` channels (input, weights and biases; the pad's
    outputs are zero, and stay zero through the LeakyReLU): the same sums,
    which the library may take in another order, or with another
    algorithm, than at the narrow widths."""
    import torch
    import torch.nn.functional as F
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain

    up = lambda n: -(-n // c) * c  # noqa: E731
    cl = torch.channels_last
    h = F.pad(x, (0, 0, 0, 0, 0, up(x.shape[1]) - x.shape[1])).contiguous(memory_format=cl)
    wp, bp = [], []
    for w, b in zip(ws, bs):
        co, ci = w.shape[:2]
        wp.append(F.pad(w, (0, 0, 0, 0, 0, up(ci) - ci, 0, up(co) - co)))
        bp.append(None if b is None else F.pad(b, (0, up(co) - co)))
    y = conv_chain.conv3x3_chain_plain(h, wp, bp, slope=slope, residual=False)
    y = y[:, :ws[-1].shape[0]].contiguous(memory_format=cl)
    return y + x if residual else y


def random_chain(shape, chans, seed: int, dtype):
    """A chain of other widths than RLFN's on the card: the input (NHWC
    ``shape``, 8 * randn, in ``dtype``) and f32 weights (0.05 * randn) and
    biases (0.1 * randn), all from numpy ``seed``."""
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
    return x.to(dtype), ws, bs


def chain_widths(tier: str, dt, conv_chain) -> None:
    """``--kernel chain_widths`` under the active ``tier`` (see the module
    docstring)."""
    import torch

    for shape, chans, tiers in CHAIN_WIDTHS:
        if tiers is not None and tier not in tiers:
            continue
        x, ws, bs = random_chain(shape, chans, 6, dt)
        tag = f"chain_widths {'->'.join(str(c) for c in [chans[0][0]] + [co for _, co in chans])}"
        try:
            out = conv_chain.fused_conv3x3_chain(x, ws, bs)
        except ValueError as e:
            print(f"{tag} [{tier}] {shape}: refused ({e})", flush=True)
            continue
        ref = conv_chain.conv3x3_chain_plain(x, ws, bs)
        d = (out.float() - ref.float()).abs()
        line = (f"{tag} [{tier}] {shape}: max|d| {float(d.max()):.3e} "
                f"flip rate {float((out != ref).float().mean()):.3e}")
        if tier in FLIP_BARS:
            line += f" (bar {FLIP_BARS[tier]['chain']:.0e})"
        if tier in ("fast", "fast16"):
            exact = exact_chain_two_byte(x, ws, bs, 0.05, True, dt)
            one = one_rounding("chain", ws, bs)(x)
            pad = padded_chain_plain(x, ws, bs, 0.05, True)
            line += (f"; against the f64 sums rounded as {tier} rounds: kernel "
                     f"{float((out != exact).float().mean()):.3e}, plain "
                     f"{float((ref != exact).float().mean()):.3e}, plain on widths padded to "
                     f"16s {float((pad != exact).float().mean()):.3e} "
                     f"({float((pad != out).float().mean()):.3e} from the kernel); "
                     f"against one rounding {float((out != one).float().mean()):.3e}")
            # the first stage alone, which no earlier flip feeds
            x1, w1, b1 = x, ws[:1], bs[:1]
            k1 = conv_chain.fused_conv3x3_chain(x1, w1, b1, residual=False)
            e1 = exact_chain_two_byte(x1, w1, b1, 0.05, False, dt)
            p1 = conv_chain.conv3x3_chain_plain(x1, w1, b1, residual=False)
            q1 = padded_chain_plain(x1, w1, b1, 0.05, False)
            off = k1 != e1
            line += (f"; first stage against the f64 sums: kernel {float(off.float().mean()):.3e} "
                     f"(toward zero {float((k1.abs() < e1.abs())[off].float().mean()):.2f}), "
                     f"plain {float((p1 != e1).float().mean()):.3e}, padded "
                     f"{float((q1 != e1).float().mean()):.3e}")
        line += f"; kernel {cuda_ms(lambda v: conv_chain.fused_conv3x3_chain(v, ws, bs), x):.4f} ms"
        print(line, flush=True)
        torch.cuda.synchronize()


def padded_plain(tail, x, w, b, r: int, cin: int):
    """The plain version on the input and weights zero-padded to ``cin``
    input channels: the same sums, which the library may take in another
    order."""
    import torch
    import torch.nn.functional as F

    pad = cin - x.shape[1]
    xp = F.pad(x, (0, 0, 0, 0, 0, pad)).contiguous(memory_format=torch.channels_last)
    return tail.conv3x3_pixelshuffle_plain(xp, F.pad(w, (0, 0, 0, 0, 0, pad)), b, r=r)


def per_position_plain(ops, tail, x, w, b, r: int):
    """The plain version one shuffle position at a time: r * r convs of
    cout output channels each (the channels of one (i, j)), interleaved
    back into the shuffle's order. The same sums as one conv; the library
    may choose another algorithm for the narrower conv."""
    import torch

    nch = w.shape[0]
    cout = nch // (r * r)
    order = tail.shuffled_order(cout, r).to(w.device)
    parts = [ops.conv2d(x, w[order[k:k + cout]], b[order[k:k + cout]], padding=1)
             for k in range(0, nch, cout)]
    conv = torch.empty_like(torch.cat(parts, dim=1))
    conv[:, order] = torch.cat(parts, dim=1)
    return ops.pixel_shuffle(conv, r)


def tail_r2(tier: str, dt, ops, tail) -> None:
    """``--kernel tail_r2`` under the active ``tier`` (see the module
    docstring)."""
    import torch
    import torch.nn.functional as F

    for cin, cout, side in R2_WIDTHS:
        rs = np.random.RandomState(9)
        # made outside inference mode: the packed-weight cache keys on a
        # tensor's version, which inference tensors lack (they pack anew on
        # every call)
        with torch.inference_mode(False):
            w = torch.from_numpy(rs.standard_normal((4 * cout, cin, 3, 3)).astype(np.float32))
            b = torch.from_numpy(rs.standard_normal(4 * cout).astype(np.float32))
            w, b = w.cuda() * 0.05, b.cuda() * 0.1
        small = rs.standard_normal((2, 37, 29, cin)).astype(np.float32) * 8
        gen = torch.Generator(device="cuda").manual_seed(9)
        big = torch.randn((16, cin, side, side), generator=gen, device="cuda") * 8
        for x in (ops.from_nhwc(torch.from_numpy(small).cuda()).to(dt),
                  big.contiguous(memory_format=torch.channels_last).to(dt)):
            out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=2)
            ref = tail.conv3x3_pixelshuffle_plain(x, w, b, r=2)
            d = (out.float() - ref.float()).abs()
            flips = float((out != ref).float().mean())
            verdict = ""
            if tier in FLIP_BARS:
                bar = FLIP_BARS[tier]["tail"]
                verdict = f" ({'under' if flips <= bar else 'over'} the {tier} bar {bar:.0e})"
            if tier in ("fast", "fast16"):
                one = one_rounding("tail", [w], [b], r=2)(x)
                verdict += f"; against one rounding {float((out != one).float().mean()):.3e}"
                del one
            if tier in ("parity", "high", "mixed") and x.shape[0] == 2:
                exact = F.pixel_shuffle(F.conv2d(x.double(), w.double(), b.double(), padding=1), 2)
                e_k = float((out.double() - exact).abs().max())
                e_p = float((ref.double() - exact).abs().max())
                verdict += f"; against f64 {e_k / e_p:.3f}x the plain f32 version's error"
                del exact
            line = (f"tail_r2 {cin}->{4 * cout} [{tier}] {tuple(ops.to_nhwc(x).shape)}: "
                    f"max|d| {float(d.max()):.3e} mean|d| {float(d.mean()):.3e} "
                    f"max|ref| {float(ref.abs().max()):.3e} flip rate {flips:.3e}{verdict}")
            if x.shape[0] == 16:
                # the same function: cuDNN in the dtype where the tier's
                # weights are 2-byte, else f32 on the upcast activations,
                # rounded to the storage dtype; cuDNN in the storage dtype
                # (the f32 weights rounded to it) is another function
                ld = x.dtype if tier in ("fast", "fast16") else torch.float32
                lw, lb, w2, b2 = w.to(ld), b.to(ld), w.to(x.dtype), b.to(x.dtype)
                kernel = cuda_ms(lambda v: tail.fused_conv3x3_pixelshuffle(v, w, b, r=2), x)
                plain = cuda_ms(lambda v: tail.conv3x3_pixelshuffle_plain(v, w, b, r=2), x)
                lib = cuda_ms(lambda v: F.pixel_shuffle(
                    F.conv2d(v.to(ld), lw, lb, padding=1).to(v.dtype), 2), x)
                lib2 = cuda_ms(lambda v: F.pixel_shuffle(F.conv2d(v, w2, b2, padding=1), 2), x)
                products, rate = BOUND_FORM[tier]
                n, _, hh, ww = x.shape
                macs = n * hh * ww * 4 * cout * cin * 9
                # input read once, output written once, f32 weights and bias
                nbytes = (n * hh * ww * (cin + 4 * cout) * x.element_size()
                          + 4 * (w.numel() + b.numel()))
                t_ops, t_bytes = 2 * macs * products / rate * 1e3, nbytes / PEAK_BYTES * 1e3
                bound = max(t_ops, t_bytes)
                other = (f", cuDNN {str(x.dtype)[6:]} (another function) {lib2:.3f} ms"
                         if ld != x.dtype else "")
                line += (f"; kernel {kernel:.3f} ms, plain {plain:.3f} ms, "
                         f"cuDNN {str(ld)[6:]} + shuffle {lib:.3f} ms{other}; bound {bound:.3f} ms "
                         f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
                         f"{2 * macs / 1e9:.1f} GFLOP x{products} at {rate / 1e12:.0f} TFLOP/s "
                         f"{t_ops:.3f} ms, {nbytes / 1e6:.1f} MB {t_bytes:.3f} ms) = "
                         f"{bound / kernel:.1%} of it")
            print(line, flush=True)
            if x.shape[0] == 2 and tier in ("fast", "fast16"):
                exact = exact_two_byte(x, w, b, 2, dt)
                pads = {c: padded_plain(tail, x, w, b, 2, c) for c in (56, 64) if c > cin}
                pos = per_position_plain(ops, tail, x, w, b, 2)
                print(f"   against the f64 sum rounded as {tier} rounds: kernel "
                      f"{float((out != exact).float().mean()):.3e}, plain "
                      f"{float((ref != exact).float().mean()):.3e}; plain on input padded to "
                      + ", ".join(f"{c} channels: {float((p != out).float().mean()):.3e} from the "
                                  f"kernel, {float((p != ref).float().mean()):.3e} from the plain"
                                  for c, p in pads.items())
                      + f"; plain one shuffle position at a time: "
                      f"{float((pos != out).float().mean()):.3e} from the kernel, "
                      f"{float((pos != ref).float().mean()):.3e} from the plain", flush=True)
                del exact, pads, pos
            del out, ref, d
        del big


def tail_zoo(tier: str, dt, ops, tail) -> None:
    """``--kernel tail_zoo`` under the active ``tier`` (see the module
    docstring)."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, REPO)
    import chip_smoke

    for cin, cout in chip_smoke.ZOO_R4_WIDTHS:
        batch = (chip_smoke.TIME_BATCH if (cin, cout) in chip_smoke.R4_FULL_BATCH
                 else chip_smoke.ZOO_TIME_BATCH)
        rs = np.random.RandomState(11)
        with torch.inference_mode(False):
            w = torch.from_numpy(rs.standard_normal((16 * cout, cin, 3, 3)).astype(np.float32))
            b = torch.from_numpy(rs.standard_normal(16 * cout).astype(np.float32))
            w, b = w.cuda() * 0.05, b.cuda() * 0.1
        gen = torch.Generator(device="cuda").manual_seed(11)
        x = (torch.randn((batch, cin, 256, 256), generator=gen, device="cuda") * 8).contiguous(
            memory_format=torch.channels_last).to(dt)
        kernels = dict(getattr(tail, "launches_by_kernel", {}))
        out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=4)
        served = [k for k, v in getattr(tail, "launches_by_kernel", {}).items() if v != kernels[k]]
        ref = tail.conv3x3_pixelshuffle_plain(x, w, b, r=4)
        flips = float((out != ref).float().mean())
        del out, ref
        # the same function: cuDNN in the dtype where the tier's weights are
        # 2-byte, else f32 on the upcast activations, rounded to the dtype
        ld = x.dtype if tier in ("fast", "fast16") else torch.float32
        lw, lb = w.to(ld), b.to(ld)
        kernel = cuda_ms(lambda v: tail.fused_conv3x3_pixelshuffle(v, w, b, r=4), x)
        lib = cuda_ms(lambda v: F.pixel_shuffle(
            F.conv2d(v.to(ld), lw, lb, padding=1).to(v.dtype), 4), x)
        products, rate = BOUND_FORM[tier]
        npix = batch * 256 * 256
        macs = npix * 16 * cout * cin * 9
        nbytes = npix * (cin + 16 * cout) * x.element_size() + 4 * (w.numel() + b.numel())
        t_ops, t_bytes = 2 * macs * products / rate * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        print(f"tail_zoo {cin}->{16 * cout} [{tier}] batch {batch}{' ' + served[0] if served else ''}: "
              f"kernel {kernel:.3f} ms, cuDNN {str(ld)[6:]} + shuffle {lib:.3f} ms "
              f"({lib / kernel:.2f}x), bound {bound:.3f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}) = {bound / kernel:.1%}; "
              f"flip rate against the plain version {flips:.3e}", flush=True)
        del x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", default="chain",
                    choices=["chain", "tail", "both", "tail_r2", "tail_zoo", "chain_widths"])
    ap.add_argument("--tiers", nargs="*", default=["fasthi16"],
                    choices=["parity", "high", "mixed", "fasthi", "fasthi16", "fast", "fast16"])
    ap.add_argument("--root", default=REPO, help="checkout whose package is measured")
    ap.add_argument("--weights", default=os.path.join(REPO, "weights"))
    ap.add_argument("--sass", action="store_true",
                    help="print each kernel's HGMMA count from cuobjdump -sass")
    ap.add_argument("--one-product", action="store_true",
                    help="measure the one-product control (a patched copy of this checkout)")
    ap.add_argument("--turns", metavar="DIR",
                    help="run the other arguments on DIR's package and this checkout's in "
                         "turns: DIR, this, this, DIR (each a process of its own)")
    args = ap.parse_args()
    if args.turns:
        rest = [a for a in sys.argv[1:] if a not in ("--turns", args.turns)]
        rc = 0
        for root in (args.turns, REPO, REPO, args.turns):
            rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root]
                                 + rest).returncode
        return rc
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
    if args.sass:
        print_hgmma()
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
    if args.kernel in ("tail_r2", "tail_zoo", "chain_widths"):
        for tier in args.tiers:
            with config.numerics_mode(tier), torch.inference_mode():
                dt = config.numerics().activation_dtype
                if args.kernel == "tail_r2":
                    tail_r2(tier, dt, ops, tail)
                elif args.kernel == "tail_zoo":
                    tail_zoo(tier, dt, ops, tail)
                else:
                    chain_widths(tier, dt, conv_chain)
        return 0
    # MACs a pixel of each kernel at RLFN's widths, and the f64 result
    # (chip_smoke.py's, which holds the kernels to it)
    sys.path.append(REPO)
    import chip_smoke

    macs = {"chain": 9 * (46 * 48 + 48 * 48 + 48 * 46), "tail": 9 * 46 * 48}
    outc = {"chain": 46, "tail": 48}  # output values a pixel of x
    f64 = {"chain": lambda x: chip_smoke.chain_f64(x, ws, bs),
           "tail": lambda x: chip_smoke.tail_f64(x, up.weight, up.bias)}
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
                    verdict = ""
                    if tier in FLIP_BARS:
                        bar = FLIP_BARS[tier][name]
                        verdict = f" ({'under' if flips <= bar else 'over'} the {tier} bar {bar:.0e})"
                    if tier in ("fast", "fast16"):
                        ws1, bs1 = (ws, bs) if name == "chain" else ([up.weight], [up.bias])
                        one = one_rounding(name, ws1, bs1)(x)
                        verdict += (f"; against one rounding {float((out != one).float().mean()):.3e}")
                        del one
                    if tier in ("parity", "high", "mixed") and batch == 8:
                        exact = f64[name](x)
                        e_k = float((out.double() - exact).abs().max())
                        e_p = float((ref.double() - exact).abs().max())
                        verdict += f"; against f64 {e_k / e_p:.2f}x the plain f32 version's error"
                        del exact
                    ms = float(np.median(times[2:]))
                    products, rate = BOUND_FORM[tier]
                    npix = batch * 256 * 256
                    nbytes = npix * (46 + outc[name]) * x.element_size()  # in and out once
                    bound = max(2 * npix * macs[name] * products / rate,
                                nbytes / PEAK_BYTES) * 1e3
                    print(f"{name} [{tier}] batch {batch} seed {seed}: max|d| {float(d.max()):.3e} "
                          f"mean|d| {float(d.mean()):.3e} max|ref| {float(ref.abs().max()):.3e} "
                          f"flip rate {flips:.3e}{verdict} kernel {ms:.3f} ms, bound {bound:.3f} "
                          f"ms, {bound / ms:.1%} of it", flush=True)
                    del x, out, ref, d
    return 0


if __name__ == "__main__":
    sys.exit(main())
