#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ntire2022_esr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device and build: the card's name and power limit; both CUDA kernels
   compiled from ``ntire2022_esr_tpu_torch/csrc`` (nvcc, sm_90a), with the
   ptxas register/shared-memory report;
2. the conv-chain kernel against its plain PyTorch version on the card, at
   (8, 256, 256, 46) with widths 46 -> 48 -> 48 -> 46 and at (2, 63, 41, 46),
   under parity, fasthi16 and fasthi (f32, f16 and bf16 activations); under
   fasthi16 (the tensor-core kernel) also chains of one and two stages and
   of other widths (24 -> 24 -> 24, 20 -> 24 -> 24 -> 20, 5 -> 7 -> 5), so
   that its padding paths run;
3. the conv+PixelShuffle kernel against its plain version, same shapes and
   tiers; under fasthi16 (the tensor-core kernel) also other widths and
   factors (50 -> 48 r=4, 24 -> 27 r=3, 5 -> 12 r=2, 16 -> 64 r=4), an image
   smaller than one tile and a missing bias, so that its padding,
   general-row, second-chunk and plain-copy paths run beside the tensor
   copies; and its flip rate against the plain version;
4. golden parity: the port's RLFN under parity on the card against
   ``tests/goldens/model_04*.npz`` within 2e-4 * 255;
5. serving: ``SRServer(model_id=4)`` at its gated tier streams three
   batches of 32 random 256x256 uint8 frames (numpy seed 0) through the
   kernels (launch counts checked: 4 chain launches and 1 tail launch per
   forward; both kernels' weights are packed during warm-up and never in
   the stream), and its output is held against the same forward built from
   the plain versions on the card;
6. times at the served shape (batch 128, 256x256, fasthi16): each kernel,
   its plain version and one PyTorch library call computing the same
   function, medians of CUDA-event timings, beside the bound: the card's
   best rate for the work whatever implements it (f16 tensor cores, one
   product per MAC) against the bytes; and each kernel's flip rate, the
   share of f16 outputs that differ between the kernel and its plain version.
   Then the same for both kernels' f32 CUDA-core path under parity (cuDNN
   f32 with TF32 off as the library call, the f32 CUDA-core rate as the
   bound), the tail also at the RFDN skeleton's width (50 -> 48, r = 4);
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
8. the zoo: each of the 14 models of the RFDN skeleton and IMDN family
   built from its weights on the card, its 64x64 golden under parity
   within 2e-4 * data_range, and one synthetic LR 339x510 image through
   the graph-timed ``runner.run`` at its gated tier (parity for the four
   gated at the unported ``fast``), whose PSNR must be within 0.01 dB of
   an eager forward's; a line per model with the graph and eager times and
   the peak memory.

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``.
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

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit: f16 on the
# tensor cores (the bound), f32 outside them (the bound of a CUDA-core
# kernel, still printed beside it) and HBM3 bandwidth
PEAK_F16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

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
# phase 8: the RFDN skeleton and IMDN family (every id but 04 in the registry)
ZOO_IDS = (-1, 0, 1, 5, 6, 8, 13, 22, 25, 26, 35, 37, 38, 40)
SKELETON_NF = 50  # fea width of the RFDN baseline (00, 06, 08, 35, 38)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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


def random_chain(shape, chans, seed):
    """A chain of other widths than RLFN's: f16 input (NHWC ``shape``) and
    f32 weights and biases from numpy ``seed``."""
    import torch
    from ntire2022_esr_tpu_torch import ops

    rs = np.random.RandomState(seed)
    x = ops.from_nhwc(torch.from_numpy(rs.standard_normal(shape).astype(np.float32) * 8).cuda())
    ws = [torch.from_numpy(rs.standard_normal((co, ci, 3, 3)).astype(np.float32) * 0.05).cuda()
          for ci, co in chans]
    bs = [torch.from_numpy(rs.standard_normal(co).astype(np.float32) * 0.1).cuda()
          for _, co in chans]
    return x.half(), ws, bs


def flip_rate(out, ref) -> float:
    """Share of values that differ at all between a kernel and its plain version."""
    return float((out != ref).float().mean())


def tail_args(model, shape, dtype, seed):
    import torch
    from ntire2022_esr_tpu_torch import ops

    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32) * 8
    up = model.upsampler[0]
    return ops.from_nhwc(torch.from_numpy(x).cuda()).to(dtype), up.weight, up.bias


def random_tail(shape, cout, r, seed, bias=True):
    """A tail of other widths than RLFN's: f16 input (NHWC ``shape``) and an
    f32 weight to ``cout * r * r`` channels (and bias) from numpy ``seed``."""
    x, ws, bs = random_chain(shape, [(shape[3], cout * r * r)], seed)
    return x, ws[0], bs[0] if bias else None


def compare(tag: str, out, ref, tier: str) -> float:
    """Kernel vs plain version on the same inputs; returns max |diff|.

    parity (f32): rtol 1e-4, atol 1e-5 of the largest value. The sums run in
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
    if tier == "parity":
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
    from ntire2022_esr_tpu_torch.harness import cli, data, ensemble, runner, tiling
    from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail
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
        conv_chain.launches = 0
        tail.launches = 0
        graphs0[:] = [runner.captures, runner.replays]

    def check_launches(tag: str, forwards: int) -> None:
        got = (conv_chain.launches, tail.launches)
        print(f"   {tag}: {got[0]} chain and {got[1]} tail launches over {forwards} forwards")
        require(got == (4 * forwards, forwards),
                f"{tag}: not 4 chain launches and 1 tail launch per forward")

    def check_graphs(tag: str, replays: int) -> None:
        """A graph-timed run: the kernels launch in each warm-up and capture
        (the counters move at capture, not at replay), once a shape."""
        captures = runner.captures - graphs0[0]
        got = runner.replays - graphs0[1]
        print(f"   {tag}: {captures} graphs captured, {got} replays")
        require(got == replays, f"{tag}: {got} replays, not {replays}")
        check_launches(f"{tag} (warm-up and capture of each graph)", 2 * captures)

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
    check_graphs("harness.cli parity run", len(pairs))
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
    check_graphs("runner.run fasthi16", len(pairs))
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
    check_launches("x8 ensemble", 8)
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
    check_launches(f"tiled_apply ({n_tiles} tiles of 128, 16 a call)", math.ceil(n_tiles / 16))
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
    check_graphs("run_batched u8_io fasthi16", len(set(PROTOCOL_VALID)))
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


def zoo_phase(smi: str) -> list:
    """Phase 8: the 14 models of the RFDN skeleton and IMDN family (see the
    module docstring). Returns a record per model."""
    import torch
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import data, profiling, registry, runner, serving
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
    for mid in ZOO_IDS:
        model, name, dr, _ = registry.build_model(mid, device=dev)
        gated = serving.gated_tier(name)
        tier = gated if gated in config.modes() else "parity"
        g = np.load(os.path.join(HERE, "tests", "goldens", f"model_{mid:02d}.npz"))
        x = torch.from_numpy(g["input_u8"].astype(np.float32) / (255.0 / float(g["data_range"])))
        with config.numerics_mode("parity"), torch.inference_mode():
            out = model(x[None].to(dev)).cpu().numpy()[0]
        err = float(np.abs(out - g["output"]).max())
        require(out.shape == g["output"].shape and err < 2e-4 * dr,
                f"{name}: golden max|d| {err:.3e} over 2e-4 * {dr}")
        with config.numerics_mode(tier):
            res = runner.run(model, name, dr, None, logger,
                             types.SimpleNamespace(save_dir=os.path.join(work, "sr"), ssim=False),
                             mode="valid", pairs=[(lr_path, hr_path)])
            xl = torch.from_numpy(img_util.uint2nhwc(lr, dr)).to(dev)
            timer = profiling.Timer(dev)
            with torch.inference_mode():
                model(xl)
                timer.start()
                y = model(xl)
                eager_ms = timer.stop()
            sr = img_util.nhwc2uint(y.float().cpu().numpy(), dr)
        p_graph, p_eager = res["valid_psnr"][0], metrics.calculate_psnr(sr, hr, border=4)
        rec = {"model": name, "tier": tier, "gated": gated, "golden_max_abs_err": err,
               "graph_ms": res["valid_runtime"][0], "eager_ms": eager_ms,
               "peak_mb": res["valid_memory"], "psnr": p_graph, "psnr_eager": p_eager}
        records.append(rec)
        print(f"   {name}: tier {tier}{'' if tier == gated else f' (gated {gated}, not ported)'}; "
              f"golden max|d| {err:.2e} (bar {2e-4 * dr:.1e}); LR {lr.shape[0]}x{lr.shape[1]} "
              f"graph {rec['graph_ms']:.3f} ms, eager {eager_ms:.3f} ms, peak "
              f"{rec['peak_mb']:.1f} MB; PSNR {p_graph:.4f} dB, eager {p_eager:.4f} dB", flush=True)
        require(abs(p_graph - p_eager) <= PSNR_BAR_DB, f"{name}: graph PSNR off the eager forward's")
        del model, y
    shutil.rmtree(work)
    return records


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
    t0 = phase("2. conv3x3_chain kernel vs plain")
    for tier in ("parity", "fasthi16", "fasthi"):
        with config.numerics_mode(tier), torch.inference_mode():
            dt = config.numerics().activation_dtype
            for shape in ((8, SIZE, SIZE, 46), (2, 63, 41, 46)):
                x, ws, bs = chain_args(model, shape, dt, seed=1)
                out = conv_chain.fused_conv3x3_chain(x, ws, bs, slope=0.05, residual=True)
                ref = conv_chain.conv3x3_chain_plain(x, ws, bs, slope=0.05, residual=True)
                torch.cuda.synchronize()
                err = compare(f"chain {shape}", out, ref, tier)
                if tier == "fasthi16" and shape[0] == 8:
                    max_err["conv3x3_chain"] = err
                    print(f"   chain {shape} [fasthi16]: flip rate {flip_rate(out, ref):.3e}")
    with config.numerics_mode("fasthi16"), torch.inference_mode():
        convs = (model.B1.c1_r, model.B1.c2_r, model.B1.c3_r)
        x = chain_args(model, (2, 40, 52, 46), torch.float16, seed=5)[0]
        cases = [("1 stage 46->48", x, [convs[0].weight], [convs[0].bias], False),
                 ("2 stages 46->48->46", x, [convs[0].weight, convs[2].weight],
                  [convs[0].bias, None], True)]
        for shape, chans in (((2, 64, 64, 24), [(24, 24)] * 2),
                             ((1, 40, 40, 20), [(20, 24), (24, 24), (24, 20)]),
                             ((1, 33, 47, 5), [(5, 7), (7, 5)])):
            cases.append((f"{shape} {chans}", *random_chain(shape, chans, seed=6), True))
        for tag, x, ws, bs, residual in cases:
            out = conv_chain.fused_conv3x3_chain(x, ws, bs, slope=0.05, residual=residual)
            ref = conv_chain.conv3x3_chain_plain(x, ws, bs, slope=0.05, residual=residual)
            torch.cuda.synchronize()
            compare(f"chain {tag}", out, ref, "fasthi16")
    print(f"   phase 2: {time.perf_counter() - t0:.1f} s")

    # 3. tail kernel vs plain ----------------------------------------------
    t0 = phase("3. conv3x3_pixelshuffle kernel vs plain")
    for tier in ("parity", "fasthi16", "fasthi"):
        with config.numerics_mode(tier), torch.inference_mode():
            dt = config.numerics().activation_dtype
            for shape in ((8, SIZE, SIZE, 46), (2, 63, 41, 46)):
                x, w, b = tail_args(model, shape, dt, seed=2)
                out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=4)
                ref = tail.conv3x3_pixelshuffle_plain(x, w, b, r=4)
                torch.cuda.synchronize()
                err = compare(f"tail {shape}", out, ref, tier)
                if tier == "fasthi16" and shape[0] == 8:
                    max_err["conv3x3_pixelshuffle"] = err
                    print(f"   tail {shape} [fasthi16]: flip rate {flip_rate(out, ref):.3e}")
    with config.numerics_mode("fasthi16"), torch.inference_mode():
        for shape, cout, r, bias in (((2, 63, 41, 50), 3, 4, True), ((2, 40, 52, 24), 3, 3, True),
                                     ((1, 33, 47, 5), 3, 2, True), ((2, 5, 3, 46), 3, 4, True),
                                     ((1, 40, 40, 46), 3, 4, False), ((1, 24, 32, 16), 4, 4, True)):
            x, w, b = random_tail(shape, cout, r, seed=7, bias=bias)
            out = tail.fused_conv3x3_pixelshuffle(x, w, b, r=r)
            ref = tail.conv3x3_pixelshuffle_plain(x, w, b, r=r)
            torch.cuda.synchronize()
            compare(f"tail {shape} -> {cout * r * r} r={r}{'' if bias else ' no bias'}",
                    out, ref, "fasthi16")
    print(f"   phase 3: {time.perf_counter() - t0:.1f} s")

    # 4. golden parity on the card -----------------------------------------
    t0 = phase("4. golden parity (parity tier, TF32 off)")
    with config.numerics_mode("parity"), torch.inference_mode():
        require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
                "TF32 is on")
        for stem in ("model_04", "model_04_63x41"):
            g = np.load(os.path.join(HERE, "tests", "goldens", f"{stem}.npz"))
            x = torch.from_numpy(g["input_u8"].astype(np.float32) / (255.0 / float(g["data_range"])))
            before = (conv_chain.launches, tail.launches)
            out = model(x[None].to(dev)).cpu().numpy()[0]
            require((conv_chain.launches - before[0], tail.launches - before[1]) == (4, 1),
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
    conv_chain.launches = 0
    tail.launches = 0
    packs_warm = conv_chain.packs
    ts = time.perf_counter()
    outs = list(srv.process_stream(frames))
    serve_s = time.perf_counter() - ts
    print(f"   weight packs: {packs_warm} before the stream (build, phases 2-4, warm-up), "
          f"{conv_chain.packs - packs_warm} during it")
    require(conv_chain.packs == packs_warm, "the serving stream packed weights again")
    launches = {"conv3x3_chain": conv_chain.launches, "conv3x3_pixelshuffle": tail.launches}
    print(f"   launches in the serving run: {launches}")
    require(launches == {"conv3x3_chain": 4 * SERVE_BATCHES,
                         "conv3x3_pixelshuffle": SERVE_BATCHES},
            "serving did not run 4 chain launches and 1 tail launch per forward")
    require(len(outs) == len(frames) and all(o.shape == (4 * SIZE, 4 * SIZE, 3) and
                                             o.dtype == np.uint8 for o in outs),
            "serving output shape/dtype")
    ips = len(frames) / serve_s
    print(f"   {len(frames)} frames in {serve_s:.3f} s: {ips:.1f} images/sec "
          f"(host clock, batch {SERVE_BATCH}, {srv.tier}) on {smi}")

    def plain_served(u8: np.ndarray, tier: str) -> np.ndarray:
        y = plain_forward(model, torch.from_numpy(u8).to(dev).float() / (255.0 / dr), tier)
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
    psrv = serving.SRServer(model_id=4, max_batch=8, device=dev, tier="parity")
    pout = np.stack(list(psrv.process_stream(frames[:8])))
    pd = level_diff(pout, plain_served(np.stack(frames[:8]), "parity"))
    print(f"   served vs plain forward on the card [parity]: max {int(pd.max())} levels")
    require(int(pd.max()) <= 1, "parity serving differs from the plain forward by more than 1 level")
    print(f"   phase 5: {time.perf_counter() - t0:.1f} s")

    # 6. times at the served shape -----------------------------------------
    t0 = phase(f"6. times at batch {TIME_BATCH}, {SIZE}x{SIZE}, fasthi16")

    def cuda_ms(fn, *args) -> float:
        """Median of 5 CUDA-event times of ``fn(*args)`` after 2 warm-ups, in ms."""
        return profiling.device_timer(fn, *args, iters=5, warmup=2)[0] * 1e3

    records = []
    npix = TIME_BATCH * SIZE * SIZE
    with config.numerics_mode("fasthi16"), torch.inference_mode():
        x, ws, bs = chain_args(model, (TIME_BATCH, SIZE, SIZE, 46), torch.float16, seed=3)
        w16 = [w.half() for w in ws]
        b16 = [b.half() for b in bs]

        def chain_library(x):
            h = x
            for w, b in zip(w16, b16):
                h = F.leaky_relu(F.conv2d(h, w, b, padding=1), 0.05)
            return h + x

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
        lib_ms = cuda_ms(chain_library, x)
        records.append(("conv3x3_chain", "ntire2022_esr_tpu_torch/csrc/conv_chain.cu",
                        "ntire2022_esr_tpu/ops/pallas/conv_chain.py:166", macs, nbytes,
                        ms, plain_ms, lib_ms))
        x_chain = x  # its f32 copy is the f32 rows' input

        x, w, b = tail_args(model, (TIME_BATCH, SIZE, SIZE, 46), torch.float16, seed=4)
        w16, b16 = w.half(), b.half()
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
        lib_ms = cuda_ms(lambda v: F.pixel_shuffle(F.conv2d(v, w16, b16, padding=1), 4), x)
        records.append(("conv3x3_pixelshuffle", "ntire2022_esr_tpu_torch/csrc/tail.cu",
                        "ntire2022_esr_tpu/ops/pallas/tail.py:71", macs, nbytes,
                        ms, plain_ms, lib_ms))
        x_tail = x
    kernels = []
    for kname, src, replaces, macs, nbytes, ms, plain_ms, lib_ms in records:
        t_ops = 2 * macs / PEAK_F16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        print(f"   {kname}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, "
              f"bound {bound:.3f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}: "
              f"{2 * macs / 1e9:.1f} GFLOP at the f16 tensor-core rate {t_ops:.3f} ms, "
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

    # the f32 CUDA-core path under parity, beside cuDNN f32 (TF32 off) ----
    f32_rows = []
    with config.numerics_mode("parity"), torch.inference_mode():
        x = x_chain.float()
        del x_chain
        convs = (model.B1.c1_r, model.B1.c2_r, model.B1.c3_r)
        ws, bs = [c.weight for c in convs], [c.bias for c in convs]

        def chain_cudnn_f32(x):
            h = x
            for w, b in zip(ws, bs):
                h = F.leaky_relu(F.conv2d(h, w, b, padding=1), 0.05)
            return h + x

        out = conv_chain.fused_conv3x3_chain(x, ws, bs)
        compare(f"chain f32 (batch {TIME_BATCH})", out, conv_chain.conv3x3_chain_plain(x, ws, bs),
                "parity")
        del out
        c = CHAIN_WIDTHS
        f32_rows.append(("conv3x3_chain 46->48->48->46", 9 * sum(c[k] * c[k + 1] for k in range(3)),
                         (c[0] + c[-1]) * 4, ws, bs,
                         cuda_ms(conv_chain.fused_conv3x3_chain, x, ws, bs),
                         cuda_ms(conv_chain.conv3x3_chain_plain, x, ws, bs),
                         cuda_ms(chain_cudnn_f32, x)))
        del x
        for cin in (46, SKELETON_NF):  # RLFN's tail, then the skeleton's upsampler
            if cin == 46:
                x, w, b = x_tail.float(), model.upsampler[0].weight, model.upsampler[0].bias
                del x_tail
            else:  # the input drawn on the card: numpy would take seconds at this size
                _, w, b = random_tail((1, 8, 8, cin), 3, 4, seed=8)
                gen = torch.Generator(device=dev).manual_seed(8)
                x = torch.randn((TIME_BATCH, cin, SIZE, SIZE), generator=gen, device=dev) * 8
                x = x.contiguous(memory_format=torch.channels_last)
            out = tail.fused_conv3x3_pixelshuffle(x, w, b)
            compare(f"tail f32 {cin}->48 (batch {TIME_BATCH})", out,
                    tail.conv3x3_pixelshuffle_plain(x, w, b), "parity")
            del out
            f32_rows.append((f"conv3x3_pixelshuffle {cin}->48 r=4", 9 * cin * 48,
                             (cin + 48) * 4, [w], [b],
                             cuda_ms(tail.fused_conv3x3_pixelshuffle, x, w, b),
                             cuda_ms(tail.conv3x3_pixelshuffle_plain, x, w, b),
                             cuda_ms(lambda v: F.pixel_shuffle(F.conv2d(v, w, b, padding=1), 4), x)))
            del x
    f32_json = []
    for tag, macs_px, bytes_px, ws_, bs_, ms, plain_ms, lib_ms in f32_rows:
        macs = macs_px * npix
        nbytes = bytes_px * npix + sum(t.numel() * 4 for t in ws_ + bs_)
        t_ops, t_bytes = 2 * macs / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        print(f"   {tag} [parity, f32 CUDA cores]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"cuDNN f32 (TF32 off) {lib_ms:.3f} ms, f32 bound {bound:.3f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}: {2 * macs / 1e9:.1f} GFLOP at "
              f"67 TFLOP/s {t_ops:.3f} ms, {nbytes / 1e6:.1f} MB {t_bytes:.3f} ms) = "
              f"{bound / ms:.1%} of the bound; on {smi}")
        f32_json.append({"kernel": tag, "tier": "parity", "ms": ms, "plain_ms": plain_ms,
                         "cudnn_f32_ms": lib_ms, "bound_ms": bound,
                         "bound_by": "operations" if t_ops >= t_bytes else "bytes"})
    print(json.dumps({"f32_rows": f32_json}))
    print(f"   phase 6 with the f32 rows: {time.perf_counter() - t0:.1f} s")

    # 7. challenge protocol ---------------------------------------------------
    t0 = phase("7. challenge protocol (harness.cli, runner, x8, tiling; model 04)")
    protocol_phase(model, dr, smi)
    print(f"   phase 7: {time.perf_counter() - t0:.1f} s")

    # 8. the zoo ------------------------------------------------------------
    t0 = phase(f"8. the RFDN skeleton and IMDN family ({len(ZOO_IDS)} models)")
    zoo = zoo_phase(smi)
    print(json.dumps({"zoo": zoo}))
    print(f"   phase 8: {time.perf_counter() - t0:.1f} s")
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
