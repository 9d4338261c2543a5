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

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
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


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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
        from ntire2022_esr_tpu_torch.harness import registry, serving
        from ntire2022_esr_tpu_torch.models import rlfn as rlfn_mod
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

    def plain_forward(u8: np.ndarray, tier: str) -> np.ndarray:
        with mock.patch.object(rlfn_mod, "fused_conv3x3_chain", conv_chain.conv3x3_chain_plain), \
                mock.patch.object(rlfn_mod, "fused_conv3x3_pixelshuffle",
                                  tail.conv3x3_pixelshuffle_plain), \
                config.numerics_mode(tier), torch.inference_mode():
            y = model(torch.from_numpy(u8).to(dev).float() / (255.0 / dr))
            return torch.round(y.clamp(0, dr) * (255.0 / dr)).to(torch.uint8).cpu().numpy()

    ref = np.concatenate([plain_forward(np.stack(frames[i:i + SERVE_BATCH]), srv.tier)
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
    pd = np.abs(pout.astype(np.int16) - plain_forward(np.stack(frames[:8]), "parity").astype(np.int16))
    print(f"   served vs plain forward on the card [parity]: max {int(pd.max())} levels")
    require(int(pd.max()) <= 1, "parity serving differs from the plain forward by more than 1 level")
    print(f"   phase 5: {time.perf_counter() - t0:.1f} s")

    # 6. times at the served shape -----------------------------------------
    t0 = phase(f"6. times at batch {TIME_BATCH}, {SIZE}x{SIZE}, fasthi16")
    records = []
    npix = TIME_BATCH * SIZE * SIZE
    with config.numerics_mode("fasthi16"), torch.inference_mode():
        x, ws, bs = chain_args(model, (TIME_BATCH, SIZE, SIZE, 46), torch.float16, seed=3)
        w16 = [w.half() for w in ws]
        b16 = [b.half() for b in bs]

        def chain_library():
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
        ms = cuda_ms(lambda: conv_chain.fused_conv3x3_chain(x, ws, bs))
        plain_ms = cuda_ms(lambda: conv_chain.conv3x3_chain_plain(x, ws, bs))
        lib_ms = cuda_ms(chain_library)
        records.append(("conv3x3_chain", "ntire2022_esr_tpu_torch/csrc/conv_chain.cu",
                        "ntire2022_esr_tpu/ops/pallas/conv_chain.py:166", macs, nbytes,
                        ms, plain_ms, lib_ms))
        del x

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
        ms = cuda_ms(lambda: tail.fused_conv3x3_pixelshuffle(x, w, b))
        plain_ms = cuda_ms(lambda: tail.conv3x3_pixelshuffle_plain(x, w, b))
        lib_ms = cuda_ms(lambda: F.pixel_shuffle(F.conv2d(x, w16, b16, padding=1), 4))
        records.append(("conv3x3_pixelshuffle", "ntire2022_esr_tpu_torch/csrc/tail.cu",
                        "ntire2022_esr_tpu/ops/pallas/tail.py:71", macs, nbytes,
                        ms, plain_ms, lib_ms))
        del x
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
