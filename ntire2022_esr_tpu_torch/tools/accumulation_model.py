#!/usr/bin/env python3
"""How the split-TF32 kernels' ways of summing compare, in a model of the
tensor cores' truncating accumulation, on the CPU.

    python3 ntire2022_esr_tpu_torch/tools/accumulation_model.py [--outputs N] [--seed S]

One output of a 3x3 conv at 48 channels is a sum of K = 432 products.
``mma.sync.m16n8k8.tf32`` adds 8 exact products to its f32 accumulator per
k-step; the model aligns the accumulator and the products to the largest
of their exponents, truncates each to 23 + ``extra`` bits below it, sums,
and truncates the result to 24 bits (round toward zero). It prints the
largest error over N outputs (numpy seed S: activations 4 * randn,
weights 0.05 * randn) against the exact sum, beside a sequential f32 FMA
chain rounded to nearest, for:

- ``hi/lo``: a_hi * w_hi into one set, a_hi * w_lo and a_lo * w_hi into a
  second, each over all 54 k-steps, added at the end;
- ``per tap``: the 3 products of each tap (6 k-steps) into a fresh set,
  added to the running sum with an f32 add rounded to nearest (the
  kernels' choice: ``csrc/wgmma_chain.cuh`` ``unit_mmas``, which the
  split-TF32 chain and the per-tap form of ``csrc/tail.cu``
  ``conv3x3_pixelshuffle_wgmma_tf32_kernel`` take);
- ``per 3 taps``: the same with a fresh set every 3 taps (18 k-steps), a
  scheme with a third of the waits, which no kernel takes;

and at the tail's 3 input channels (K = 27 products, against an FMA chain
over them):

- ``folded``: the wgmma kernel's folded form, K = 9 cin (tap, channel)
  pairs padded to 32, each k-step's 3 products into a fresh set;
- ``folded over 4 k-steps``: all 27 products into one fresh set (the
  form first built, which the kernel no longer takes);
- ``per tap``: each tap's 3 products (padded to a k-chunk of 16, 2
  k-steps) into a fresh set, as the per-tap form takes them.

A model, not the card: the card's own errors are printed by
``chip_smoke.py`` phases 2 and 3 against an f64 conv.
"""

from __future__ import annotations

import argparse

import numpy as np

K, TAP, STEP = 432, 48, 8


def tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32, to nearest with ties away (cvt.rna.tf32.f32)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mma_step(acc: np.ndarray, prods: np.ndarray, extra: int) -> np.ndarray:
    """acc + sum(prods) as the model of one k-step adds them."""
    top = np.maximum(np.abs(acc), np.abs(prods).max(1)).astype(np.float64)
    q = 2.0 ** (np.floor(np.log2(np.where(top > 0, top, 1.0))) - 23 - extra)
    t = np.trunc(acc / q) * q + (np.trunc(prods / q[:, None]) * q[:, None]).sum(1)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(t), 1e-300))) - 23)
    return (np.trunc(t / ulp) * ulp).astype(np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--outputs", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rs = np.random.RandomState(args.seed)
    a = (rs.randn(args.outputs, K) * 4).astype(np.float32)
    w = (rs.randn(K) * 0.05).astype(np.float32)
    exact = (a.astype(np.float64) * w.astype(np.float64)).sum(1)
    ah, wh = tf32(a), tf32(w)
    al, wl = tf32(a - ah), tf32(w - wh)

    def prods(x, y, s):
        return x[:, s:s + STEP].astype(np.float64) * y[s:s + STEP].astype(np.float64)

    def err(v):
        return float(np.abs(np.asarray(v, np.float64) - exact).max())

    fma = np.zeros(args.outputs, np.float32)
    for k in range(K):
        fma = (fma.astype(np.float64) + a[:, k].astype(np.float64) * w[k]).astype(np.float32)
    e_fma = err(fma)
    print(f"sequential f32 FMA chain: max error {e_fma:.3e}")
    for extra in (0, 3):
        hi = np.zeros(args.outputs, np.float32)
        lo = np.zeros(args.outputs, np.float32)
        for s in range(0, K, STEP):
            hi = mma_step(hi, prods(ah, wh, s), extra)
            lo = mma_step(lo, prods(ah, wl, s), extra)
            lo = mma_step(lo, prods(al, wh, s), extra)
        e_hilo = err(hi.astype(np.float64) + lo)
        total = np.zeros(args.outputs, np.float32)
        for t0 in range(0, K, TAP):
            acc = np.zeros(args.outputs, np.float32)
            for s in range(t0, t0 + TAP, STEP):
                for x, y in ((ah, wh), (ah, wl), (al, wh)):
                    acc = mma_step(acc, prods(x, y, s), extra)
            total = (total.astype(np.float64) + acc).astype(np.float32)
        e_tap = err(total)
        print(f"{extra} extra alignment bits: hi/lo {e_hilo:.3e} ({e_hilo / e_fma:.2f}x the FMA "
              f"chain), per tap {e_tap:.3e} ({e_tap / e_fma:.2f}x)")
        e_3 = err(fresh_sums(a, w, 3 * TAP, extra))
        print(f"{extra} extra alignment bits: per 3 taps {e_3:.3e} ({e_3 / e_fma:.2f}x the FMA "
              f"chain)")
    # the tail at 3 input channels: 27 products a sum
    a3, w3 = a[:, :27], w[:27]
    exact3 = (a3.astype(np.float64) * w3.astype(np.float64)).sum(1)
    fma3 = np.zeros(args.outputs, np.float32)
    for k in range(27):
        fma3 = (fma3.astype(np.float64) + a3[:, k].astype(np.float64) * w3[k]).astype(np.float32)
    e_fma3 = float(np.abs(fma3 - exact3).max())
    print(f"K = 27 (3 channels in): sequential f32 FMA chain: max error {e_fma3:.3e}")
    for extra in (0, 3):
        pad = lambda v, c: np.pad(v.reshape(*v.shape[:-1], 9, 3),  # noqa: E731
                                  [(0, 0)] * (v.ndim - 1) + [(0, 0), (0, c - 3)]).reshape(
                                      *v.shape[:-1], 9 * c)
        a32, w32 = np.pad(a3, ((0, 0), (0, 5))), np.pad(w3, (0, 5))
        e_fold = float(np.abs(fresh_sums(a32, w32, STEP, extra) - exact3).max())
        e_fold4 = float(np.abs(fresh_sums(a32, w32, 4 * STEP, extra) - exact3).max())
        e_tap3 = float(np.abs(fresh_sums(pad(a3, 16), pad(w3, 16), 16, extra) - exact3).max())
        print(f"{extra} extra alignment bits at K = 27: folded {e_fold:.3e} "
              f"({e_fold / e_fma3:.2f}x the FMA chain), folded over 4 k-steps {e_fold4:.3e} "
              f"({e_fold4 / e_fma3:.2f}x), per tap on 16-channel chunks "
              f"{e_tap3:.3e} ({e_tap3 / e_fma3:.2f}x)")
    return 0


def fresh_sums(a: np.ndarray, w: np.ndarray, group: int, extra: int) -> np.ndarray:
    """a . w with the 3 split-TF32 products of every ``group`` values of K
    (a multiple of 8) summed by the model's k-steps into a fresh set, the
    sets added in f32, rounded to nearest."""
    ah, wh = tf32(a), tf32(w)
    al, wl = tf32(a - ah), tf32(w - wh)
    total = np.zeros(a.shape[0], np.float32)
    for g0 in range(0, a.shape[1], group):
        acc = np.zeros(a.shape[0], np.float32)
        for s in range(g0, g0 + group, STEP):
            for x, y in ((ah, wh), (ah, wl), (al, wh)):
                acc = mma_step(acc, x[:, s:s + STEP].astype(np.float64)
                               * y[s:s + STEP].astype(np.float64), extra)
        total = (total.astype(np.float64) + acc).astype(np.float32)
    return total


if __name__ == "__main__":
    raise SystemExit(main())
