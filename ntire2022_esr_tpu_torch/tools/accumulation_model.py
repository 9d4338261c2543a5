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
  kernels' choice, ``csrc/mma_stage.cuh`` ``mma_tap_tf32``).

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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
