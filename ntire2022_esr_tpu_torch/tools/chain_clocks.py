#!/usr/bin/env python3
"""Where one block of a tensor-core kernel spends its clocks.

    python3 ntire2022_esr_tpu_torch/tools/chain_clocks.py [--kernel KERNEL] [--tier TIER]
                                                          [--variant NAME ...]

The card offers no kernel profiler where this repository is measured, so
this script makes a copy of the package under ``build/chain_clocks/``,
inserts clock reads around the phases of the kernel (text patches
of its source; it fails if an anchor is gone), builds the copy and runs it
at (32, 256, 256, 46) under ``--tier`` (the m16n8k16 kernels: fasthi16,
the default, two f16 products; fast16 and fast, one f16 or bf16 product)
or parity (the split-TF32 kernels) with random weights (numpy seed 3). It
prints the clocks that warp 1 of one interior block spent in each phase.

``--kernel chain`` (default): ``conv3x3_chain_mma_kernel`` at RLFN's widths
46 -> 48 -> 48 -> 46: the window load, the main loop and, inside it, the
barriers, the MMA steps (of which: inside the row calls, and those with a
full set of m-tiles), the epilogues; and the output copy.

``--kernel tail``: ``conv3x3_pixelshuffle_mma_kernel`` at 46 -> 48, r = 4,
as the mean over the tiles that one block walks over: the wait for the
window, re-laying it, the wait until the last tile's tensor store has
read the result (thread 0's), the barrier before the MMAs, the request
for the next window (thread 0's), the MMA rows, the epilogues, the barrier
before the copy-out, and the copy-out (plain stores, or thread 0 issuing
the tensor store); for warps 0 and 1.

``--kernel chain_tf32``: ``conv3x3_chain_tf32_kernel`` (f32 activations,
three split-TF32 products) at the chain's widths, as ``chain``: the window
load, the main loop and, inside it, the barriers, the MMA taps and the
epilogues; the output copy.

``--kernel tail_tf32``: ``conv3x3_pixelshuffle_tf32_kernel`` (f32) at
46 -> 48, r = 4, as the mean over the tiles that one block walks over: the
barriers before the taps, the MMA taps, the epilogues, the barrier before
the copy-out, the copy-out (plain stores, or thread 0 issuing the tensor
store) and the next window's load; for warps 0 and 1.

A variant removes one thing from the copy to show what it costs (results
are then wrong, times still meaningful): ``nob`` the B-fragment loads,
``noa`` the A-fragment loads, ``noload`` both, ``nomma`` the MMAs,
``nofetch`` (chain only) the ``cp.async`` of the next row's weights; or
changes one constant: ``mt4`` gives a warp 4 m-tiles under one product
(``kMT1``, fast16 and fast; results stay right). The split-TF32 kernels
take ``base``, ``noload``, ``nomma`` and (chain_tf32) ``nofetch``.
Default: ``base``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PKG = "ntire2022_esr_tpu_torch"
NAMES = ["window", "main loop", "  barriers", "  mma steps", "  epilogues", "final barrier",
         "output", "  (row calls)", "  (row calls, a full set of m-tiles)"]
TOTAL = (0, 1, 5, 6)  # the phases that add up to the block
TAIL_NAMES = ["window wait", "re-lay", "wait for the last stores", "barrier before the MMAs",
              "window request", "mma rows", "epilogues", "barrier before the copy-out", "copy-out"]

# (anchor, replacement) pairs for csrc/conv_chain.cu
PATCHES = [
    ("namespace esr {\n",
     "namespace esr {\n__device__ long long g_prof[16];\n"
     "#define PROF (blockIdx.x == 37 && blockIdx.y == 1 && threadIdx.x == 32)\n"),
    ("  Cursor cur{0, 0, 0, 0};\n",
     "  long long tp0 = clock64(), tsync = 0, tmma = 0, tepi = 0, trow = 0, trow3 = 0;\n"
     "  Cursor cur{0, 0, 0, 0};\n"),
    ("  float acc[P][MT][kNtChunk][4];",
     "  long long tp1 = clock64();\n  float acc[P][MT][kNtChunk][4];"),
    ("    cp_async_wait_all();\n    __syncthreads();  // this step",
     "    long long ta = clock64();\n    cp_async_wait_all();\n    __syncthreads();  // this step"),
    ("    Cursor nxt = cur;\n", "    long long tb = clock64(); tsync += tb - ta;\n    Cursor nxt = cur;\n"),
    ("    const uint32_t* src = abuf(cur.k);\n",
     "    const long long td = clock64();\n    const uint32_t* src = abuf(cur.k);\n"),
    ("    if (cur.ky == 2) {\n",
     "    long long tc = clock64(); tmma += tc - tb; trow += tc - td; if (cnt == MT) trow3 += tc - td;\n"
     "    if (cur.ky == 2) {\n"),
    ("    cur = nxt;\n    st = nst;\n", "    tepi += clock64() - tc;\n    cur = nxt;\n    st = nst;\n"),
    ("  __syncthreads();\n\n  // the finished tile",
     "  long long tp2 = clock64();\n  __syncthreads();\n  long long tp3 = clock64();\n\n  // the finished tile"),
]
KERNEL_END = ("      os[gp * cout + co] = y;\n    }\n  }\n}\n",
              "      os[gp * cout + co] = y;\n    }\n  }\n"
              "  if (PROF) { g_prof[0] = tp1 - tp0; g_prof[1] = tp2 - tp1; g_prof[2] = tsync; "
              "g_prof[3] = tmma; g_prof[4] = tepi; g_prof[5] = tp3 - tp2; g_prof[6] = clock64() - tp3; "
              "g_prof[7] = trow; g_prof[8] = trow3; }\n}\n")
# and for csrc/tail.cu: sums over the tiles that one block walks over, in 32-bit
# clocks and counters (nine 64-bit counters cost the kernel registers that it
# then spills in its MMA loop)
TAIL_PATCHES = [
    ("namespace esr {\n",
     "namespace esr {\n__device__ long long g_prof[32];\n"
     "#define PROF (blockIdx.x == 37 && threadIdx.x % 32 == 0 && threadIdx.x < 64)\n"
     "#define NOW static_cast<unsigned>(clock())\n"),
    ("  for (; tl < total; tl += gridDim.x) {\n    int n, ty0, tx0;\n",
     "  unsigned pf[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};\n  int ntile = 0;\n"
     "  for (; tl < total; tl += gridDim.x) {\n    const unsigned c0 = NOW;\n"
     "    ++ntile;\n    int n, ty0, tx0;\n"),
    ("      mbar_wait(bar, phase);\n",
     "      mbar_wait(bar, phase);\n      pf[0] += NOW - c0;\n"),
    ("    cp_async_wait_all();\n    if (store_pending) bulk_wait_read();\n",
     "    const unsigned c2 = NOW;\n    pf[1] += c2 - c0;\n"
     "    cp_async_wait_all();\n    if (store_pending) bulk_wait_read();\n"
     "    const unsigned c2b = NOW;\n    pf[2] += c2b - c2;\n"),
    ("    for (int pass = 0; pass < gm.passes; ++pass) {\n",
     "    const unsigned c4 = NOW;\n    pf[4] += c4 - c3;\n    unsigned cm = c4;\n"
     "    for (int pass = 0; pass < gm.passes; ++pass) {\n"),
    ("    if (tensor_in && threadIdx.x == 0 && tl + gridDim.x < total) request_window(tl + gridDim.x);\n",
     "    const unsigned c3 = NOW;\n    pf[3] += c3 - c2b;\n"
     "    if (tensor_in && threadIdx.x == 0 && tl + gridDim.x < total) request_window(tl + gridDim.x);\n"),
    ("        // epilogue on the accumulators: this lane holds, of each m-tile,\n",
     "        const unsigned ce = NOW;\n        pf[5] += ce - cm;\n"
     "        // epilogue on the accumulators: this lane holds, of each m-tile,\n"),
    ("        }\n      }\n    }\n\n    // the finished tile to device memory",
     "        }\n        cm = NOW;\n        pf[6] += cm - ce;\n      }\n    }\n"
     "    const unsigned c5 = NOW;\n\n    // the finished tile to device memory"),
    ("    __syncthreads();  // the result is whole, and the window is free again\n",
     "    __syncthreads();\n    const unsigned c6 = NOW;\n    pf[7] += c6 - c5;\n"),
    ("      copy_out_rows<unsigned short>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);\n"
     "    }\n  }\n",
     "      copy_out_rows<unsigned short>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);\n"
     "    }\n    pf[8] += NOW - c6;\n  }\n"
     "  if (PROF) {\n    pf[1] -= pf[0];\n"
     "    for (int i = 0; i < 9; ++i) g_prof[threadIdx.x / 2 + i] = pf[i];\n"
     "    g_prof[threadIdx.x / 2 + 9] = ntile;\n  }\n"),
]
# and for conv3x3_chain_tf32_kernel in csrc/conv_chain.cu (the first patch of
# PATCHES declares the counters)
PATCHES32 = [
    PATCHES[0],
    ("  Cursor32 at{0, 0, 0, 0};\n",
     "  long long tp0 = clock64(), tsync = 0, tmma = 0, tepi = 0;\n  Cursor32 at{0, 0, 0, 0};\n"),
    ("  float sum[kMT32][kNtChunk][4];  // this warp's running sums of the pass\n  int mt0 = 0,",
     "  long long tp1 = clock64();\n  float sum[kMT32][kNtChunk][4];\n  int mt0 = 0,"),
    ("    cp_async_wait_all();\n    __syncthreads();  // this tap's",
     "    long long ta = clock64();\n    cp_async_wait_all();\n    __syncthreads();  // this tap's"),
    ("    Cursor32 nxt = at;\n", "    long long tb = clock64(); tsync += tb - ta;\n    Cursor32 nxt = at;\n"),
    ("    if (at.tap == 8) {\n", "    long long tc = clock64(); tmma += tc - tb;\n    if (at.tap == 8) {\n"),
    ("    at = nxt;\n    st = nst;\n", "    tepi += clock64() - tc;\n    at = nxt;\n    st = nst;\n"),
    ("  __syncthreads();\n\n  // out with the finished tile",
     "  long long tp2 = clock64();\n  __syncthreads();\n  long long tp3 = clock64();\n\n"
     "  // out with the finished tile"),
    ("      out[gp * cout + co] = Act<T>::store(y);\n    }\n  }\n}\n",
     "      out[gp * cout + co] = Act<T>::store(y);\n    }\n  }\n"
     "  if (PROF) { g_prof[0] = tp1 - tp0; g_prof[1] = tp2 - tp1; g_prof[2] = tsync; "
     "g_prof[3] = tmma; g_prof[4] = tepi; g_prof[5] = tp3 - tp2; g_prof[6] = clock64() - tp3; }\n}\n"),
]
NAMES32 = ["window", "main loop", "  barriers", "  mma taps", "  epilogues", "final barrier", "output"]
# and for conv3x3_pixelshuffle_tf32_kernel in csrc/tail.cu (the first patch of
# TAIL_PATCHES declares the counters)
TAIL32_PATCHES = [
    TAIL_PATCHES[0],
    ("  int j = 0;  // weight steps of this block so far: step j reads wbuf(j)\n",
     "  unsigned pf[6] = {0, 0, 0, 0, 0, 0};\n  int ntile = 0;\n"
     "  int j = 0;  // weight steps of this block so far: step j reads wbuf(j)\n"),
    ("    const bool more = tl + static_cast<int>(gridDim.x) < total;\n",
     "    ++ntile;\n    const bool more = tl + static_cast<int>(gridDim.x) < total;\n"),
    ("      cp_async_wait_all();\n      __syncthreads();  // this tap's weights (and, at s = 0",
     "      const unsigned c0 = NOW;\n      cp_async_wait_all();\n      __syncthreads();  "
     "// this tap's weights (and, at s = 0"),
    ("      const int ky = tap / 3, kx = tap - 3 * ky;\n",
     "      const unsigned cm = NOW;\n      pf[0] += cm - c0;\n      const int ky = tap / 3, kx = tap - 3 * ky;\n"),
    ("      if (tap != 8 || cnt == 0) continue;\n",
     "      const unsigned ce = NOW;\n      pf[1] += ce - cm;\n      if (tap != 8 || cnt == 0) continue;\n"),
    ("      }\n    }\n\n    if (out_rank) fence_async_proxy();\n"
     "    __syncthreads();  // every warp is done with the window, and the result is whole\n",
     "      }\n      pf[2] += NOW - ce;\n    }\n\n    const unsigned c5 = NOW;\n"
     "    if (out_rank) fence_async_proxy();\n"
     "    __syncthreads();  // every warp is done with the window, and the result is whole\n"
     "    const unsigned c6 = NOW;\n    pf[3] += c6 - c5;\n"),
    ("    tl += gridDim.x;\n    if (more) {\n",
     "    const unsigned c7 = NOW;\n    pf[4] += c7 - c6;\n    tl += gridDim.x;\n    if (more) {\n"),
    ("      load_window_f32(x, n, h, wd, cin, ty0 - 1, tx0 - 1, gm.hi, gm.wi, gm.sw, gm.kc, win);\n"
     "    }\n  }\n  if (store_pending) bulk_wait_read();  // before the shared memory goes\n}\n",
     "      load_window_f32(x, n, h, wd, cin, ty0 - 1, tx0 - 1, gm.hi, gm.wi, gm.sw, gm.kc, win);\n"
     "    }\n    pf[5] += NOW - c7;\n  }\n"
     "  if (store_pending) bulk_wait_read();  // before the shared memory goes\n"
     "  if (PROF) {\n    for (int i = 0; i < 6; ++i) g_prof[threadIdx.x / 2 + i] = pf[i];\n"
     "    g_prof[threadIdx.x / 2 + 9] = ntile;\n  }\n}\n"),
]
TAIL32_NAMES = ["barriers", "mma taps", "epilogues", "barrier before the copy-out", "copy-out",
                "next window"]
READER = ('\nextern "C" int read_prof(long long* dst) {\n  return static_cast<int>('
          'cudaMemcpyFromSymbol(dst, esr::g_prof, sizeof(esr::g_prof)));\n}\n')

B_LOAD = "if (n + 1 < NTL || more) b_next = wrow[(s * NTL + n + 1) * 32];"
A_LOAD = "for (int m = 0; m < CNT; ++m) ldmatrix_x4(fr_next[m], a + m * 16 * sw);"
A_KEEP = "for (int m = 0; m < CNT; ++m) for (int i = 0; i < 4; ++i) fr_next[m][i] = fr[m][i];"
MMAS = ("      for (int m = 0; m < CNT; ++m) mma_terms<T, P>(acc[0][m][n], acc[P - 1][m][n], fr[m], b);\n"
        "      b = b_next;")
NO_MMAS = ("      for (int m = 0; m < CNT; ++m)\n"
           '        asm volatile("" ::"r"(fr[m][0]), "r"(fr[m][1]), "r"(fr[m][2]), "r"(fr[m][3]), '
           '"r"(b.x), "r"(b.y));\n      b = b_next;')
FETCH = "      if (nxt.k < depth) fetch_weights<P>(wbuf(j + 1), wq, nst, nxt);\n"
MT1 = "constexpr int kMT1 = 3;"
A32_LOAD0 = ("      u[m] = *reinterpret_cast<const float4*>(a + m * 16 * sw);\n"
             "      v[m] = *reinterpret_cast<const float4*>(a + (m * 16 + 8) * sw);\n")
A32_KEEP0 = ("      u[m] = make_float4(1.f, __int_as_float(m), 2.f, 3.f);\n"
             "      v[m] = make_float4(__int_as_float(m), 4.f, 5.f, 6.f);\n")
A32_LOAD = ("          u[m] = *reinterpret_cast<const float4*>(a + m * 16 * sw + (kc + 1) * 16);\n"
            "          v[m] = *reinterpret_cast<const float4*>(a + (m * 16 + 8) * sw + (kc + 1) * 16);\n")
A32_KEEP = ("          u[m] = make_float4(__int_as_float(kc), 1.f, __int_as_float(m), 2.f);\n"
            "          v[m] = make_float4(3.f, __int_as_float(m), 4.f, __int_as_float(kc));\n")
B32_LOAD = "        const uint4 bh = wk[n * 64], bl = wk[n * 64 + 32];\n"
B32_KEEP = "        const uint4 bh = make_uint4(n, kc, 3, 4), bl = make_uint4(kc, n, 4, 3);\n"
MMAS32 = ("              mma_m16n8k8_tf32(acc[m][n], x0, x1, x2, x3, h0, h1);\n"
          "              if (P >= 2) mma_m16n8k8_tf32(acc[m][n], x0, x1, x2, x3, l0, l1);\n")
NO_MMAS32 = ('              asm volatile("" ::"r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(h0), "r"(h1), '
             '"r"(l0), "r"(l1));\n')
MMAS32_LO = "                mma_m16n8k8_tf32(acc[m][n], y0, y1, y2, y3, h0, h1);\n"
NO_MMAS32_LO = '                asm volatile("" ::"r"(y0), "r"(y1), "r"(y2), "r"(y3));\n'
FETCH32 = "    if (nxt.k < depth) fetch_tap(wbuf(j + 1), wq, nst, nxt);"
# variant -> patches of (file, anchor, replacement)
VARIANTS = {
    "base": [],
    "nob": [("mma_stage.cuh", B_LOAD, "")],
    "noa": [("mma_stage.cuh", A_LOAD, A_KEEP)],
    "noload": [("mma_stage.cuh", B_LOAD, ""), ("mma_stage.cuh", A_LOAD, A_KEEP)],
    "nomma": [("mma_stage.cuh", MMAS, NO_MMAS)],
    "nofetch": [("conv_chain.cu", FETCH, "")],
    "mt4": [("mma_stage.cuh", MT1, MT1.replace("3", "4"))],
}
# the same for the split-TF32 kernels
VARIANTS32 = {
    "base": [],
    "noload": [("mma_stage.cuh", A32_LOAD0, A32_KEEP0), ("mma_stage.cuh", A32_LOAD, A32_KEEP),
               ("mma_stage.cuh", B32_LOAD, B32_KEEP)],
    "nomma": [("mma_stage.cuh", MMAS32, NO_MMAS32), ("mma_stage.cuh", MMAS32_LO, NO_MMAS32_LO)],
    "nofetch": [("conv_chain.cu", FETCH32, "")],
}
MMA_TIERS = ["fasthi16", "fast16", "fast"]
KERNELS = {  # --kernel -> (library, patches of the kernel, variants)
    "chain": ("conv_chain", PATCHES + [KERNEL_END], VARIANTS),
    "tail": ("tail", TAIL_PATCHES, VARIANTS),
    "chain_tf32": ("conv_chain", PATCHES32, VARIANTS32),
    "tail_tf32": ("tail", TAIL32_PATCHES, VARIANTS32),
}


def patch(path: str, pairs) -> None:
    with open(path) as fh:
        text = fh.read()
    for anchor, new in pairs:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{path}: anchor not found exactly once: {anchor!r}")
        text = text.replace(anchor, new)
    with open(path, "w") as fh:
        fh.write(text)


def instrument(csrc: str, kernel: str, variant: str) -> str:
    """Patch the sources under ``csrc`` in place for ``kernel`` and
    ``variant``; returns the name of the library that holds the kernel."""
    source, patches, variants = KERNELS[kernel]
    patch(os.path.join(csrc, f"{source}.cu"), patches)
    with open(os.path.join(csrc, f"{source}.cu"), "a") as fh:
        fh.write(READER)
    for fname, anchor, new in variants[variant]:
        patch(os.path.join(csrc, fname), [(anchor, new)])
    return source


def run_variant(kernel: str, variant: str, tier: str) -> int:
    """Child process: build the patched copy and print its clocks."""
    dst = os.path.join(REPO, "build", "chain_clocks", f"{kernel}_{tier}_{variant}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    source = instrument(os.path.join(dst, PKG, "csrc"), kernel, variant)
    sys.path.insert(0, dst)
    import torch
    from ntire2022_esr_tpu_torch import config, ops
    from ntire2022_esr_tpu_torch.ops.kernels import build, conv_chain, tail

    rs = np.random.RandomState(3)
    is_chain = kernel.startswith("chain")
    chans = [(46, 48), (48, 48), (48, 46)] if is_chain else [(46, 48)]
    x = rs.standard_normal((32, 256, 256, 46)).astype(np.float32) * 8
    x = ops.from_nhwc(torch.from_numpy(x).cuda()).to(config._MODES[tier].activation_dtype)
    ws = [torch.from_numpy(rs.standard_normal((co, ci, 3, 3)).astype(np.float32) * 0.05).cuda()
          for ci, co in chans]
    bs = [torch.from_numpy(rs.standard_normal(co).astype(np.float32) * 0.1).cuda()
          for _, co in chans]
    with config.numerics_mode(tier), torch.inference_mode():
        for _ in range(3):
            if is_chain:
                conv_chain.fused_conv3x3_chain(x, ws, bs)
            else:
                tail.fused_conv3x3_pixelshuffle(x, ws[0], bs[0], r=4)
        torch.cuda.synchronize()
    lib = build.load(source)
    buf = (ctypes.c_longlong * 32)()
    build.check(lib, lib.read_prof(buf), "read_prof")
    if kernel == "chain_tf32":
        print(f"chain_tf32 {variant} (one block): "
              + ", ".join(f"{n.strip()} {buf[i]}" for i, n in enumerate(NAMES32))
              + f"; block total {sum(buf[i] for i in (0, 1, 5, 6))} clocks", flush=True)
    elif kernel == "tail_tf32":
        for warp in (0, 1):
            v = buf[16 * warp:16 * warp + 10]
            print(f"tail_tf32 {variant} (warp {warp}, mean of {v[9]} tiles of one block): "
                  + ", ".join(f"{n} {v[i] / v[9]:.0f}" for i, n in enumerate(TAIL32_NAMES))
                  + f"; total {sum(v[:6]) / v[9]:.0f} clocks", flush=True)
    elif kernel == "chain":
        print(f"chain [{tier}] {variant} (one block): "
              + ", ".join(f"{n.strip()} {buf[i]}" for i, n in enumerate(NAMES))
              + f"; block total {sum(buf[i] for i in TOTAL)} clocks", flush=True)
    else:
        for warp in (0, 1):  # thread 0 also asks for the windows and issues the stores
            v = buf[16 * warp:16 * warp + 10]
            print(f"tail [{tier}] {variant} (warp {warp}, mean of {v[9]} tiles of one block): "
                  + ", ".join(f"{n} {v[i] / v[9]:.0f}" for i, n in enumerate(TAIL_NAMES))
                  + f"; total {sum(v[:9]) / v[9]:.0f} clocks", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", default="chain", choices=sorted(KERNELS))
    ap.add_argument("--tier", default="fasthi16", choices=MMA_TIERS,
                    help="the m16n8k16 kernels' tier (the split-TF32 kernels run parity)")
    ap.add_argument("--variant", nargs="*", default=["base"], choices=sorted(VARIANTS))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.kernel.startswith("tail") and "nofetch" in args.variant:
        ap.error("nofetch is a variant of the chain kernels")
    missing = set(args.variant) - set(KERNELS[args.kernel][2])
    if missing:
        ap.error(f"{args.kernel} has no variant {sorted(missing)}")
    if "mt4" in args.variant and args.tier == "fasthi16":
        ap.error("mt4 changes the one-product kernels: --tier fast16 or fast")
    tier = "parity" if args.kernel.endswith("tf32") else args.tier
    if args.child:
        return run_variant(args.kernel, args.child, tier)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rc = 0
    for v in args.variant:  # one process each: a process loads one build of the library
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--kernel", args.kernel,
                              "--tier", args.tier, "--child", v]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
