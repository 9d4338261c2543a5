#!/usr/bin/env python3
"""Where one block of a tensor-core kernel spends its clocks.

    python3 ntire2022_esr_tpu_torch/tools/chain_clocks.py [--kernel KERNEL] [--tier TIER]
                                                          [--variant NAME ...]
                                                          [--tail-widths CIN CHANNELS R]

The card offers no kernel profiler where this repository is measured, so
this script makes a copy of the package under ``build/chain_clocks/``,
inserts clock reads around the phases of the kernel (text patches
of its source; it fails if an anchor is gone), builds the copy and runs it
at (32, 256, 256, 46) under ``--tier`` (the 2-byte kernels: fasthi16,
the default, two f16 products; fast16 and fast, one f16 or bf16 product)
or parity (the split-TF32 kernels) with random weights (numpy seed 3). It
prints the clocks that one block spent in each phase.

``--kernel chain`` (default): ``conv3x3_chain_wgmma_kernel`` at RLFN's
widths 46 -> 48 -> 48 -> 46, for each warp of block 37 the mean over the
tiles that the block walks over: the wait for the tile's window, the MMAs
of each warpgroup's first m-block of a step (which wait for the step's
weights) and of its other m-blocks, issued and waited for, the epilogues,
the release of the step's weights (the last warp asks for the next
step's), the barriers at the ends of the stages, and the copy-out with the
request for the next window.

``--kernel tail``: ``conv3x3_pixelshuffle_wgmma_kernel`` (the 2-byte
plans with resident weights and the whole tile's result) at 46 -> 48,
r = 4 (or at ``--tail-widths CIN CHANNELS R``), for each warp of block 37
the mean over the tiles that the block walks over: the wait for the
window, re-laying it as planes, the barrier before the MMAs (with thread
0's wait until the last tile's tensor store has read the result), the
request for the next window and, at the first tile, the wait for the
weights, the MMAs of the warpgroup's first m-block and of its others,
issued and waited for, the epilogues, the barrier before the copy-out,
the copy-out (thread 0 issuing the tensor store, or the block's plain
stores), and the whole tile.

``--kernel tail_ring``: ``conv3x3_pixelshuffle_wgmma_ring_kernel`` (the
2-byte plans whose weights stream through the ring) at ``--tail-widths``
(64 256 2: the x2 upsampler 64 -> 256), the same per warp: the window's
wait, re-lay, barrier and request, the waits for each unit of weights,
each tap's MMAs of the warpgroup's m-blocks, issued and waited for, the
release of the units, the epilogues, the step barriers (before a step's
epilogue where one result buffer holds the steps, and after it, with
thread 0's wait for the step before's store), the copy-out (thread 0
issuing a step's tensor stores, or the block's plain stores), and the
whole tile. Widths whose plan runs the other 2-byte kernel are refused.

``--kernel chain_tf32``: ``conv3x3_chain_wgmma_tf32_kernel`` (f32
activations, three split-TF32 products) at RLFN's widths 46 -> 48 -> 48 ->
46, a 16x16 tile, for each warp of block 37 the mean over the tiles that
the block walks over: the window's load (the next tile's, and the barrier
after it), the waits for each unit's weights, the A loads, splits and MMA
issue, the waits for the MMAs, the adds into the running sums with the
release of the weights, the epilogues, the barriers at the ends of the
stages, the copy-out (thread 0 issuing the bulk stores) and the whole
tile.

``--kernel tail_tf32``: ``conv3x3_pixelshuffle_wgmma_tf32_kernel`` (f32,
three split-TF32 products, per tap) at 46 -> 48, r = 4 (or at
``--tail-widths``), for each warp of block 37 the mean over the tiles
that the block walks over: the window's load (with the barrier after it),
the waits for each unit's weights, the A loads, splits and MMA issue, the
waits for the MMAs, the adds into the running sums with the release of
the weights, the epilogues, the step barriers, the copy-out (thread 0
issuing each step's tensor stores) and the whole tile.

A variant removes one thing from the copy to show what it costs (results
are then wrong, times still meaningful). The chain: ``nomma`` the wgmma
instructions (their fences, groups and waits stay), ``noepi`` the
epilogues, ``nofetch`` the weights' bulk copies after the first step and
the waits for them, ``nowindow`` the next tile's window, ``noout`` the
copy-out; or ``wg1`` runs one warpgroup a block instead of three, which
drops the overlap of one warpgroup's epilogue with the others' MMAs
(results stay right). Both 2-byte tails: ``nomma``, ``noepi`` as the
chain's, ``norelay`` the re-lay of the window into planes, ``noout`` the
copy-out, ``wg1`` one warpgroup a block (results stay right).
Both split-TF32 kernels take ``base``, ``noload`` (the window's A loads
replaced by constants), ``nomma``, ``wg1`` (the chain: one warpgroup of
two m-blocks a pass, three times the passes) and ``kgunit`` (each unit's
k-steps issued as one group: 48 A registers under three products at
RLFN's width). Default: ``base``.
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
NAMES = ["window wait", "first m-block MMAs", "other MMAs", "epilogues", "release",
         "stage barriers", "copy-out"]
TAIL_NAMES = ["window wait", "re-lay", "barrier before the MMAs", "window request",
              "first MMAs", "other MMAs", "epilogues", "barrier before the copy-out", "copy-out"]
RING_NAMES = ["window wait", "re-lay", "barrier before the MMAs", "window request",
              "weight waits", "MMAs", "release", "epilogues", "step barriers", "copy-out"]
WARPS = 12  # warps of a block of the chain's wgmma kernel, at most

# (anchor, replacement) pairs for csrc/conv_chain.cu: clocks summed per warp
# of block 37 over the tiles it walks over, by section (global atomics from
# lane 0; slot 7 counts the tiles)
PATCHES = [
    ("namespace esr {\n",
     "namespace esr {\n__device__ unsigned long long g_prof[12 * 8];\n"
     "#define PROF_ADD(i, v) do { if (blockIdx.x == 37 && threadIdx.x % 32 == 0) "
     "atomicAdd(&g_prof[(threadIdx.x / 32) * 8 + (i)], "
     "static_cast<unsigned long long>(v)); } while (0)\n"),
    ("    mmas_first(d, wg);\n",
     "    const long long q0 = clock64();\n    mmas_first(d, wg);\n"
     "    const long long q1 = clock64();\n    PROF_ADD(1, q1 - q0);\n"),
    ("    mmas(d, mb);\n",
     "    const long long q0 = clock64();\n    mmas(d, mb);\n"
     "    const long long q1 = clock64();\n    PROF_ADD(2, q1 - q0);\n"),
    ("    epilogue(d, wg);\n", "    epilogue(d, wg);\n    PROF_ADD(3, clock64() - q1);\n"),
    ("    epilogue(d, mb);\n", "    epilogue(d, mb);\n    PROF_ADD(3, clock64() - q1);\n"),
    ("        auto release = [&]() {\n",
     "        auto release = [&]() {\n          const long long q0 = clock64();\n"),
    ("              if (fetch) fetch_step<P>(wbuf, bars, wq, cw, depth, tile, nk, nnc);\n"
     "            }\n          }\n          __syncwarp();\n",
     "              if (fetch) fetch_step<P>(wbuf, bars, wq, cw, depth, tile, nk, nnc);\n"
     "            }\n          }\n          __syncwarp();\n          PROF_ADD(4, clock64() - q0);\n"),
    ("    cp_async_wait();\n",
     "    const long long q0 = clock64();\n    cp_async_wait();\n"),
    ("    __syncthreads();  // the window is in place\n",
     "    __syncthreads();  // the window is in place\n"
     "    PROF_ADD(0, clock64() - q0);\n    PROF_ADD(7, 1);\n"),
    ("      fence_proxy_async();  // the next stage's MMAs read this stage's stores\n      __syncthreads();\n",
     "      const long long q1 = clock64();\n"
     "      fence_proxy_async();  // the next stage's MMAs read this stage's stores\n      __syncthreads();\n"
     "      PROF_ADD(5, clock64() - q1);\n"),
    ("    if (more && (depth & 1)) window(tl + gridDim.x);\n",
     "    const long long q2 = clock64();\n    if (more && (depth & 1)) window(tl + gridDim.x);\n"),
    ("      window(tl + gridDim.x);\n    }\n  }\n",
     "      window(tl + gridDim.x);\n    }\n    PROF_ADD(6, clock64() - q2);\n  }\n"),
]
# and for csrc/tail.cu: sums over the tiles that one block walks over, in 32-bit
# clocks and counters, 16 slots a warp (64-bit clocks cost the kernels
# registers); PROFW: every warp of block 37 of either wgmma kernel
TAIL_HEAD = ("namespace esr {\n",
             "namespace esr {\n__device__ long long g_prof[12 * 16];\n"
             "#define PROFW (blockIdx.x == 37 && threadIdx.x % 32 == 0)\n"
             "#define NOW static_cast<unsigned>(clock())\n")
WG_CALL = ("        tail_mmas<T, N>(d, a0 + static_cast<unsigned>(64 * (wg + WGS * i)) * 16, lbo,\n"
           "                        b0 + static_cast<unsigned>(nc * kTaps * gm.kc * N * 32), gm.wi, gm.kc);\n")
WG_EPI_LINE = "        epilogue(d, i, nc);\n"
TAIL_PATCHES = [
    TAIL_HEAD,
    ("  for (; tl < total; tl += gridDim.x) {\n    int n, ty0, tx0;\n    origin(tl, n, ty0, tx0);\n"
     "    if (tensor_in) {\n      // the boxes have landed, zeros where the image ends (torch's zero\n"
     "      // padding): re-lay them as planes.",
     "  unsigned pf[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n  int ntile = 0;\n"
     "  for (; tl < total; tl += gridDim.x) {\n    const unsigned c0 = NOW;\n    ++ntile;\n"
     "    bool firstrun = true;\n    int n, ty0, tx0;\n    origin(tl, n, ty0, tx0);\n"
     "    if (tensor_in) {\n      // the boxes have landed, zeros where the image ends (torch's zero\n"
     "      // padding): re-lay them as planes."),
    ("      mbar_wait(bars, phase);\n      phase ^= 1;\n",
     "      mbar_wait(bars, phase);\n      phase ^= 1;\n      pf[0] += NOW - c0;\n"),
    ("    if (store_pending) bulk_wait_read();\n    fence_proxy_async();  // the MMAs read the planes\n"
     "    __syncthreads();      // the planes are whole; raw and the result are free again\n",
     "    const unsigned c2 = NOW;\n    pf[1] += c2 - c0;\n"
     "    if (store_pending) bulk_wait_read();\n    fence_proxy_async();  // the MMAs read the planes\n"
     "    __syncthreads();      // the planes are whole; raw and the result are free again\n"
     "    const unsigned c3 = NOW;\n    pf[2] += c3 - c2;\n"),
    ("    if (!weights) {\n      mbar_wait(bars + 1, 0);\n      weights = true;\n    }\n",
     "    if (!weights) {\n      mbar_wait(bars + 1, 0);\n      weights = true;\n    }\n"
     "    pf[3] += NOW - c3;\n"),
    (WG_CALL, "        const unsigned m0 = NOW;\n" + WG_CALL
     + "        const unsigned m1 = NOW;\n        pf[firstrun ? 4 : 5] += m1 - m0;\n"
     "        firstrun = false;\n"),
    (WG_EPI_LINE, WG_EPI_LINE + "        pf[6] += NOW - m1;\n"),
    ("    if (tensor_out) fence_proxy_async();\n"
     "    __syncthreads();  // the result is whole, and the planes are free again\n",
     "    const unsigned c5 = NOW;\n    if (tensor_out) fence_proxy_async();\n"
     "    __syncthreads();  // the result is whole, and the planes are free again\n"
     "    const unsigned c6 = NOW;\n    pf[7] += c6 - c5;\n"),
    ("      copy_out_rows<unsigned short, kTailThreads>(res, out, row0, wd, run, r, tile.tw, npx, nrow,\n"
     "                                                  tx0);\n    }\n  }\n",
     "      copy_out_rows<unsigned short, kTailThreads>(res, out, row0, wd, run, r, tile.tw, npx, nrow,\n"
     "                                                  tx0);\n    }\n    const unsigned c7 = NOW;\n"
     "    pf[8] += c7 - c6;\n    pf[9] += c7 - c0;\n  }\n"
     "  if (PROFW) {\n    pf[1] -= pf[0];\n"
     "    for (int k = 0; k < 10; ++k) g_prof[(threadIdx.x / 32) * 16 + k] = pf[k];\n"
     "    g_prof[(threadIdx.x / 32) * 16 + 10] = ntile;\n  }\n"),
]
WR_WAIT_UNIT = "            const unsigned b = ring.wait();\n            const int ky = tap / 3;\n"
WR_CALL = ("            tap_issue<T, N, ND, MBR>(\n"
           "                d, nbq,\n"
           "                a0 + static_cast<unsigned>(WGS * 64 * MBR * q + ky * gm.wi + tap - 3 * ky) "
           "* 16,\n"
           "                static_cast<unsigned>(WGS * 64 * 16), lbo, b, gm.kc, tap == 0);\n")
WR_RELEASE = ("            if (tap > 0) {\n"
              "              wgmma_wait<1>();  // the tap before's MMAs are done, this tap's run on\n"
              "              ring.release_prev(active, fetch);  // every MMA of this warp has read it\n"
              "            }\n")
WR_LAST = ("        if (nbq > 0) {\n          wgmma_wait<0>();\n"
           "          ring.release_prev(active, fetch);\n        }\n")
WR_EPI_LINE = "          if (i < nbq) epilogue(d[i], MBR * q + i, nc, rb);\n"
WR_ONE_BUF_Q = ("        if (q == 0 && gm.nres == 1 && nc > 0) {\n"
                "          if (threadIdx.x == 0) bulk_wait_read();\n"
                "          __syncthreads();  // the step before has left the one result buffer\n"
                "        }\n#pragma unroll\n        for (int i = 0; i < MBR; ++i)\n")
WR_END = ("      if (out_mode != kOutPlain) fence_proxy_async();  // the tensor stores read the result\n"
          "      // two result buffers: the step before's store has read the one the\n"
          "      // next step writes\n"
          "      if (gm.nres == 2 && threadIdx.x == 0) bulk_wait_read();\n"
          "      __syncthreads();  // the step's result is whole (after the last: the planes are free "
          "again)\n"
          "      store_step(rb, tl, nc);\n")
WR_REQUEST = ("    if (tensor_in && threadIdx.x == 0 && tl + gridDim.x < total) "
              "request_window(tl + gridDim.x);\n")
RING_PATCHES = [
    TAIL_HEAD,
    ("  for (; tl < total; tl += gridDim.x) {\n    int n, ty0, tx0;\n    origin(tl, n, ty0, tx0);\n"
     "    if (tensor_in) {\n",
     "  unsigned pf[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n  int ntile = 0;\n"
     "  for (; tl < total; tl += gridDim.x) {\n    const unsigned ck0 = NOW;\n    ++ntile;\n"
     "    int n, ty0, tx0;\n    origin(tl, n, ty0, tx0);\n    if (tensor_in) {\n"),
    ("      mbar_wait(wbar, phase);\n      phase ^= 1;\n",
     "      mbar_wait(wbar, phase);\n      phase ^= 1;\n      pf[0] += NOW - ck0;\n"),
    ("    if (gm.nres <= 1 && threadIdx.x == 0) bulk_wait_read();\n"
     "    fence_proxy_async();  // the MMAs read the planes\n"
     "    __syncthreads();      // the planes are whole; raw is free again\n",
     "    const unsigned ck2 = NOW;\n    pf[1] += ck2 - ck0;\n"
     "    if (gm.nres <= 1 && threadIdx.x == 0) bulk_wait_read();\n"
     "    fence_proxy_async();  // the MMAs read the planes\n"
     "    __syncthreads();      // the planes are whole; raw is free again\n"
     "    const unsigned ck3 = NOW;\n    pf[2] += ck3 - ck2;\n"),
    (WR_REQUEST, WR_REQUEST + "    pf[3] += NOW - ck3;\n"),
    (WR_WAIT_UNIT, "            const unsigned cw0 = NOW;\n" + WR_WAIT_UNIT
     + "            pf[4] += NOW - cw0;\n"),
    (WR_CALL, "            const unsigned cm0 = NOW;\n" + WR_CALL
     + "            pf[5] += NOW - cm0;\n"),
    (WR_RELEASE, WR_RELEASE.replace(
        "              wgmma_wait<1>();  // the tap before's MMAs are done, this tap's run on\n",
        "              const unsigned cq0 = NOW;\n"
        "              wgmma_wait<1>();  // the tap before's MMAs are done, this tap's run on\n"
        "              const unsigned cr0 = NOW;\n              pf[5] += cr0 - cq0;\n").replace(
        "has read it\n", "has read it\n              pf[6] += NOW - cr0;\n")),
    (WR_LAST, WR_LAST.replace("          wgmma_wait<0>();\n",
                              "          const unsigned cq1 = NOW;\n          wgmma_wait<0>();\n"
                              "          const unsigned cr1 = NOW;\n          pf[5] += cr1 - cq1;\n")
     .replace("fetch);\n        }", "fetch);\n          pf[6] += NOW - cr1;\n        }")),
    (WR_ONE_BUF_Q + WR_EPI_LINE, "        const unsigned cb0 = NOW;\n" + WR_ONE_BUF_Q.replace(
        "        }\n#pragma", "        }\n        const unsigned ce0 = NOW;\n"
        "        pf[8] += ce0 - cb0;\n#pragma") + WR_EPI_LINE + "        pf[7] += NOW - ce0;\n"),
    (WR_END, "      const unsigned cz0 = NOW;\n" + WR_END.replace(
        "      store_step(rb, tl, nc);\n",
        "      const unsigned cz1 = NOW;\n      pf[8] += cz1 - cz0;\n"
        "      store_step(rb, tl, nc);\n      pf[9] += NOW - cz1;\n")),
    ("    }\n  }\n  if (threadIdx.x == 0) bulk_wait_read();  // before the shared memory goes\n}\n\n"
     "// The plan of a 2-byte path",
     "    }\n    pf[10] += NOW - ck0;\n  }\n"
     "  if (threadIdx.x == 0) bulk_wait_read();  // before the shared memory goes\n"
     "  if (PROFW) {\n    pf[1] -= pf[0];\n"
     "    for (int k = 0; k < 11; ++k) g_prof[(threadIdx.x / 32) * 16 + k] = pf[k];\n"
     "    g_prof[(threadIdx.x / 32) * 16 + 11] = ntile;\n  }\n}\n\n"
     "// The plan of a 2-byte path"),
]
# The split-TF32 kernels' MMA waits, read inside the unit's MMAs of
# csrc/wgmma_chain.cuh (both kernels' callers pass a counter); entries of
# three are (file, anchor, replacement), of two the kernel's own source's
UNIT_WAIT = [
    ("wgmma_chain.cuh",
     "                                 unsigned b, int t, int ks = KS) {\n",
     "                                 unsigned b, int t, int ks = KS, unsigned* wclk = nullptr) {\n"),
    ("wgmma_chain.cuh",
     "    wgmma_wait<0>();\n    fence_acc(d);\n    if (ks0 + KG < ks)",
     "    const unsigned q0 = NOW;\n    wgmma_wait<0>();\n    fence_acc(d);\n"
     "    if (wclk) *wclk += NOW - q0;\n    if (ks0 + KG < ks)"),
    ("wgmma_chain.cuh", "namespace esr {\n",
     "namespace esr {\n#define NOW static_cast<unsigned>(clock())\n"),
]
# and for conv3x3_chain_wgmma_tf32_kernel in csrc/conv_chain.cu: every
# warp's sums over the tiles of block 37, 16 slots a warp, 32-bit clocks
CW32_UNIT = ("                unit_mmas<P, false, KS, KG>(d, a + WGS * 64 * sw * i, sw, nullptr, b, t, "
             "st.ks);\n")
CW32_ADD = "                for (int e = 0; e < 24; ++e) sum[i][e] += d[e];\n"
PATCHES32 = UNIT_WAIT + [
    ("namespace esr {\n",
     "namespace esr {\n__device__ long long g_prof[12 * 16];\n"
     "#define PROFW (blockIdx.x == 37 && threadIdx.x % 32 == 0)\n"),
    ("  int tl = blockIdx.x;\n  if (tl < tiles) window(tl);\n  for (; tl < tiles; tl += gridDim.x) {\n"
     "    int n, ty0, tx0;\n    origin(tl, n, ty0, tx0);\n",
     "  unsigned pf[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n  int ntile = 0;\n"
     "  int tl = blockIdx.x;\n  const unsigned w0 = NOW;\n  if (tl < tiles) window(tl);\n"
     "  pf[0] += NOW - w0;\n  for (; tl < tiles; tl += gridDim.x) {\n    const unsigned c0 = NOW;\n"
     "    ++ntile;\n    int n, ty0, tx0;\n    origin(tl, n, ty0, tx0);\n"),
    ("    __syncthreads();                         // the window is in place\n",
     "    __syncthreads();                         // the window is in place\n    pf[0] += NOW - c0;\n"),
    ("              const unsigned b = ring.wait();\n",
     "              const unsigned w1 = NOW;\n              const unsigned b = ring.wait();\n"
     "              pf[1] += NOW - w1;\n"),
    (CW32_UNIT, "                const unsigned m0 = NOW;\n                unsigned wclk = 0;\n"
     + CW32_UNIT.replace("st.ks);", "st.ks, &wclk);")
     + "                const unsigned m1 = NOW;\n                pf[2] += m1 - m0 - wclk;\n"
     "                pf[3] += wclk;\n"),
    (CW32_ADD, CW32_ADD + "                pf[4] += NOW - m1;\n"),
    ("              ring.release(active, fetch);\n",
     "              const unsigned r0 = NOW;\n              ring.release(active, fetch);\n"
     "              pf[4] += NOW - r0;\n"),
    ("#pragma unroll\n          for (int i = 0; i < MB; ++i) {\n            if (i >= nb) break;\n"
     "            if (k == depth - 1)\n",
     "          const unsigned e0 = NOW;\n"
     "#pragma unroll\n          for (int i = 0; i < MB; ++i) {\n            if (i >= nb) break;\n"
     "            if (k == depth - 1)\n"),
    ("              epilogue_mid(sum[i], st, mb0 + WGS * i, nc, nxt, depth - 1 - k, ty0, tx0);\n"
     "          }\n",
     "              epilogue_mid(sum[i], st, mb0 + WGS * i, nc, nxt, depth - 1 - k, ty0, tx0);\n"
     "          }\n          pf[5] += NOW - e0;\n"),
    ("      if (k == depth - 1) fence_proxy_async();  // the bulk stores read the finished tile\n"
     "      __syncthreads();  // the next stage reads this stage's whole region\n",
     "      const unsigned s0 = NOW;\n"
     "      if (k == depth - 1) fence_proxy_async();  // the bulk stores read the finished tile\n"
     "      __syncthreads();  // the next stage reads this stage's whole region\n"
     "      pf[6] += NOW - s0;\n"),
    ("    const T* const fin = reinterpret_cast<const T*>((depth & 1) ? buf1 : buf0);\n",
     "    const unsigned c7 = NOW;\n"
     "    const T* const fin = reinterpret_cast<const T*>((depth & 1) ? buf1 : buf0);\n"),
    ("    if (more) {\n      if (!(depth & 1)) {\n",
     "    pf[7] += NOW - c7;\n    if (more) {\n      if (!(depth & 1)) {\n"),
    ("      window(tl + gridDim.x);  // into buf0\n    }\n  }\n"
     "  if (threadIdx.x == 0) bulk_wait_read();  // before the shared memory goes\n}\n",
     "      const unsigned w2 = NOW;\n      window(tl + gridDim.x);  // into buf0\n"
     "      pf[0] += NOW - w2;\n    }\n    pf[8] += NOW - c0;\n  }\n"
     "  if (threadIdx.x == 0) bulk_wait_read();  // before the shared memory goes\n"
     "  if (PROFW) {\n    for (int k = 0; k < 9; ++k) g_prof[(threadIdx.x / 32) * 16 + k] = pf[k];\n"
     "    g_prof[(threadIdx.x / 32) * 16 + 9] = ntile;\n  }\n}\n"),
]
SECTIONS32 = ["window load", "weight waits", "A loads, split and MMA issue", "MMA waits",
              "adds and release", "epilogues", "stage barriers", "copy-out"]
# and for conv3x3_pixelshuffle_wgmma_tf32_kernel in csrc/tail.cu (the first
# patch of TAIL_PATCHES declares the counters): every warp's sums over the
# tiles of block 37, 16 slots a warp
WT32_UNIT = ("            unit_mmas<P, FOLD, KS, KG>(d, a0 + WGS * 64 * gm.sw * i + tap_at, gm.sw,\n"
             "                                       foff + 8 * kFoldSteps * u, b, t, gm.ks);\n")
WT32_ADD = "            for (int e = 0; e < 24; ++e) sum[i][e] += d[e];\n"
WT32_OUT = "      store_step(reinterpret_cast<const uint8_t*>(rb), tl, nc);\n"
TAIL32_PATCHES = UNIT_WAIT + [
    TAIL_HEAD,
    ("  int sc = 0;  // steps of this block so far, across tiles: step sc writes result sc % nres\n"
     "  for (int tl = blockIdx.x; tl < total; tl += gridDim.x) {\n    int n, ty0, tx0;\n"
     "    origin(tl, n, ty0, tx0);\n",
     "  unsigned pf[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n  int ntile = 0;\n"
     "  int sc = 0;  // steps of this block so far, across tiles: step sc writes result sc % nres\n"
     "  for (int tl = blockIdx.x; tl < total; tl += gridDim.x) {\n    const unsigned c0 = NOW;\n"
     "    ++ntile;\n    int n, ty0, tx0;\n    origin(tl, n, ty0, tx0);\n"),
    ("    __syncthreads();  // the window is whole\n",
     "    __syncthreads();  // the window is whole\n    pf[0] += NOW - c0;\n"),
    ("{\n          const unsigned b = ring.wait();\n",
     "{\n          const unsigned w0 = NOW;\n          const unsigned b = ring.wait();\n"
     "          pf[1] += NOW - w0;\n"),
    (WT32_UNIT, "            const unsigned m0 = NOW;\n            unsigned wclk = 0;\n"
     + WT32_UNIT.replace("b, t, gm.ks);", "b, t, gm.ks, &wclk);")
     + "            const unsigned m1 = NOW;\n            pf[2] += m1 - m0 - wclk;\n"
     "            pf[3] += wclk;\n"),
    (WT32_ADD, WT32_ADD + "            pf[4] += NOW - m1;\n"),
    ("          ring.release(active, fetch);\n",
     "          const unsigned r0 = NOW;\n          ring.release(active, fetch);\n"
     "          pf[4] += NOW - r0;\n"),
    ("      T* const rb = reinterpret_cast<T*>(gm.nres ? res + (sc % gm.nres) * gm.res_bytes : res);\n",
     "      T* const rb = reinterpret_cast<T*>(gm.nres ? res + (sc % gm.nres) * gm.res_bytes : res);\n"
     "      const unsigned s0 = NOW;\n"),
    ("      for (int i = 0; i < kTailBlocks; ++i)\n        if (i < nb) epilogue(sum[i], wg + WGS * i, nc, rb);\n",
     "      const unsigned e0 = NOW;\n      pf[6] += e0 - s0;\n"
     "      for (int i = 0; i < kTailBlocks; ++i)\n        if (i < nb) epilogue(sum[i], wg + WGS * i, nc, rb);\n"
     "      const unsigned e1 = NOW;\n      pf[5] += e1 - e0;\n"),
    ("      __syncthreads();  // the step's result is whole (after the last: the window is free again)\n"
     + WT32_OUT,
     "      __syncthreads();  // the step's result is whole (after the last: the window is free again)\n"
     "      const unsigned o0 = NOW;\n      pf[6] += o0 - e1;\n" + WT32_OUT
     + "      pf[7] += NOW - o0;\n"),
    ("    }\n  }\n  if (threadIdx.x == 0) bulk_wait_read();  // before the shared memory goes\n}\n\n"
     "// The plan of a split-TF32 path",
     "    }\n    pf[8] += NOW - c0;\n  }\n"
     "  if (threadIdx.x == 0) bulk_wait_read();  // before the shared memory goes\n"
     "  if (PROFW) {\n    for (int k = 0; k < 9; ++k) g_prof[(threadIdx.x / 32) * 16 + k] = pf[k];\n"
     "    g_prof[(threadIdx.x / 32) * 16 + 9] = ntile;\n  }\n}\n\n"
     "// The plan of a split-TF32 path"),
]
TAIL32_NAMES = ["window load", "weight wait", "A loads and MMA issue", "MMA wait",
                "adds and release", "epilogues", "step barriers", "copy-out"]
READER = ('\nextern "C" int read_prof(long long* dst) {\n  return static_cast<int>('
          'cudaMemcpyFromSymbol(dst, esr::g_prof, sizeof(esr::g_prof)));\n}\n')

WG_MMA = "      Wgmma<T>::ss(d, da, db, (tap | c) != 0);\n"
WG_NO_MMA = '      asm volatile("" ::"l"(da), "l"(db));\n'
WG_WAIT = "      mbar_wait(bars + tap, phase);\n"
WG_FETCH = "              if (fetch) fetch_step<P>(wbuf, bars, wq, cw, depth, tile, nk, nnc);\n"
WG_EPI = ["    epilogue(d, wg);\n", "    epilogue(d, mb);\n"]
WG_NO_EPI = '    asm volatile("" ::"f"(d[0]), "f"(d[ND - 1]));\n'
WG_WINDOW = "    if (more && (depth & 1)) window(tl + gridDim.x);\n"
WG_OUT = "      if (threadIdx.x == 0) {\n        for (int r = 0; r < nrow; ++r)\n"
WG_COUNT = "constexpr int kChainWarpgroups = 3;"
# the chain's variants: patches of (file, anchor, replacement)
CHAIN_VARIANTS = {
    "base": [],
    "nomma": [("conv_chain.cu", WG_MMA, WG_NO_MMA)],
    "noepi": [("conv_chain.cu", e, WG_NO_EPI) for e in WG_EPI],
    "nofetch": [("conv_chain.cu", WG_WAIT, ""), ("conv_chain.cu", WG_FETCH, "")],
    "nowindow": [("conv_chain.cu", WG_WINDOW, "")],
    "noout": [("conv_chain.cu", WG_OUT, WG_OUT.replace("threadIdx.x == 0", "false"))],
    "wg1": [("conv_chain.cu", WG_COUNT, WG_COUNT.replace("3", "1"))],
}
WT_MMA = "      Wgmma<T>::ss(d, da, db, (tap | c) != 0);\n"
WR_MMA = "      Wgmma<T>::ss(d[i], da, db, !first || c != 0);\n"
WT_NO_MMA = '      asm volatile("" ::"l"(da), "l"(db));\n'
WT_RELAY = "      for (int item = warp; item < gm.hi * gm.bx.nbox; item += kTailThreads / 32) {\n"
WT_BLOCKS = "constexpr int kTailBlocks = 2;"
WT_STORE = ("        if (out_mode == kOutRows)\n"
            "          tensor_store_3d(out_map_at, res, tx0 * (run / 4), ty0 * r, n);\n"
            "        else\n          tensor_store_4d(out_map_at, res, 0, tx0, ty0 * r, n);\n")
WR_STORE = "      store_step(rb, tl, nc);\n"
WT_COUNT = "constexpr int kTailWarpgroups = 3;"
# the 2-byte tail kernels' variants: patches of (file, anchor, replacement);
# an anchor in both kernels is patched in the one instrumented (KERNELS)
TAIL_VARIANTS = {
    "base": [],
    "nomma": [("tail.cu", WT_MMA, WT_NO_MMA)],
    "noepi": [("tail.cu", WG_EPI_LINE, '        asm volatile("" ::"f"(d[0]), "f"(d[ND - 1]));\n')],
    "norelay": [("tail.cu", WT_RELAY, WT_RELAY.replace("item < gm.hi * gm.bx.nbox", "item < 0"))],
    "noout": [("tail.cu", WT_STORE, "")],
    "wg1": [("tail.cu", WT_COUNT, WT_COUNT.replace("3", "1")),
            ("tail.cu", WT_BLOCKS, WT_BLOCKS.replace("2", "6"))],
}
RING_VARIANTS = {
    "base": [],
    "nomma": [("tail.cu", WR_MMA, WT_NO_MMA)],
    "noepi": [("tail.cu", WR_EPI_LINE,
               '          if (i < nbq) asm volatile("" ::"f"(d[i][0]), "f"(d[i][ND - 1]));\n')],
    "norelay": TAIL_VARIANTS["norelay"],
    "noout": [("tail.cu", WR_STORE, "")],
    "wg1": TAIL_VARIANTS["wg1"],
}
# and for both split-TF32 wgmma kernels (csrc/wgmma_chain.cuh split_a and
# unit_mmas): the window's A loads replaced by constants, the MMAs dropped
# (their fences, groups and waits stay), one warpgroup a block, or each
# unit's k-steps issued as one group (results stay right)
WT32_LOAD = ("      const float4 u = *reinterpret_cast<const float4*>(a + 8 * ks0 + 16 * c);\n"
             "      const float4 v = *reinterpret_cast<const float4*>(a + 8 * sw + 8 * ks0 + 16 * c);\n")
WT32_KEEP = ("      const float4 u = make_float4(__int_as_float(c), 1.f, 2.f, __int_as_float(ks0));\n"
             "      const float4 v = make_float4(3.f, __int_as_float(c), 4.f, __int_as_float(sw));\n")
WT32_MMA = ("      wgmma_tf32_rs(d, ah[s], bh, ks0 + s != 0);\n"
            "      if (P >= 2) wgmma_tf32_rs(d, ah[s], bl, 1);\n"
            "      if (P == 3) wgmma_tf32_rs(d, al[s], bh, 1);\n")
WT32_NO_MMA = ('      asm volatile("" ::"r"(ah[s][0]), "r"(ah[s][3]), "r"(al[s][0]), "r"(al[s][3]), '
               '"l"(bh), "l"(bl));\n')
WT32_KG = "  constexpr int KG = FOLD ? KS : P == 3 || KS == 0 || KS > 6 ? 2 : KS;\n"
TAIL_VARIANTS32 = {
    "base": [],
    "noload": [("wgmma_chain.cuh", WT32_LOAD, WT32_KEEP)],
    "nomma": [("wgmma_chain.cuh", WT32_MMA, WT32_NO_MMA)],
    "wg1": TAIL_VARIANTS["wg1"],
    "kgunit": [("tail.cu", WT32_KG, "  constexpr int KG = KS == 0 ? 2 : KS;\n")],
}
# the chain's: wg1 runs one warpgroup of two m-blocks a pass (three times
# the passes, each reading the stage's units again); kgunit issues each tap
# of the unrolled instantiation as one group (48 A registers under three
# products)
CW32_KG = "  constexpr int KG = KC == 0 || P == 3 ? 2 : KS;\n"
VARIANTS32 = {
    "base": [],
    "noload": TAIL_VARIANTS32["noload"],
    "nomma": TAIL_VARIANTS32["nomma"],
    "wg1": [("conv_chain.cu", WG_COUNT, WG_COUNT.replace("3", "1"))],
    "kgunit": [("conv_chain.cu", CW32_KG, "  constexpr int KG = KC == 0 ? 2 : KS;\n")],
}
MMA_TIERS = ["fasthi16", "fast16", "fast"]
KERNELS = {  # --kernel -> (library, patches of the kernel, variants, the kernel's name)
    "chain": ("conv_chain", PATCHES, CHAIN_VARIANTS, "conv3x3_chain_wgmma_kernel"),
    "tail": ("tail", TAIL_PATCHES, TAIL_VARIANTS, "conv3x3_pixelshuffle_wgmma_kernel"),
    "tail_ring": ("tail", RING_PATCHES, RING_VARIANTS, "conv3x3_pixelshuffle_wgmma_ring_kernel"),
    "chain_tf32": ("conv_chain", PATCHES32, VARIANTS32, "conv3x3_chain_wgmma_tf32_kernel"),
    "tail_tf32": ("tail", TAIL32_PATCHES, TAIL_VARIANTS32,
                  "conv3x3_pixelshuffle_wgmma_tf32_kernel"),
}


def patch(path: str, pairs, scope: str) -> None:
    """Replace each anchor that occurs once in the file, or else once in the
    body of the kernel named ``scope`` (from its definition to the first
    line that is a lone closing brace)."""
    with open(path) as fh:
        text = fh.read()
    for anchor, new in pairs:
        if text.count(anchor) == 1:
            text = text.replace(anchor, new)
            continue
        start = text.find(f"{scope}(const")
        end = text.find("\n}\n", start) + 3
        body = text[start:end] if start >= 0 else ""
        if body.count(anchor) != 1:
            raise RuntimeError(f"{path}: anchor not found exactly once: {anchor!r}")
        text = text[:start] + body.replace(anchor, new) + text[end:]
    with open(path, "w") as fh:
        fh.write(text)


def instrument(csrc: str, kernel: str, variant: str) -> str:
    """Patch the sources under ``csrc`` in place for ``kernel`` and
    ``variant``; returns the name of the library that holds the kernel."""
    source, patches, variants, name = KERNELS[kernel]
    for entry in list(patches) + list(variants[variant]):
        fname, anchor, new = entry if len(entry) == 3 else (f"{source}.cu", *entry)
        patch(os.path.join(csrc, fname), [(anchor, new)], name)
    with open(os.path.join(csrc, f"{source}.cu"), "a") as fh:
        fh.write(READER)
    return source


def run_variant(kernel: str, variant: str, tier: str, widths=(46, 48, 4)) -> int:
    """Child process: build the patched copy and print its clocks (a tail
    kernel at ``widths``: input channels, conv channels, r)."""
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
    chans = [(46, 48), (48, 48), (48, 46)] if is_chain else [tuple(widths[:2])]
    x = rs.standard_normal((32, 256, 256, chans[0][0])).astype(np.float32) * 8
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
                tail.fused_conv3x3_pixelshuffle(x, ws[0], bs[0], r=widths[2])
        torch.cuda.synchronize()
    lib = build.load(source)
    buf = (ctypes.c_longlong * 192)()  # at least every kernel's g_prof
    build.check(lib, lib.read_prof(buf), "read_prof")
    if kernel.endswith("tf32"):
        names = SECTIONS32 if kernel == "chain_tf32" else TAIL32_NAMES
        for warp in range(WARPS):
            v = buf[16 * warp:16 * warp + 10]
            if not v[9]:
                continue
            print(f"{kernel} {variant} (warp {warp}, mean of {v[9]} tiles of one block): "
                  + ", ".join(f"{n} {v[i] / v[9]:.0f}" for i, n in enumerate(names))
                  + f"; tile {v[8] / v[9]:.0f} clocks", flush=True)
    elif kernel == "chain":
        for warp in range(WARPS):
            v = buf[8 * warp:8 * warp + 8]
            if not v[7]:
                continue
            print(f"chain [{tier}] {variant} (warp {warp}, mean of {v[7]} tiles of one block): "
                  + ", ".join(f"{n} {v[i] / v[7]:.0f}" for i, n in enumerate(NAMES))
                  + f"; total {sum(v[:7]) / v[7]:.0f} clocks", flush=True)
    else:
        names = TAIL_NAMES if kernel == "tail" else RING_NAMES
        k = len(names) + 1  # the slot of the tile count; the whole tile's clocks before it
        for warp in range(WARPS):  # thread 0 also asks for the windows and issues the stores
            v = buf[16 * warp:16 * warp + k + 1]
            if not v[k]:
                continue
            print(f"{kernel} [{tier}] {variant} (warp {warp}, mean of {v[k]} tiles of one block): "
                  + ", ".join(f"{n} {v[i] / v[k]:.0f}" for i, n in enumerate(names))
                  + f"; tile {v[k - 1] / v[k]:.0f} clocks", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", default="chain", choices=sorted(KERNELS))
    ap.add_argument("--tier", default="fasthi16", choices=MMA_TIERS,
                    help="the 2-byte kernels' tier (the split-TF32 kernels run parity)")
    ap.add_argument("--variant", nargs="*", default=["base"],
                    choices=sorted(set(TAIL_VARIANTS) | set(RING_VARIANTS) | set(CHAIN_VARIANTS)
                                   | set(VARIANTS32) | set(TAIL_VARIANTS32)))
    ap.add_argument("--tail-widths", nargs=3, type=int, default=None,
                    metavar=("CIN", "CHANNELS", "R"),
                    help="the tail kernels' input and conv channels and r (default 46 48 4; "
                         "tail_ring: 64 256 2)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.kernel.startswith("tail") and "nofetch" in args.variant:
        ap.error("nofetch is a variant of the chain kernels")
    missing = set(args.variant) - set(KERNELS[args.kernel][2])
    if missing:
        ap.error(f"{args.kernel} has no variant {sorted(missing)}")
    tier = "parity" if args.kernel.endswith("tf32") else args.tier
    if args.tail_widths is None:
        args.tail_widths = [64, 256, 2] if args.kernel == "tail_ring" else [46, 48, 4]
    if args.child:
        return run_variant(args.kernel, args.child, tier, args.tail_widths)
    if args.kernel in ("tail", "tail_ring"):
        # here, not in a child: it imports this checkout's package
        sys.path.insert(0, REPO)
        from ntire2022_esr_tpu_torch import config
        from ntire2022_esr_tpu_torch.ops.kernels import tail

        cin, nch, r = args.tail_widths
        nm = config._MODES[tier]
        ring = tail.wgmma_plan(cin, nch // (r * r), r, nm.activation_dtype,
                               nm.compute_dtype)["nbuf"] > 0
        if ring != (args.kernel == "tail_ring"):
            ap.error(f"{cin} -> {nch}, r = {r} under {tier} runs the other 2-byte tail kernel")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rc = 0
    for v in args.variant:  # one process each: a process loads one build of the library
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--kernel", args.kernel,
                              "--tier", args.tier, "--tail-widths",
                              *map(str, args.tail_widths), "--child", v]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
