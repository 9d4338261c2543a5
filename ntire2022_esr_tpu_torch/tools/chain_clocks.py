#!/usr/bin/env python3
"""Where one block of the tensor-core chain kernel spends its clocks.

    python3 ntire2022_esr_tpu_torch/tools/chain_clocks.py [--variant NAME ...]

The card offers no kernel profiler where this repository is measured, so
this script makes a copy of the package under ``build/chain_clocks/``,
inserts ``clock64()`` reads around the phases of
``conv3x3_chain_mma_kernel`` (text patches of ``csrc/conv_chain.cu``; it
fails if an anchor is gone), builds the copy and runs RLFN's chain at
(32, 256, 256, 46) under fasthi16 with random weights (numpy seed 3). It
prints the clocks that warp 1 of one interior block spent in: the window
load, the main loop and, inside it, the barriers, the MMA steps (of which:
inside the row calls, and those with 3 m-tiles), the epilogues; and the
output copy.

A variant removes one thing from the copy to show what it costs (results
are then wrong, times still meaningful): ``nob`` the B-fragment loads,
``noa`` the A-fragment loads, ``noload`` both, ``nomma`` the MMAs,
``nofetch`` the ``cp.async`` of the next row's weights. Default: ``base``.
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
         "output", "  (row calls)", "  (row calls, 3 m-tiles)"]

# (anchor, replacement) pairs for csrc/conv_chain.cu
PATCHES = [
    ("namespace esr {\n",
     "namespace esr {\n__device__ long long g_prof[16];\n"
     "#define PROF (blockIdx.x == 37 && blockIdx.y == 1 && threadIdx.x == 32)\n"),
    ("  Cursor cur{0, 0, 0, 0};\n",
     "  long long tp0 = clock64(), tsync = 0, tmma = 0, tepi = 0, trow = 0, trow3 = 0;\n"
     "  Cursor cur{0, 0, 0, 0};\n"),
    ("  float hi[kMT][kNtChunk][4], lo[kMT][kNtChunk][4];\n",
     "  long long tp1 = clock64();\n  float hi[kMT][kNtChunk][4], lo[kMT][kNtChunk][4];\n"),
    ("    cp_async_wait_all();\n    __syncthreads();  // this step",
     "    long long ta = clock64();\n    cp_async_wait_all();\n    __syncthreads();  // this step"),
    ("    Cursor nxt = cur;\n", "    long long tb = clock64(); tsync += tb - ta;\n    Cursor nxt = cur;\n"),
    ("    static_assert(kMT == 3,", "    const long long td = clock64();\n    static_assert(kMT == 3,"),
    ("    if (cur.ky == 2) {\n",
     "    long long tc = clock64(); tmma += tc - tb; trow += tc - td; if (cnt == 3) trow3 += tc - td;\n"
     "    if (cur.ky == 2) {\n"),
    ("    cur = nxt;\n    st = nst;\n", "    tepi += clock64() - tc;\n    cur = nxt;\n    st = nst;\n"),
    ("  __syncthreads();\n\n  // the finished tile",
     "  long long tp2 = clock64();\n  __syncthreads();\n  long long tp3 = clock64();\n\n  // the finished tile"),
]
KERNEL_END = ("      out[gp * cout + co] = y;\n    }\n  }\n}\n",
              "      out[gp * cout + co] = y;\n    }\n  }\n"
              "  if (PROF) { g_prof[0] = tp1 - tp0; g_prof[1] = tp2 - tp1; g_prof[2] = tsync; "
              "g_prof[3] = tmma; g_prof[4] = tepi; g_prof[5] = tp3 - tp2; g_prof[6] = clock64() - tp3; "
              "g_prof[7] = trow; g_prof[8] = trow3; }\n}\n")
READER = ('\nextern "C" int read_prof(long long* dst) {\n  return static_cast<int>('
          'cudaMemcpyFromSymbol(dst, esr::g_prof, sizeof(long long) * 16));\n}\n')

B_LOAD = "if (n + 1 < NT || more) b_next = wrow[(s * NT + n + 1) * 32];"
A_LOAD = "for (int m = 0; m < CNT; ++m) ldmatrix_x4(fr_next[m], a + m * 16 * sw);"
A_KEEP = "for (int m = 0; m < CNT; ++m) for (int i = 0; i < 4; ++i) fr_next[m][i] = fr[m][i];"
MMAS = ("        mma_m16n8k16(hi[m][n], fr[m], b.x, b.y);\n"
        "        mma_m16n8k16(lo[m][n], fr[m], b.z, b.w);\n      }\n      b = b_next;")
NO_MMAS = ('        asm volatile("" ::"r"(fr[m][0]), "r"(fr[m][1]), "r"(fr[m][2]), "r"(fr[m][3]), '
           '"r"(b.x), "r"(b.y), "r"(b.z), "r"(b.w));\n      }\n      b = b_next;')
FETCH = "      if (nxt.k < depth) fetch_weights(wbuf(j + 1), wq, nst, nxt);\n"
# variant -> patches of (file, anchor, replacement)
VARIANTS = {
    "base": [],
    "nob": [("mma_stage.cuh", B_LOAD, "")],
    "noa": [("mma_stage.cuh", A_LOAD, A_KEEP)],
    "noload": [("mma_stage.cuh", B_LOAD, ""), ("mma_stage.cuh", A_LOAD, A_KEEP)],
    "nomma": [("mma_stage.cuh", MMAS, NO_MMAS)],
    "nofetch": [("conv_chain.cu", FETCH, "")],
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


def run_variant(variant: str) -> int:
    """Child process: build the patched copy and print its clocks."""
    dst = os.path.join(REPO, "build", "chain_clocks", variant)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dst, PKG, "csrc")
    patch(os.path.join(csrc, "conv_chain.cu"), PATCHES + [KERNEL_END])
    with open(os.path.join(csrc, "conv_chain.cu"), "a") as fh:
        fh.write(READER)
    for fname, anchor, new in VARIANTS[variant]:
        patch(os.path.join(csrc, fname), [(anchor, new)])
    sys.path.insert(0, dst)
    import torch
    from ntire2022_esr_tpu_torch import config, ops
    from ntire2022_esr_tpu_torch.ops.kernels import build, conv_chain

    rs = np.random.RandomState(3)
    chans = [(46, 48), (48, 48), (48, 46)]
    x = rs.standard_normal((32, 256, 256, 46)).astype(np.float32) * 8
    x = ops.from_nhwc(torch.from_numpy(x).cuda()).half()
    ws = [torch.from_numpy(rs.standard_normal((co, ci, 3, 3)).astype(np.float32) * 0.05).cuda()
          for ci, co in chans]
    bs = [torch.from_numpy(rs.standard_normal(co).astype(np.float32) * 0.1).cuda()
          for _, co in chans]
    with config.numerics_mode("fasthi16"), torch.inference_mode():
        for _ in range(3):
            conv_chain.fused_conv3x3_chain(x, ws, bs)
        torch.cuda.synchronize()
    lib = build.load("conv_chain")
    buf = (ctypes.c_longlong * 16)()
    build.check(lib, lib.read_prof(buf), "read_prof")
    total = sum(buf[i] for i in (0, 1, 5, 6))
    print(f"{variant}: " + ", ".join(f"{n.strip()} {buf[i]}" for i, n in enumerate(NAMES))
          + f"; block total {total} clocks", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", nargs="*", default=["base"], choices=sorted(VARIANTS))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return run_variant(args.child)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rc = 0
    for v in args.variant:  # one process each: a process loads one build of the library
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--child", v]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
