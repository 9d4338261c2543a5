#!/usr/bin/env python3
"""Host-side times of the protocol's image I/O, on the card's machine.

    python3 ntire2022_esr_tpu_torch/tools/host_io_times.py [--root DIR] [--repeats 5]

1. PNG decode of one DIV2K-size image: HR 1356x2040 RGB, a
   ``data.synthetic_hr`` field from numpy seed 0, every row Up-filtered as
   ``utils.image.png_encode`` writes it, and the same image with every row
   Avg- and every row Paeth-filtered. It times the whole ``png_decode`` of
   each file and, on the same rows, the decoder's C helper
   ``csrc/png_unfilter.c`` and, on the Up rows, its plain version, the
   anti-diagonal wavefront.
2. The runner's time outside its timed forwards: ``runner.run`` under
   fasthi16 over ``chip_smoke.py``'s six phase-7 valid LR shapes (written
   from numpy seed 0 under ``build/``), after one untimed run that builds
   the kernels, ``--repeats`` times. Per run it prints the wall time, the
   sum of the timed forwards and their difference (warm-up forwards,
   decoding, scoring, saving). Beside it, the LR decode a run does
   (``imread_uint`` + ``uint2nhwc`` per image): the most that decoding in a
   second thread could hide.

``--root DIR`` imports the package from another checkout (for example a
parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists), so two runners can be compared in one call. It
prints the card's name and power limit, and one JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import struct
import subprocess
import sys
import time
import types
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

LR_SHAPES = ((339, 510), (510, 339), (384, 508), (341, 341), (351, 510), (255, 383))
HR_SHAPE = (1356, 2040)


def filter_rows(img: np.ndarray, ftype: int) -> np.ndarray:
    """Every row of uint8 (H, W, C) ``img`` filtered with PNG filter
    ``ftype`` (2 Up, 3 Avg, 4 Paeth): the residuals, (H, W, C) uint8."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    if ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    else:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def png_bytes(img: np.ndarray, ftype: int, img_util) -> bytes:
    h, w, _ = img.shape
    raw = np.concatenate([np.full((h, 1), ftype, np.uint8),
                          filter_rows(img, ftype).reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + img_util._chunk(b"IHDR", header)
            + img_util._chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + img_util._chunk(b"IEND", b""))


def median_ms(fn, n: int = 5) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="checkout whose package is timed")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        print("host_io_times: no CUDA device", file=sys.stderr)
        return 2
    import ntire2022_esr_tpu_torch
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import data, registry, runner
    from ntire2022_esr_tpu_torch.utils import image as img_util

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"package from {os.path.dirname(ntire2022_esr_tpu_torch.__file__)}; "
          f"{os.cpu_count()} host cores")

    # 1. PNG decode of a DIV2K-size image ---------------------------------
    hr = data.synthetic_hr(np.random.RandomState(0), *HR_SHAPE)
    decode = {}
    for fname, ftype in (("up", 2), ("avg", 3), ("paeth", 4)):
        png = img_util.png_encode(hr) if ftype == 2 else png_bytes(hr, ftype, img_util)
        ftypes = np.full(HR_SHAPE[0], ftype, np.uint8)
        rows = filter_rows(hr, ftype)
        paths = [img_util._unfilter_c] + ([img_util._unfilter_wavefront] if ftype == 2 else [])
        for fn in paths:
            if not np.array_equal(fn(ftypes, rows), hr):
                raise RuntimeError(f"{fn.__name__} does not undo the {fname} filter")
        if not np.array_equal(img_util.png_decode(png), hr):
            raise RuntimeError(f"png_decode does not read back the {fname}-filtered file")
        decode[f"png_decode_{fname}_ms"] = median_ms(lambda: img_util.png_decode(png))
        decode[f"c_{fname}_ms"] = median_ms(lambda: img_util._unfilter_c(ftypes, rows))
        if ftype == 2:
            decode["wavefront_up_ms"] = median_ms(
                lambda: img_util._unfilter_wavefront(ftypes, rows))
        print(f"decode of {HR_SHAPE[0]}x{HR_SHAPE[1]} RGB, {fname} rows ({len(png) / 1e6:.2f} MB "
              f"file): png_decode {decode[f'png_decode_{fname}_ms']:.3f} ms; filters by the C "
              f"helper {decode[f'c_{fname}_ms']:.3f} ms"
              + (f", by wavefront {decode['wavefront_up_ms']:.3f} ms" if ftype == 2 else "")
              + " (medians of 5)", flush=True)

    # 2. the runner's time outside its timed forwards ---------------------
    work = os.path.join(root, "build", "host_io_times")
    shutil.rmtree(work, ignore_errors=True)
    pairs = data.write_synthetic_div2k(os.path.join(work, "div2k"), LR_SHAPES, seed=0)
    lr_decode_ms = sum(median_ms(lambda p=lr: img_util.uint2nhwc(img_util.imread_uint(p), 255.0))
                       for lr, _ in pairs)
    model, name, dr, _ = registry.build_model(4)
    logger = logging.getLogger("host_io_times")
    logger.propagate = False
    logger.addHandler(logging.NullHandler())
    runs = []
    with config.numerics_mode("fasthi16"):
        for rep in range(args.repeats + 1):
            t0 = time.perf_counter()
            res = runner.run(model, name, dr, None, logger,
                             types.SimpleNamespace(save_dir=os.path.join(work, "sr"), ssim=False),
                             mode="valid", pairs=pairs)
            wall_ms = (time.perf_counter() - t0) * 1e3
            fwd_ms = sum(res["valid_runtime"])
            if rep == 0:
                print(f"untimed first run (builds the kernels): {wall_ms:.1f} ms")
                continue
            runs.append((wall_ms, fwd_ms))
            print(f"run {rep}: wall {wall_ms:.1f} ms, timed forwards {fwd_ms:.3f} ms, "
                  f"outside them {wall_ms - fwd_ms:.1f} ms ({len(pairs)} images)")
    shutil.rmtree(work)
    walls = [w for w, _ in runs]
    outside = [w - f for w, f in runs]
    print(f"runner.run over {len(pairs)} images, {args.repeats} runs: wall median "
          f"{np.median(walls):.1f} ms (min {min(walls):.1f}, max {max(walls):.1f}), outside the "
          f"timed forwards median {np.median(outside):.1f} ms; LR decode {lr_decode_ms:.2f} ms a run; "
          f"on {smi}")
    print(json.dumps({"root": root, "device": smi, **decode, "lr_decode_ms_per_run": lr_decode_ms,
                      "run_wall_ms": walls, "run_forward_ms": [f for _, f in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
