"""Dataset path selection (``select_dataset`` and ``discover_pairs`` are
copies of ``ntire2022_esr_tpu/harness/data.py``'s; reference
test_demo.py:344-361).

DIV2K x4: validation = images 0801-0900 (LR has 'x4' suffix), test =
0901-1000 (no suffix). Returns (lr_path, hr_path) pairs.

``write_synthetic_div2k`` writes image pairs in that layout from a seed,
for checks of the protocol where the dataset is absent.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Tuple

import numpy as np

from ntire2022_esr_tpu_torch.utils import image as img_util


def select_dataset(data_dir: str, mode: str) -> List[Tuple[str, str]]:
    if mode == "test":
        path = [
            (
                os.path.join(data_dir, f"DIV2K_test_LR/{i:04}.png"),
                os.path.join(data_dir, f"DIV2K_test_HR/{i:04}.png"),
            )
            for i in range(901, 1001)
        ]
    elif mode == "valid":
        path = [
            (
                os.path.join(data_dir, f"DIV2K_valid_LR/{i:04}x4.png"),
                os.path.join(data_dir, f"DIV2K_valid_HR/{i:04}.png"),
            )
            for i in range(801, 901)
        ]
    else:
        raise ValueError(f"unknown dataset mode: {mode!r}")
    return path


def discover_pairs(data_dir: str, lr_sub: str = "LR", hr_sub: str = "HR") -> List[Tuple[str, str]]:
    """LR/HR pairs of a folder outside the DIV2K layout: the ``.png``,
    ``.jpg`` and ``.bmp`` files of ``data_dir/lr_sub`` and
    ``data_dir/hr_sub``, paired in sorted order."""
    def images(sub):
        d = os.path.join(data_dir, sub)
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.lower().endswith((".png", ".jpg", ".bmp")))

    lrs, hrs = images(lr_sub), images(hr_sub)
    if len(lrs) != len(hrs):
        raise ValueError(f"LR/HR count mismatch: {len(lrs)} vs {len(hrs)}")
    return list(zip(lrs, hrs))


def synthetic_hr(rs: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A smooth random uint8 (h, w, 3) field: a gradient plus four random
    sinusoids per channel (float32 throughout)."""
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    chans = []
    for _ in range(3):
        gy, gx = (float(v) for v in rs.uniform(-60, 60, 2))
        f = 128.0 + gy * (yy - 0.5) + gx * (xx - 0.5)
        for _ in range(4):
            fy, fx, amp, phase = (float(v) for v in (*rs.uniform(-12, 12, 2), rs.uniform(5, 25),
                                                      rs.uniform(0, 2 * np.pi)))
            a, b = 2 * np.pi * fy * yy, 2 * np.pi * fx * xx + phase
            # sin(a + b) from the row and column factors
            f += amp * (np.sin(a) * np.cos(b) + np.cos(a) * np.sin(b))
        chans.append(np.clip(f, 0, 255))
    return np.round(np.stack(chans, axis=-1)).astype(np.uint8)


def write_synthetic_div2k(data_dir: str, valid_lr_shapes: Iterable[Tuple[int, int]],
                          test_lr_shapes: Iterable[Tuple[int, int]] = (), seed: int = 0,
                          scale: int = 4) -> List[Tuple[str, str]]:
    """Write DIV2K-layout pairs (valid from 0801, test from 0901) whose HR
    images are :func:`synthetic_hr` fields of ``scale`` times each LR shape
    and whose LR images are the rounded ``scale`` x ``scale`` block means
    of their HR images. Returns the (lr_path, hr_path) pairs written."""
    rs = np.random.RandomState(seed)
    written = []
    for mode, shapes in (("valid", valid_lr_shapes), ("test", test_lr_shapes)):
        paths = select_dataset(data_dir, mode)
        for k, (h, w) in enumerate(shapes):
            lr_path, hr_path = paths[k]
            hr = synthetic_hr(rs, h * scale, w * scale)
            lr = hr.reshape(h, scale, w, scale, 3).mean(axis=(1, 3))
            for path, img in ((lr_path, np.round(lr).astype(np.uint8)), (hr_path, hr)):
                img_util.mkdir(os.path.dirname(path))
                img_util.imsave(img, path)
            written.append((lr_path, hr_path))
    return written
