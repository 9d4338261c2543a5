"""The comparison that decides ``correct``.

The program's outputs from the window (a sample drawn from the seed) are
held against the plain reference (``reference/<config>.py``), which the
benchmark runs itself on the same uint8 frames, from the same npz, in
float32 with TF32 off for cuDNN and cuBLAS.

Two kinds of output, named by the mix's ``compare``:

- ``u8_levels`` (a served uint8 frame): ``flip_share``, the share of the
  output's values that differ from the reference's own uint8 frame
  (clipped to the data range, scaled to 255, rounded half to even, as the
  port's ``u8_out`` converts); ``max_excess``, the largest distance in
  uint8 levels between an output value and the reference's unrounded
  value, less the half level that rounding alone leaves (0 for an output
  that rounds the reference exactly); and ``max_mean_shift``, over the
  output's ``3 r^2`` sub-pixel channels (each colour at each of the r x r
  positions of the x r pixel shuffle: one output channel of the last
  conv each), the largest absolute mean of that distance, signed, in
  levels. Rounding to nearest, in the port's stored activations and in
  the uint8 output, leaves that mean at nought; weights held in a lower
  precision shift it.
- ``f32_rel`` (the protocol's float32 output): ``max_err`` and
  ``mean_err``, the largest and the mean absolute difference from the
  reference's output, over the data range.

The numbers aggregate over every sampled value. ``limits/<workload>.json``
names the numbers that a cell compares, each with its limit; a run is
correct where each of them is at or under its limit. A control is either
the port's own path one step of precision lower (``program:<tier>``, run
by ``calibrate.py``), or the reference computed with TF32 on
(:data:`CONTROLS`, :func:`numbers` with ``control``) put in the
program's place.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from port_bench import cells

BLOCK_PIXELS = 1 << 18  # LR pixels the reference runs at once


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """cuDNN and cuBLAS float32 with TF32 on or off inside the block."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


# a reference's precision -> TF32 on for cuDNN and cuBLAS
CONTROLS: Dict[str, bool] = {"f32": False, "tf32": True}


def reference_outputs(config: Dict, frames_u8: np.ndarray, device,
                      kind: str = "f32") -> Iterator[torch.Tensor]:
    """The reference's float32 NHWC outputs of the uint8 NHWC frames, on
    ``device``, in blocks of frames; ``kind`` names the precision
    (:data:`CONTROLS`; ``f32`` is the reference itself)."""
    ref = cells.load_module("reference", config["name"])
    params = ref.load(os.path.join(cells.ROOT, config["weights"]), device)
    dr = float(config["data_range"])
    n, h, w, _ = frames_u8.shape
    block = max(1, BLOCK_PIXELS // (h * w))
    with torch.no_grad(), precision(CONTROLS[kind]):
        for i in range(0, n, block):
            x = torch.from_numpy(np.ascontiguousarray(frames_u8[i:i + block])).to(device)
            x = x.permute(0, 3, 1, 2).float() / (255.0 / dr)
            yield ref.forward(params, x).permute(0, 2, 3, 1)


def to_u8(y: torch.Tensor, dr: float) -> torch.Tensor:
    """A float output as the port's ``u8_out`` converts it: clip to [0, dr],
    scale to 255, round half to even."""
    return torch.round(y.clamp(0, dr) * (255.0 / dr)).to(torch.uint8)


def numbers(kind: str, config: Dict, frames_u8: np.ndarray, outputs: Sequence[np.ndarray],
            device, control: str = "") -> Dict[str, float]:
    """The compared numbers of ``outputs`` (one per frame of ``frames_u8``).
    With ``control``, the outputs are replaced by the reference computed in
    that precision (:data:`CONTROLS`), converted as the program's are."""
    dr = float(config["data_range"])
    refs = list(reference_outputs(config, frames_u8, device))
    if control:
        got: List[torch.Tensor] = list(reference_outputs(config, frames_u8, device, control))
        if kind == "u8_levels":
            got = [to_u8(g, dr) for g in got]
        got = [g.cpu().numpy() for g in got]
        outputs = np.concatenate(got)
    out = [torch.from_numpy(np.asarray(o)) for o in outputs]
    up = int(config["upscale"])
    flips = values = 0
    worst = float("-inf")
    total = 0.0
    shift = torch.zeros((up, up, 3), dtype=torch.float64, device=device)
    i = 0
    for ref in refs:
        for r in ref:
            o = out[i].to(device).reshape(r.shape)
            i += 1
            if kind == "u8_levels":
                levels = r.clamp(0, dr) * (255.0 / dr)
                of = o.float()
                flips += int((of != torch.round(levels)).sum())
                d = of - levels
                worst = max(worst, float(d.abs().max()) - 0.5)
                hh, ww, c = d.shape  # (up H, up W, 3): sum by sub-pixel channel
                shift += d.double().reshape(hh // up, up, ww // up, up, c).sum(dim=(0, 2))
            elif kind == "f32_rel":
                d = (o.float() - r).abs() / dr
                worst = max(worst, float(d.max()))
                total += float(d.double().sum())
            else:
                raise KeyError(f"unknown comparison {kind!r}")
            values += r.numel()
    if i != len(out):
        raise ValueError(f"{len(out)} outputs for {i} frames")
    if kind == "u8_levels":
        per_channel = values // shift.numel()
        return {"flip_share": flips / values, "max_excess": worst,
                "max_mean_shift": float((shift / per_channel).abs().max())}
    return {"max_err": worst, "mean_err": total / values}


def judge(values: Dict[str, float], limits: Dict) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}) over the numbers that
    ``limits`` names: correct where each was read and is at or under its
    limit."""
    checks, ok = {}, True
    for name, entry in limits["numbers"].items():
        v = values.get(name)
        checks[name] = {"value": v, "limit": entry["limit"]}
        if v is None or not v <= entry["limit"]:
            ok = False
    return ok, checks
