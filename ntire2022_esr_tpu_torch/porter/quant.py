"""Symmetric int8 weight quantization, the "w8" tier (counterpart of ``ntire2022_esr_tpu/porter/quant.py``).

Weights are stored int8 with f32 scales and dequantized at use, in the
tier's compute dtype (``ops.nn.dequant_weight``); activations and the
contractions keep the active tier, so the tier changes only what the
weights hold. It is opt-in: ``NTIRE_W8=1`` or
``config.set_weights_int8(True)``, and ``registry.build_model`` then
quantizes the cached tree at load (the cache itself stays f32).

The scale granularity is the finest that broadcasts against the weight:

- 4-D conv weights (HWIO here, as the cache holds them): one scale per
  (input, output) channel pair, the maximum of ``|w|`` over the kh x kw
  taps divided by 127, of shape ``(1, 1, I, O)``. That maximum does not
  depend on the layout, so the port quantizes the HWIO tree and
  ``porter.to_torch`` transposes the int8 weight and its scale to OIHW
  (``(O, I, 1, 1)``) afterwards, and both equal the JAX package's bit for
  bit.
- 2-D linear weights ``(in, out)``: one scale per output column, ``(1, out)``.

MeanShift convs (``sub_mean``, ``add_mean``, ``mean_shift``) are never
quantized: they carry exact dataset statistics. Neither are 1-D weights
(PReLU slopes, norms) nor any parameter not called ``weight``.

numpy only: the same code as the JAX package's module.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

SKIP_KEYS = ("sub_mean", "add_mean", "mean_shift")


def quantize_array_int8(w: np.ndarray):
    """``(w_i8, scale_f32)``, symmetric int8 with the scale broadcastable
    against ``w``: one per (cin, cout) pair of a 4-D HWIO weight, one per
    output column of a 2-D ``(in, out)`` one. A pair or column of zeros
    gets a scale of 0 and int8 zeros."""
    w = np.asarray(w, np.float32)
    if w.ndim == 4:
        amax = np.max(np.abs(w), axis=(0, 1), keepdims=True)  # (1, 1, I, O)
    else:
        amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    safe = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(w / safe), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_params_int8(tree: Dict, skip: Sequence[str] = SKIP_KEYS) -> Dict:
    """The nested cache tree with every f32 4-D and 2-D ``weight`` replaced
    by its int8 values and a ``weight_scale`` beside it; biases, norms and
    tables stay f32. A subtree is left as it is when its own key (not the
    dotted path) contains one of ``skip``."""
    def walk(node, name=""):
        if not isinstance(node, dict):
            return node
        if any(s in name for s in skip):
            return node
        out = {}
        for k, v in node.items():
            if (k == "weight" and hasattr(v, "ndim") and v.ndim in (2, 4)
                    and str(getattr(v, "dtype", "")) == "float32"):
                q, scale = quantize_array_int8(np.asarray(v))
                out["weight"] = q
                out["weight_scale"] = scale
            else:
                out[k] = walk(v, k) if isinstance(v, dict) else v
        return out

    return walk(tree)


def dequantize_params(tree: Dict) -> Dict:
    """The inverse walk: each int8 weight times its scale in f32, the
    scales dropped (for tests and inspection)."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "weight" and hasattr(v, "dtype") and str(v.dtype) == "int8":
                out["weight"] = np.asarray(v, np.float32) * np.asarray(
                    node["weight_scale"], np.float32)
            elif k == "weight_scale":
                continue
            else:
                out[k] = walk(v) if isinstance(v, dict) else v
        return out

    return walk(tree)
