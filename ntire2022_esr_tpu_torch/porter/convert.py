"""torch state dict <-> npz weight cache <-> torch tensors (counterpart of
``ntire2022_esr_tpu/porter/convert.py``).

The cache (``weights/*.npz``) holds dotted torch parameter names with the
JAX package's layouts. :func:`port_state_dict` makes it from a torch
state dict, bit for bit as the JAX package does, so that a cache the port
writes is the cache both packages read:

- conv weights (O, I/g, kh, kw) -> HWIO (kh, kw, I/g, O), the default for
  a 4-D ``weight``;
- linear weights (O, I) -> (I, O), for keys that match ``linear_keys``;
- conv-transpose weights (I, O, kh, kw) -> (kh, kw, I, O) with the taps
  flipped, for keys that match ``conv_transpose_keys``;
- everything else as it is (biases, norms, PReLU slopes, position
  tables), as are keys that match ``raw_keys``.

Weight norm (``weight_g``/``weight_v`` pairs: reference models 23, 36,
42) is folded into one ``weight``, ``g * v / ||v||`` in float64, first.

:func:`to_torch` carries the cache back to torch's layouts, so
``nn.Module.load_state_dict`` takes it: HWIO -> OIHW, and the
conv-transpose weights it is told of back to ``(I, O, kh, kw)``.
:func:`reference_state_dict` undoes every rule, linear weights too: the
state dict of the torch reference's module, which a ``.pth`` holds.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterable, Mapping, Sequence

import numpy as np
import torch


def fold_weight_norm(sd: Mapping[str, np.ndarray]) -> "OrderedDict[str, np.ndarray]":
    """Each ``weight_g``/``weight_v`` pair as one ``weight``: ``g * v /
    ||v||`` over every axis but the first, in float64, then ``v``'s dtype."""
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for k, v in sd.items():
        if k.endswith("weight_g"):
            base = k[: -len("weight_g")]
            wv = sd[base + "weight_v"]
            axes = tuple(range(1, wv.ndim))
            norm = np.sqrt(np.sum(wv.astype(np.float64) ** 2, axis=axes, keepdims=True))
            out[base + "weight"] = (v.astype(np.float64) * wv / norm).astype(wv.dtype)
        elif k.endswith("weight_v"):
            continue
        else:
            out[k] = v
    return out


def _matches(key: str, patterns: Iterable[str]) -> bool:
    return any(re.search(p, key) for p in patterns)


# buffers that the models recompute: Swin's shift masks and relative-position
# index tables
DEFAULT_DROPS = ("attn_mask$", "relative_position_index$")


def port_state_dict(
    sd: Mapping[str, np.ndarray],
    *,
    linear_keys: Sequence[str] = (),
    conv_transpose_keys: Sequence[str] = (),
    raw_keys: Sequence[str] = (),
    drop_keys: Sequence[str] = (),
) -> "OrderedDict[str, np.ndarray]":
    """A flat torch state dict (numpy arrays) as the cache's flat arrays.

    The key patterns are regular expressions searched in the full key.
    ``raw_keys`` keeps a 4-D array as it is (a bias table stored 4-D);
    ``drop_keys`` drops keys, besides ``num_batches_tracked`` and
    :data:`DEFAULT_DROPS`."""
    sd = fold_weight_norm(sd)
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for k, v in sd.items():
        if (k.endswith("num_batches_tracked") or _matches(k, DEFAULT_DROPS)
                or _matches(k, drop_keys)):
            continue
        arr = np.asarray(v)
        if _matches(k, raw_keys):
            pass
        elif _matches(k, conv_transpose_keys) and arr.ndim == 4:
            arr = np.flip(arr.transpose(2, 3, 0, 1), axis=(0, 1)).copy()
        elif _matches(k, linear_keys) and arr.ndim == 2 and k.endswith("weight"):
            arr = arr.T.copy()
        elif arr.ndim == 4 and k.endswith("weight"):
            arr = arr.transpose(2, 3, 1, 0).copy()
        out[k] = np.ascontiguousarray(arr, dtype=arr.dtype)
    return out


def nest(flat: Mapping[str, np.ndarray]) -> Dict:
    """Split dotted keys into a nested dict tree."""
    tree: Dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flatten(tree: Mapping, prefix: str = "") -> "OrderedDict[str, np.ndarray]":
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def reference_state_dict(
    tree: Mapping,
    *,
    linear_keys: Sequence[str] = (),
    conv_transpose_keys: Sequence[str] = (),
    raw_keys: Sequence[str] = (),
) -> "OrderedDict[str, torch.Tensor]":
    """The inverse of :func:`port_state_dict`'s layout rules, under the same
    patterns: a cached tree as the torch reference's state dict, CPU
    tensors. Weight norm stays folded and dropped buffers are not made
    again; ``port_state_dict`` of the result gives the tree back."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k, v in flatten(tree).items():
        arr = np.asarray(v)
        if _matches(k, raw_keys):
            pass
        elif _matches(k, conv_transpose_keys) and arr.ndim == 4:
            arr = np.flip(arr, axis=(0, 1)).transpose(2, 3, 0, 1)
        elif _matches(k, linear_keys) and arr.ndim == 2 and k.endswith("weight"):
            arr = arr.T
        elif arr.ndim == 4 and k.endswith("weight"):
            arr = arr.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(arr.copy())
    return out


def save_params(path: str, tree: Mapping) -> None:
    """Write a tree to the cache: a compressed npz of its dotted keys."""
    np.savez_compressed(path, **flatten(tree))


def load_params(path: str) -> Dict:
    with np.load(path) as z:
        return nest({k: z[k] for k in z.files})


def to_torch(tree: Mapping, device="cpu",
             conv_transpose_keys: Sequence[str] = ()) -> "OrderedDict[str, torch.Tensor]":
    """Flat torch state dict from a cached tree: 4-D conv weights HWIO ->
    OIHW (``w.transpose(3, 2, 0, 1)``), everything else as it is. A key
    that matches ``conv_transpose_keys`` (the patterns
    :func:`port_state_dict` took) holds a conv-transpose weight, flipped
    HWIO (kh, kw, I, O): its taps are flipped back and it becomes torch's
    ``(I, O, kh, kw)``, as ``F.conv_transpose2d`` reads it. A w8 tree
    (``porter.quantize_params_int8``) converts the same way: an int8 conv
    weight HWIO -> OIHW and its ``weight_scale`` (1, 1, I, O) -> (O, I, 1,
    1), or (I, O, 1, 1) beside a conv-transpose weight; a linear weight
    stays (in, out) with its (1, out) scale, as ``ops.linear_tokens``
    reads it."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k, v in flatten(tree).items():
        arr = np.asarray(v)
        if arr.ndim == 4 and (k.endswith("weight") or k.endswith("weight_scale")):
            base = k[: -len("_scale")] if k.endswith("weight_scale") else k
            if _matches(base, conv_transpose_keys):
                arr = np.flip(arr, axis=(0, 1)).transpose(2, 3, 0, 1).copy()
            else:
                arr = arr.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out
