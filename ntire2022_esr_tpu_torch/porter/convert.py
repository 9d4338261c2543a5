"""npz weight cache -> torch tensors (counterpart of ``ntire2022_esr_tpu/porter/convert.py``).

The cache (``weights/*.npz``) holds dotted torch parameter names with
conv weights in HWIO, as the JAX package ported them. ``to_torch`` carries
them back to torch's OIHW, so ``nn.Module.load_state_dict`` takes them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch


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


def load_params(path: str) -> Dict:
    with np.load(path) as z:
        return nest({k: z[k] for k in z.files})


def to_torch(tree: Mapping, device="cpu") -> "OrderedDict[str, torch.Tensor]":
    """Flat torch state dict from a cached tree: 4-D conv weights HWIO ->
    OIHW (``w.transpose(3, 2, 0, 1)``), everything else as it is. Integer
    (w8-tier) weights raise: that tier is not ported yet."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k, v in flatten(tree).items():
        arr = np.asarray(v)
        if arr.dtype == np.int8 or k.endswith("weight_scale"):
            raise NotImplementedError(f"{k}: int8 (w8-tier) weights are not ported yet")
        if arr.ndim == 4 and k.endswith("weight"):
            arr = arr.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out
