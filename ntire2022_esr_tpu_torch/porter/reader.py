"""PyTorch checkpoint reading (counterpart of ``ntire2022_esr_tpu/porter/reader.py``).

Reads every wrapper form of the reference model zoo's checkpoints:

- a plain ``state_dict``;
- a dict that wraps one under ``"params"``, ``"net"``, ``"model_state_dict"``
  or ``"state_dict"``;
- DataParallel's ``module.``-prefixed keys.

``torch.load`` runs with ``weights_only=False``, as in the JAX package, so
that the same files load: it unpickles, and so runs whatever code a file
carries. Load only checkpoints you trust.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

_WRAPPER_KEYS = ("params", "net", "model_state_dict", "state_dict")


def read_torch_checkpoint(path: str, unwrap: Optional[str] = "auto") -> "OrderedDict[str, np.ndarray]":
    """A ``.pth``/``.pt`` checkpoint as an ordered dict of numpy arrays, on
    the CPU. ``unwrap="auto"`` takes the first wrapper key present when the
    file is not itself a dict of tensors; a key name takes that key; None
    takes the file as it is. Entries that are not tensors (step counters)
    are skipped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if unwrap == "auto":
        if isinstance(obj, dict) and not all(hasattr(v, "numpy") for v in obj.values()):
            for k in _WRAPPER_KEYS:
                if k in obj:
                    obj = obj[k]
                    break
    elif unwrap:
        obj = obj[unwrap]

    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if not hasattr(v, "numpy"):
            continue
        out[k] = v.detach().cpu().numpy()
    return out
