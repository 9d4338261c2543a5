"""Reparameterization folds for train-form checkpoints (counterpart of
``ntire2022_esr_tpu/porter/reparam.py``).

Every shipped checkpoint of the zoo is already in deploy form, so nothing
in the 42-model protocol needs this; a train-form checkpoint would, at
port time. The fold is the reference's ``LinearBlock.rep_params`` (team
29's CLRFDN): a 3x3 conv followed by a 1x1 collapsed into one 3x3 conv, on
the cache's HWIO weights. numpy only: the same code as the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def fold_linear_block(w3: np.ndarray, b3: Optional[np.ndarray],
                      w1: np.ndarray, b1: Optional[np.ndarray],
                      with_idt: bool = False):
    """Fold conv3x3 (I -> M) then conv1x1 (M -> O) into one conv3x3.

    ``w3`` (3, 3, I, M) and ``w1`` (1, 1, M, O) are HWIO, the biases (C,).
    Returns ``(rk, rb)``: ``rk`` (3, 3, I, O) and ``rb`` (O,).
    ``with_idt=True`` adds the identity shortcut as a centre tap (I == O).
    Exact for the linear pair: an activation after it is left to apply to
    the folded conv's output."""
    w3 = np.asarray(w3)
    w1 = np.asarray(w1)
    if w3.shape[:2] != (3, 3) or w1.shape[:2] != (1, 1):
        raise ValueError(f"expected 3x3 then 1x1 conv, got {w3.shape[:2]} "
                         f"then {w1.shape[:2]}")
    if w3.shape[3] != w1.shape[2]:
        raise ValueError(f"mid-channel mismatch: {w3.shape[3]} vs {w1.shape[2]}")
    m2o = w1[0, 0]  # (M, O)
    rk = np.einsum("hwim,mo->hwio", w3, m2o)
    rb = np.zeros(w1.shape[3], w3.dtype)
    if b3 is not None:
        rb = rb + np.asarray(b3) @ m2o
    if b1 is not None:
        rb = rb + np.asarray(b1)
    if with_idt:
        i_ch, o_ch = rk.shape[2], rk.shape[3]
        if i_ch != o_ch:
            raise ValueError(f"identity fold needs in == out channels, "
                             f"got {i_ch} != {o_ch}")
        rk = rk.copy()
        rk[1, 1, np.arange(o_ch), np.arange(o_ch)] += 1.0
    return rk.astype(w3.dtype), rb.astype(w3.dtype)


def fold_linear_block_tree(p: Dict, with_idt: bool = False) -> Dict:
    """A LinearBlock subtree (``{conv3x3: {weight, bias}, conv1x1: {weight,
    bias}[, act]}``) folded into one conv's ``{weight, bias}``, an
    activation's parameters (a PReLU's ``weight``) kept beside them."""
    rk, rb = fold_linear_block(
        p["conv3x3"]["weight"], p["conv3x3"].get("bias"),
        p["conv1x1"]["weight"], p["conv1x1"].get("bias"), with_idt=with_idt)
    out = {"weight": rk, "bias": rb}
    if "act" in p:
        out["act"] = p["act"]
    return out
