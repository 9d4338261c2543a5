"""Shared block helpers (counterpart of ``ntire2022_esr_tpu/models/blocks.py``).

Only what the RLFN slice needs is ported: ``seq`` and ``conv_lrelu``.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops


def seq(p: nn.Sequential, i: int) -> nn.Module:
    """Index into an ``nn.Sequential`` (state-dict keys '0', '1', ...)."""
    return p[i]


def conv_lrelu(p, x: torch.Tensor, slope: float = 0.05, **kw) -> torch.Tensor:
    return ops.leaky_relu(ops.conv(p, x, **kw), slope)
