"""x8 self-ensemble inference (counterpart of ``ntire2022_esr_tpu/harness/ensemble.py``).

Runs the model on all 8 dihedral transforms of the input and averages the
inverse-transformed outputs (``utils.image.DIHEDRAL``, the table of
``augment_img``, on the H and W axes of NHWC tensors).

``torch.rot90`` and ``torch.flip`` give tensors whose H and W may be
swapped and whose strides are not NHWC's; each view is made contiguous
NHWC before the model sees it, because the kernels read NHWC bytes.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch.utils.image import DIHEDRAL, INVERSE_MODE


def _fwd(x: torch.Tensor, mode: int) -> torch.Tensor:
    """``augment_img``'s transform ``mode`` on the H and W axes of NHWC ``x``."""
    k, flip = DIHEDRAL[mode]
    x = torch.rot90(x, k, (1, 2)) if k else x
    return torch.flip(x, (1,)) if flip else x


class SelfEnsembleX8(nn.Module):
    """``model`` (NHWC -> NHWC) wrapped into its x8 dihedral self-ensemble."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = None
        for mode in range(8):
            y = self.model(_fwd(x, mode).contiguous())
            y = _fwd(y, INVERSE_MODE[mode])
            acc = y if acc is None else acc + y
        return acc / 8.0


def self_ensemble_x8(model: nn.Module) -> SelfEnsembleX8:
    return SelfEnsembleX8(model)
