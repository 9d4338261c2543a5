"""ARFDN, team14 (counterpart of ``ntire2022_esr_tpu/models/arfdn.py``;
model 14).

The RFDN skeleton with asymmetric blocks: two parallel (3x1 then 1x3) and
(1x3 then 3x1) conv branches per stage, dense reuse of the distilled
features, and the standard ESA (cache name ``mpa``). The fusion 1x1's
LeakyReLU takes team14's default slope, 0.1; the blocks take 0.05. On
stock ops; widths from the weight cache.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.models.blocks import Layer

SLOPE = 0.05


class ARFDB(nn.Module):
    """JAX ``_arfdb``."""

    def __init__(self):
        super().__init__()
        self.c0_d = Layer()
        for i in (1, 2, 3):
            for b in ("l1", "l2", "m1", "m2"):
                self.add_module(f"c{i}_{b}", Layer())
        self.c1_d = Layer()
        self.c2_d = Layer()
        self.c4 = Layer()
        self.c5 = Layer()
        self.mpa = blocks.ESA()

    def _pair(self, x: torch.Tensor, a: str, b: str) -> torch.Tensor:
        return ops.conv(getattr(self, b), ops.leaky_relu(ops.conv(getattr(self, a), x), SLOPE))

    def _stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return self._pair(x, f"c{i}_l1", f"c{i}_l2") + self._pair(x, f"c{i}_m1", f"c{i}_m2")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lrelu = blocks.lrelu
        d1 = blocks.conv_lrelu(self.c0_d, x, SLOPE, padding=0)
        r1 = lrelu(self._stage(1, x) + d1)
        d2 = blocks.conv_lrelu(self.c1_d, r1, SLOPE, padding=0)
        r2 = lrelu(self._stage(2, r1) + r1 + d2 + d1)
        d3 = blocks.conv_lrelu(self.c2_d, r2, SLOPE, padding=0)
        r3 = lrelu(self._stage(3, r2) + r2 + d3 + d2 + d1)
        r4 = blocks.conv_lrelu(self.c4, r3, SLOPE)
        return self.mpa(ops.conv(self.c5, ops.cat([d1, d2, d3, r4]), padding=0))


def ARFDN() -> blocks.RFDNSkeleton:
    """JAX ``arfdn_apply``: the RFDN skeleton over four ARFDBs."""
    return blocks.RFDNSkeleton(ARFDB, fuse_act=lambda h: ops.leaky_relu(h, 0.1))
