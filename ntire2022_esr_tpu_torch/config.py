"""Numerics tiers and device selection (counterpart of ``ntire2022_esr_tpu/config.py``).

A tier fixes the dtype of the contractions (``compute_dtype``) and, for
the storage tiers, the dtype every conv output is rounded to before it is
stored (``storage_dtype``; f16 saturates at +-65504 on the way in).

- ``parity``, ``high`` and ``mixed``: f32 activations and weights. The JAX
  ``high`` tier is bf16x3 on the TPU's MXU (f32-grade) and ``mixed`` one
  bf16 pass (``Precision.DEFAULT``); on the JAX CPU path both are plain
  f32, and on the card all three are plain f32 (TF32 off).
- ``fast`` and ``fast16``: activations and weights in bf16 or f16 (the
  weights are rounded at use, as the JAX ``param_dtype`` casts them);
  every contraction's output is rounded to that dtype, and then the bias,
  rounded to it too, is added in it: two roundings.
- ``fasthi`` and ``fasthi16``: f32 weights and f32-grade contractions,
  every conv output stored as bf16 or f16.

Setting a tier also turns TF32 off for cuDNN convolutions and cuBLAS
matmuls: TF32 keeps about three decimal digits, which no tier allows.

The active tier is process-global, like the JAX package's.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Numerics:
    compute_dtype: torch.dtype = torch.float32
    # conv outputs are rounded into this dtype; None = keep compute_dtype
    storage_dtype: Optional[torch.dtype] = None

    @property
    def activation_dtype(self) -> torch.dtype:
        """The dtype of the tensors stored between layers."""
        return self.storage_dtype or self.compute_dtype

    @property
    def two_byte_compute(self) -> bool:
        """``fast`` and ``fast16``: the contractions themselves take 2-byte
        operands, and the bias is added after their rounding."""
        return self.compute_dtype != torch.float32


_MODES = {
    "parity": Numerics(),
    "high": Numerics(),
    "mixed": Numerics(),
    "fast": Numerics(compute_dtype=torch.bfloat16),
    "fast16": Numerics(compute_dtype=torch.float16),
    "fasthi": Numerics(storage_dtype=torch.bfloat16),
    "fasthi16": Numerics(storage_dtype=torch.float16),
}

_active_name = "parity"


def _tf32_off() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


_tf32_off()


def modes() -> list:
    """Names of the tiers."""
    return sorted(_MODES)


def numerics() -> Numerics:
    return _MODES[_active_name]


def set_mode(mode: str) -> None:
    global _active_name
    if mode not in _MODES:
        raise ValueError(f"unknown numerics mode: {mode!r} (have {modes()})")
    _active_name = mode
    _tf32_off()


def mode() -> str:
    return _active_name


@contextmanager
def numerics_mode(mode_name: str):
    prev = mode()
    set_mode(mode_name)
    try:
        yield
    finally:
        set_mode(prev)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. A CUDA request without a card raises; nothing falls back to
    the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
