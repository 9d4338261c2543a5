"""Numerics tiers and device selection (counterpart of ``ntire2022_esr_tpu/config.py``).

A tier fixes the dtype of the contractions (``compute_dtype``) and, for
the storage tiers, the dtype every conv output is rounded to before it is
stored (``storage_dtype``; f16 saturates at +-65504 on the way in). The
JAX ``high`` tier is bf16x3 on the TPU's MXU, which is f32-grade; on the
card it is plain f32, the same as ``parity``. The tiers ``fast``,
``fast16`` and ``mixed`` are not ported yet (ROADMAP).

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


_MODES = {
    "parity": Numerics(),
    "high": Numerics(),
    "fasthi": Numerics(storage_dtype=torch.bfloat16),
    "fasthi16": Numerics(storage_dtype=torch.float16),
}

_active_name = "parity"


def _tf32_off() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


_tf32_off()


def modes() -> list:
    """Names of the ported tiers."""
    return sorted(_MODES)


def numerics() -> Numerics:
    return _MODES[_active_name]


def set_mode(mode: str) -> None:
    global _active_name
    if mode not in _MODES:
        raise ValueError(f"unknown numerics mode: {mode!r} (have {modes()}; "
                         "fast/fast16/mixed are not ported yet, see ROADMAP.md)")
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
