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
matmuls: TF32 keeps about three decimal digits, which no tier allows. It
also keeps cuBLAS from reducing f16 and bf16 products in their own
precision: the JAX package sums them in f32.

The active tier is process-global, like the JAX package's, and so are
``weights_int8`` (the w8 weight-storage tier, ``porter/quant.py``),
``attn_bf16`` (the storage dtype of the window-attention models' scores)
and the two settings the HR tails read: ``fuse_upsample_conv`` (the fused
nearest-x2 upsample + conv of ``ops/fused.py``) and ``hr_tail`` (a 2-byte
tier for a model's full-resolution tail, entered by ``hr_tail_scope``).

The environment sets their starting values when the module is imported,
with the JAX package's names, values and errors: ``NTIRE_W8=1``,
``NTIRE_FUSE_UPSAMPLE_CONV=0|1``, ``NTIRE_ATTN_BF16=off|probs|scores|
scores_f16``, ``NTIRE_HR_TAIL=off|bf16|f16`` (or the older
``NTIRE_HR_TAIL_BF16=0|1``). Unset is the default: w8 off, the others
AUTO.
"""

from __future__ import annotations

import dataclasses
import os
from contextlib import contextmanager
from typing import Optional, Union

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
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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


# The w8 tier (porter/quant.py): int8 weights with one f32 scale per
# (cin, cout) pair of a conv and per output column of a linear, dequantized
# at use in the tier's compute dtype (ops.nn.dequant_weight). It changes
# what the weights hold; activations and contractions keep the tier.
# registry.build_model quantizes the cached weights at load when it is on.
_weights_int8 = os.environ.get("NTIRE_W8", "0") == "1"


def weights_int8() -> bool:
    return _weights_int8


def set_weights_int8(value: bool) -> None:
    global _weights_int8
    _weights_int8 = bool(value)


# The fused nearest-x2 upsample + 3x3 conv (ops/fused.py): a low-resolution
# conv to 4 * cout channels and a PixelShuffle(2), exact up to f32
# reassociation. None is AUTO, on in every tier but parity (which keeps the
# reference-shaped graph); set_fuse_upsample_conv forces it.
_fuse_upsample_conv: Optional[bool] = (
    None if "NTIRE_FUSE_UPSAMPLE_CONV" not in os.environ
    else os.environ["NTIRE_FUSE_UPSAMPLE_CONV"] == "1")


def fuse_upsample_conv() -> bool:
    if _fuse_upsample_conv is None:
        return _active_name != "parity"
    return _fuse_upsample_conv


def set_fuse_upsample_conv(value: Optional[bool]) -> None:
    global _fuse_upsample_conv
    _fuse_upsample_conv = value if value is None else bool(value)


# The storage dtype of the (windows, heads, N, N) scores of
# ops/attention.multi_head_attention at a model's site: "off" (f32),
# "probs" (the softmax output in bf16), "scores" (the logits rounded to bf16
# before the softmax, and its output in bf16), "scores_f16" (both in f16).
# The 2-byte probabilities meet v in that dtype, products summed in f32.
# Each fires on f32 scores only. None is AUTO: the sites below get their
# value in every tier but parity; set_attn_bf16 forces one value for every
# site.
_ATTN_VALUES = ("off", "probs", "scores", "scores_f16")
_ATTN_BF16_AUTO_SITES = {"mobilesr": "scores", "hnct": "scores", "imdtn": "scores"}
_attn_bf16: Optional[str] = os.environ.get("NTIRE_ATTN_BF16") or None
if _attn_bf16 is not None and _attn_bf16 not in _ATTN_VALUES:
    raise ValueError(f"NTIRE_ATTN_BF16 must be one of {_ATTN_VALUES}, got {_attn_bf16!r}")


def attn_bf16(site: str = "mha") -> str:
    """The score storage of ``site``: "off", "probs", "scores" or "scores_f16"."""
    if _attn_bf16 is None:
        if _active_name != "parity":
            return _ATTN_BF16_AUTO_SITES.get(site, "off")
        return "off"
    return _attn_bf16


def set_attn_bf16(value: Optional[str]) -> None:
    """Force the score storage of every site; None restores AUTO."""
    global _attn_bf16
    if value is not None and value not in _ATTN_VALUES:
        raise ValueError(f"attn_bf16 must be one of {_ATTN_VALUES} or None, got {value!r}")
    _attn_bf16 = value


def attn_bf16_override() -> Optional[str]:
    """The forced value, None under AUTO: a caller saves it to restore it."""
    return _attn_bf16


# The HR tail's tier: a model's full-resolution upsampler runs under a
# 2-byte tier ("bf16": fast, "f16": fast16) while its body keeps the active
# one. None is AUTO: the sites below get their tier under the f32-activation
# tiers but parity (high, mixed); parity and every tier with 2-byte compute
# or storage get "off". set_hr_tail forces one value for every site.
_HR_TAIL_VALUES = ("off", "bf16", "f16")
_HR_TAIL_AUTO_SITES = {"m_rfdn": "bf16", "lwfanet": "bf16", "nasnetbn": "bf16",
                       "mobilesr": "bf16"}
_HR_TAIL_MODE = {"bf16": "fast", "f16": "fast16"}


def _hr_tail_from_env() -> Optional[str]:
    """``NTIRE_HR_TAIL``, else the older ``NTIRE_HR_TAIL_BF16`` ("1" is
    "bf16", anything else "off"), else None (AUTO)."""
    v = os.environ.get("NTIRE_HR_TAIL")
    if v is not None:
        if v not in _HR_TAIL_VALUES:
            raise ValueError(f"NTIRE_HR_TAIL must be one of {_HR_TAIL_VALUES}, got {v!r}")
        return v
    legacy = os.environ.get("NTIRE_HR_TAIL_BF16")
    if legacy is not None:
        return "bf16" if legacy == "1" else "off"
    return None


_hr_tail: Optional[str] = _hr_tail_from_env()


def hr_tail(site: str) -> str:
    """The HR-tail tier of ``site``: "off", "bf16" or "f16"."""
    if _hr_tail is None:
        nm = numerics()
        if _active_name == "parity" or nm.two_byte_compute or nm.storage_dtype is not None:
            return "off"
        return _HR_TAIL_AUTO_SITES.get(site, "off")
    return _hr_tail


def set_hr_tail(value: Union[str, bool, None]) -> None:
    """Force the HR-tail tier of every site; None restores AUTO. The older
    booleans are taken too: True is "bf16", False "off"."""
    global _hr_tail
    if isinstance(value, bool):
        value = "bf16" if value else "off"
    if value is not None and value not in _HR_TAIL_VALUES:
        raise ValueError(f"hr_tail must be one of {_HR_TAIL_VALUES} or None, got {value!r}")
    _hr_tail = value


def hr_tail_override() -> Optional[str]:
    """The forced value, None under AUTO: a caller saves it to restore it."""
    return _hr_tail


def hr_tail_bf16(site: str) -> bool:
    """The older boolean form of :func:`hr_tail`: is the site's tail bf16?"""
    return hr_tail(site) == "bf16"


def set_hr_tail_bf16(value: Optional[bool]) -> None:
    """The older boolean form of :func:`set_hr_tail`."""
    set_hr_tail(value)


@contextmanager
def hr_tail_scope(site: str):
    """``fast`` (or ``fast16``) for a model's HR tail where ``hr_tail(site)``
    is on, else nothing. Yields the tail's tier ("" when off) and restores
    the active tier, name included, on the way out, also after an
    exception."""
    tier = hr_tail(site)
    if tier == "off":
        yield ""
        return
    prev = mode()
    set_mode(_HR_TAIL_MODE[tier])
    try:
        yield tier
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
