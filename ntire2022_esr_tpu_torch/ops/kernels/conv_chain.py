"""Fused chain of 3x3 convs (+bias, store rounding, LeakyReLU), then + x.

Replaces the TPU kernel ``ntire2022_esr_tpu/ops/pallas/conv_chain.py``
``fused_conv3x3_chain`` (``pallas_call`` at :232) with the hand-written
CUDA kernel ``csrc/conv_chain.cu`` for Hopper (sm_90a). It is RLFN's RLFB
body: 46 -> 48 -> 48 -> 46 channels, called four times per forward.

Semantics are those of the unfused JAX graph, not of the Pallas kernel:
every stage's output is rounded to the storage dtype (saturating f16 under
``fasthi16``) before the LeakyReLU, as ``ops/nn.py`` ``conv2d`` ->
``store_out`` -> ``leaky_relu`` does; the Pallas kernel skipped that
rounding. :func:`conv3x3_chain_plain` is that graph in plain PyTorch.

Bound on an H100: at RLFN's widths the chain does 59,616 MACs and moves
184 bytes (f16 in and out) per pixel, so it is bound by operations; the
kernel accumulates in f32 on CUDA cores (67 TFLOP/s peak), as the tiers'
f32-grade contractions require. Its design: one block per 16x16 output
tile, the tile and its halo loaded once into shared memory, all stages run
there, only the last stage's tile written back. See ``PERF.md`` for its
time on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.ops import nn
from ntire2022_esr_tpu_torch.ops.kernels import build

# Launches of the CUDA kernel (not of the plain version) in this process.
launches = 0

_MAX_DEPTH = 4  # csrc/conv_chain.cu kMaxDepth
_V = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_chain")
    lib.conv3x3_chain.argtypes = [_I, _V, _V, _V, _V] + [_I] * 9 + [ctypes.c_float, _I, _V]
    lib.conv3x3_chain.restype = _I
    lib.conv3x3_chain_smem_bytes.argtypes = [_I] * 6
    lib.conv3x3_chain_smem_bytes.restype = ctypes.c_longlong
    return lib


def conv3x3_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[Optional[torch.Tensor]], *, slope: float = 0.05,
                        residual: bool = True) -> torch.Tensor:
    """The chain as the unfused graph computes it (``F.conv2d`` per stage)."""
    h = x
    for w, b in zip(weights, biases):
        h = nn.leaky_relu(nn.conv2d(h, w, b, padding=1), slope)
    return h + x if residual else h


def _check(x: torch.Tensor, weights, biases, residual: bool) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    if not 1 <= len(weights) <= _MAX_DEPTH or len(weights) != len(biases):
        raise ValueError(f"need 1..{_MAX_DEPTH} weights and as many biases")
    cin = x.shape[1]
    for w in weights:
        if w.dim() != 4 or tuple(w.shape[1:]) != (cin, 3, 3):
            raise ValueError(f"stage weight {tuple(w.shape)} does not take {cin} channels in 3x3")
        cin = w.shape[0]
    if residual and cin != x.shape[1]:
        raise ValueError(f"residual needs matching widths, got {x.shape[1]} -> {cin}")
    act = config.numerics().activation_dtype
    if x.dtype != act:
        raise TypeError(f"x is {x.dtype} but the {config.mode()} tier stores {act}")


def fused_conv3x3_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[Optional[torch.Tensor]], *, slope: float = 0.05,
                        residual: bool = True) -> torch.Tensor:
    """``depth`` same-padded 3x3 convs, each + bias, stored in the tier's
    dtype, then LeakyReLU(``slope``); then + ``x`` if ``residual``.

    ``x``: (N, C, H, W) channels_last in the tier's activation dtype;
    ``weights``: OIHW float32. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises.
    """
    global launches
    _check(x, weights, biases, residual)
    if x.device.type == "cpu":
        return conv3x3_chain_plain(x, weights, biases, slope=slope, residual=residual)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if not x.is_contiguous(memory_format=nn.CL):
        raise ValueError("x must be channels_last contiguous")
    for t in list(weights) + [b for b in biases if b is not None]:
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError("weights and biases must be float32 on x's device")
    lib = _lib()
    group = lib.esr_channel_group()
    packed = [build.pack_conv3x3(w, b, group) for w, b in zip(weights, biases)]
    wp = torch.cat([p[0] for p in packed])
    bp = torch.cat([p[1] for p in packed])
    n, c0, h, w = x.shape
    widths = [c0] + [int(wk.shape[0]) for wk in weights]
    widths += [0] * (_MAX_DEPTH + 1 - len(widths))
    depth = len(weights)
    if lib.conv3x3_chain_smem_bytes(depth, *widths) > build.MAX_SMEM:
        raise ValueError(f"widths {widths[:depth + 1]} need more shared memory than a block has")
    out = torch.empty((n, widths[depth], h, w), dtype=x.dtype, device=x.device,
                      memory_format=nn.CL)
    rc = lib.conv3x3_chain(
        build.dtype_code(x.dtype), x.data_ptr(), out.data_ptr(), wp.data_ptr(), bp.data_ptr(),
        n, h, w, depth, *widths, slope, int(residual),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "conv3x3_chain")
    launches += 1
    return out
