"""Fused conv3x3 + PixelShuffle(r): RLFN's upsampler.

Replaces the TPU kernel ``ntire2022_esr_tpu/ops/pallas/tail.py``
``fused_conv3x3_pixelshuffle`` (``pallas_call`` at :112) with the
hand-written CUDA kernel ``csrc/tail.cu`` for Hopper (sm_90a). No JAX
model calls the Pallas kernel; the port's RLFN calls this one for its
upsampler (46 -> 48 channels, r = 4), once per forward.

Semantics: ``pixel_shuffle(conv2d(x, w, b, padding=1), r)`` with the conv
output stored in the tier's dtype (``store_out``) and torch's channel
order, ``out[n, r*h+i, r*w+j, c] = conv[n, h, w, c*r*r + i*r + j]``.
:func:`conv3x3_pixelshuffle_plain` computes exactly that in plain PyTorch.

Bound on an H100: 19,872 MACs per low-resolution pixel against 188 bytes
(f16 in and out). At the card's best rate for the work (f16 tensor cores,
989 TFLOP/s) the operations take 0.34 ms at batch 128 x 256 x 256 and the
bytes 0.47 ms at 3.35 TB/s, so it is bound by bytes.

Design. A block takes a low-resolution tile with a one-pixel halo into
shared memory; the conv result stays in shared memory and the shuffled
high-resolution tile is written in whole rows, so the (H, W, r*r*cout)
intermediate never reaches device memory. Under f16 storage (``fasthi16``)
the conv is one stage of the chain kernel's tensor-core routine
(``mma.sync.m16n8k16`` on f16 activations and f32 weights split into two
f16 terms, f32 accumulation: f32-grade, see ``conv_chain.split_f16``): one
persistent block per SM keeps the stage's whole packed weights in shared
memory and walks over 16x22 tiles; tensor copies (TMA) bring the next
tile's window under this tile's MMAs and take the finished tile away. The
shuffle costs the kernel nothing: :func:`pack_tail_f16` packs the output
channels in the order ``(i, j, c)``, so the ``r * cout`` channels of a
pixel that belong to output row ``r*y + i`` are one contiguous run there.
Under f32 and bf16 storage the kernel multiplies in f32 on CUDA cores, one
block per 16x16 tile. Weights are packed once per weight set
(``conv_chain.packed_weights``). See ``PERF.md`` for the times on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.ops import nn
from ntire2022_esr_tpu_torch.ops.kernels import build
from ntire2022_esr_tpu_torch.ops.kernels.conv_chain import pack_chain_f16, packed_weights

# Launches of the CUDA kernel (not of the plain version) in this process.
launches = 0

_V = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("tail")
    lib.conv3x3_pixelshuffle.argtypes = [_I, _V, _V, _V, _V] + [_I] * 6 + [_V]
    lib.conv3x3_pixelshuffle.restype = _I
    lib.conv3x3_pixelshuffle_smem_bytes.argtypes = [_I] * 4
    lib.conv3x3_pixelshuffle_smem_bytes.restype = ctypes.c_longlong
    return lib


def conv3x3_pixelshuffle_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                               *, r: int = 4) -> torch.Tensor:
    """The tail as the unfused graph computes it."""
    return nn.pixel_shuffle(nn.conv2d(x, w, b, padding=1), r)


def shuffled_order(cout: int, r: int) -> torch.Tensor:
    """The conv's output channels in the order the tensor-core kernel
    computes them: position ``(i*r + j)*cout + c`` holds channel
    ``c*r*r + i*r + j``, so that what PixelShuffle puts side by side in an
    output row (``j`` and ``c`` for one ``i``) is contiguous."""
    return torch.arange(cout * r * r).reshape(cout, r * r).t().reshape(-1)


def pack_tail_f16(w: torch.Tensor, b: Optional[torch.Tensor],
                  r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the tensor-core kernel reads them: the output
    channels permuted by :func:`shuffled_order` (each channel's sum is
    independent, so no value changes), then the chain's packing of one
    stage (``conv_chain.pack_chain_f16``): split f16 weights in fragment
    order, then ``1 / S`` and the bias per channel."""
    order = shuffled_order(int(w.shape[0]) // (r * r), r).to(w.device)
    return pack_chain_f16([w[order]], [None if b is None else b[order]])


def fused_conv3x3_pixelshuffle(x: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor] = None, *, r: int = 4) -> torch.Tensor:
    """conv2d(x, w, b, padding=1) then pixel_shuffle(r).

    ``x``: (N, C, H, W) channels_last in the tier's activation dtype;
    ``w``: OIHW float32 with ``cout * r * r`` output channels. Returns
    (N, cout, r*H, r*W) channels_last. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.
    """
    global launches
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"weight {tuple(w.shape)} does not fit x {tuple(x.shape)} as a 3x3 conv")
    nch = int(w.shape[0])
    if nch % (r * r):
        raise ValueError(f"{nch} output channels do not shuffle by r={r}")
    act = config.numerics().activation_dtype
    if x.dtype != act:
        raise TypeError(f"x is {x.dtype} but the {config.mode()} tier stores {act}")
    if x.device.type == "cpu":
        return conv3x3_pixelshuffle_plain(x, w, b, r=r)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if not x.is_contiguous(memory_format=nn.CL):
        raise ValueError("x must be channels_last contiguous")
    for t in (w,) if b is None else (w, b):
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError("weight and bias must be float32 on x's device")
    # the packing, the shared-memory opt-in, the SM count and the launch
    # act on the current device: make it x's
    with torch.cuda.device(x.device):
        lib = _lib()
        n, cin, h, wd = x.shape
        cout = nch // (r * r)
        code = build.dtype_code(x.dtype)
        if lib.conv3x3_pixelshuffle_smem_bytes(code, cin, cout, r) > build.MAX_SMEM:
            raise ValueError(f"{cin} -> {nch} channels need more shared memory than a block has")
        if x.dtype == torch.float16:
            wp, bp = packed_weights(f"tail_mma_f16_r{r}", [w], [b],
                                    lambda ws, bs: pack_tail_f16(ws[0], bs[0], r))
        else:
            group = lib.esr_channel_group()
            wp, bp = packed_weights(f"tail_f32_group{group}", [w], [b],
                                    lambda ws, bs: build.pack_conv3x3(ws[0], bs[0], group))
        out = torch.empty((n, cout, h * r, wd * r), dtype=x.dtype, device=x.device,
                          memory_format=nn.CL)
        rc = lib.conv3x3_pixelshuffle(
            code, x.data_ptr(), out.data_ptr(), wp.data_ptr(), bp.data_ptr(),
            n, h, wd, cin, cout, r, torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, rc, "conv3x3_pixelshuffle")
    launches += 1
    return out
