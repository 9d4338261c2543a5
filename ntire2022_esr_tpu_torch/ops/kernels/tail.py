"""Fused conv3x3 + PixelShuffle(r): RLFN's upsampler and the zoo's x2 upsamplers.

Replaces the TPU kernel ``ntire2022_esr_tpu/ops/pallas/tail.py``
``fused_conv3x3_pixelshuffle`` (``pallas_call`` at :112) with the
hand-written CUDA kernel ``csrc/tail.cu`` for Hopper (sm_90a). No JAX
model calls the Pallas kernel; the port's RLFN calls this one for its
upsampler (46 -> 48 channels, r = 4), once per forward, and the HR tails
of m_RFDN (52 -> 208 and 24 -> 96), LWFANet (64 -> 256, twice) and
NASNetBN (32 -> 128, twice) for their x2 upsamplers, r = 2
(``ops/fused.py``).

Semantics: ``pixel_shuffle(conv2d(x, w, b, padding=1), r)`` with the conv
output stored in the tier's dtype (``store_out``) and torch's channel
order, ``out[n, r*h+i, r*w+j, c] = conv[n, h, w, c*r*r + i*r + j]``.
:func:`conv3x3_pixelshuffle_plain` computes exactly that in plain PyTorch.

Bound on an H100: 19,872 MACs per low-resolution pixel against 188 bytes
(f16 in and out). At the card's best rate for the work (f16 tensor cores,
989 TFLOP/s) the operations take 0.34 ms at batch 128 x 256 x 256 and the
bytes 0.47 ms at 3.35 TB/s, so it is bound by bytes. With f32 activations
(376 bytes a pixel) the f32-grade work on split TF32 (495 TFLOP/s over 3
products) takes 2.0 ms and bounds it; with bf16 activations (2 products)
1.35 ms.

Design. A block takes a low-resolution tile with a one-pixel halo into
shared memory; the conv result stays in shared memory and the shuffled
high-resolution tile is written in whole rows, so the (H, W, r*r*cout)
intermediate never reaches device memory. Under 2-byte storage the conv is
one stage of the chain kernel's tensor-core routine (``mma.sync.m16n8k16``
with f32 accumulation): under ``fasthi16`` on f16 activations and f32
weights split into two f16 terms (f32-grade, see ``conv_chain.split_f16``;
:func:`pack_tail_f16`), under ``fast16`` and ``fast`` on f16 or bf16
activations and weights packed once rounded to the dtype, one exact
product, with the two-rounding epilogue (:func:`pack_tail_2byte`). One
persistent block per SM keeps the stage's whole packed weights in shared
memory and walks over 16x22 tiles; tensor copies (TMA) bring the next
tile's window under this tile's MMAs and take the finished tile away. The
shuffle costs the kernel nothing: the packs put the output channels in the
order ``(i, j, c)``, so the ``r * cout`` channels of a pixel that belong to
output row ``r*y + i`` are one contiguous run there. Under f32 and bf16
storage with f32 weights (``parity``, ``high``, ``mixed``, ``fasthi``) the
same plan runs on split TF32 (``mma.sync.m16n8k8``, three products under
f32 activations, two under bf16; ``conv_chain.split_tf32``), with the
weights staged one tap at a time (:func:`pack_tail_tf32`) and plain
copies. Weights are packed once per weight set
(``conv_chain.packed_weights``). See ``PERF.md`` for the times on the card.

Channel groups. Where a block cannot hold the whole conv's packed weights
and result (52 -> 208 and 64 -> 256 at r = 2, and 32 -> 128 under
``fasthi16``), the kernel splits the output channels, in their shuffled
order, into groups of equal width: one a shuffle position (i, j), or a
part of one. Each block computes one group of each tile it takes and
writes the group's run of each pixel with plain stores; the window of a
tile is read by the blocks of all its groups at about the same time. The
packs then hold the groups one after the other, each as a stage of its own
(``groups`` of the packing functions), and the C entry point
``conv3x3_pixelshuffle_groups`` says how many a launch takes.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.ops import nn
from ntire2022_esr_tpu_torch.ops.kernels import build
from ntire2022_esr_tpu_torch.ops.kernels import conv_chain
from ntire2022_esr_tpu_torch.ops.kernels.conv_chain import (FAST_PATHS, pack_chain_2byte,
                                                            pack_chain_f16, pack_chain_tf32,
                                                            packed_weights, path)

# Launches of the CUDA kernels (not of the plain version) in this process,
# by path, as in conv_chain; and by (path, cin, r * r * cout, r).
launches_by_path = dict.fromkeys(conv_chain.launches_by_path, 0)
launches_by_shape: Dict[Tuple[str, int, int, int], int] = {}

_V = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("tail")
    lib.conv3x3_pixelshuffle.argtypes = [_I, _I, _V, _V, _V, _V] + [_I] * 6 + [_V]
    lib.conv3x3_pixelshuffle.restype = _I
    lib.conv3x3_pixelshuffle_smem_bytes.argtypes = [_I] * 5
    lib.conv3x3_pixelshuffle_smem_bytes.restype = ctypes.c_longlong
    lib.conv3x3_pixelshuffle_groups.argtypes = [_I] * 5
    lib.conv3x3_pixelshuffle_groups.restype = _I
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


def channel_groups(w: torch.Tensor, b: Optional[torch.Tensor], r: int,
                   groups: int = 1) -> Tuple[list, list]:
    """The conv's weights and bias with the output channels permuted by
    :func:`shuffled_order` (each channel's sum is independent, so no value
    changes), split into ``groups`` runs of equal width: the stages that
    the packings take, one a channel group of the kernel."""
    nch = int(w.shape[0])
    if nch % groups:
        raise ValueError(f"{nch} channels do not split into {groups} groups")
    order = shuffled_order(nch // (r * r), r).to(w.device)
    ws, bs = w[order], None if b is None else b[order]
    cg = nch // groups
    return ([ws[g * cg:(g + 1) * cg] for g in range(groups)],
            [None if bs is None else bs[g * cg:(g + 1) * cg] for g in range(groups)])


def pack_tail_f16(w: torch.Tensor, b: Optional[torch.Tensor], r: int,
                  groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the tensor-core kernel reads them: the channel
    groups of :func:`channel_groups`, each packed as one stage of the chain
    (``conv_chain.pack_chain_f16``): split f16 weights in fragment order,
    then ``1 / S`` and the bias per channel."""
    return pack_chain_f16(*channel_groups(w, b, r, groups))


def pack_tail_2byte(w: torch.Tensor, b: Optional[torch.Tensor], r: int,
                    dtype: torch.dtype, groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the one-product kernel of a 2-byte tier
    (``fast16``, ``fast``) reads them: the channel groups of
    :func:`channel_groups`, each packed as one stage by the chain's
    one-term packing (``conv_chain.pack_chain_2byte``): each weight once,
    rounded to ``dtype``, in fragment order, then a scale of 1 and the
    rounded bias per channel."""
    return pack_chain_2byte(*channel_groups(w, b, r, groups), dtype)


def pack_tail_tf32(w: torch.Tensor, b: Optional[torch.Tensor], r: int,
                   groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the split-TF32 kernel reads them: the channel
    groups of :func:`channel_groups`, each packed as one stage of the chain
    (``conv_chain.pack_chain_tf32``): TF32 hi and lo terms in fragment
    order, then the bias per channel."""
    return pack_chain_tf32(*channel_groups(w, b, r, groups))


def layout(dtype: torch.dtype, r: int, compute: torch.dtype = torch.float32,
           groups: int = 1) -> Tuple[str, Callable]:
    """The packed-weight cache key and packing (of ``[w], [b]``) of the
    kernel that takes activations of ``dtype`` under a tier that contracts
    in ``compute``, as ``conv_chain.layout``, in ``groups`` channel
    groups."""
    g = f"_r{r}_g{groups}"
    if compute != torch.float32:
        if dtype != compute:
            raise TypeError(f"a {compute} tier stores {compute} activations, not {dtype}")
        return (f"tail_mma_{FAST_PATHS[compute]}{g}",
                lambda ws, bs: pack_tail_2byte(ws[0], bs[0], r, compute, groups))
    if dtype == torch.float16:
        return f"tail_mma_f16{g}", lambda ws, bs: pack_tail_f16(ws[0], bs[0], r, groups)
    return f"tail_mma_tf32{g}", lambda ws, bs: pack_tail_tf32(ws[0], bs[0], r, groups)


def fused_conv3x3_pixelshuffle(x: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor] = None, *, r: int = 4) -> torch.Tensor:
    """conv2d(x, w, b, padding=1) then pixel_shuffle(r).

    ``x``: (N, C, H, W) channels_last in the tier's activation dtype;
    ``w``: OIHW float32 with ``cout * r * r`` output channels. Returns
    (N, cout, r*H, r*W) channels_last. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.
    """
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
    nm = config.numerics()
    with torch.cuda.device(x.device):
        lib = _lib()
        n, cin, h, wd = x.shape
        cout = nch // (r * r)
        code = build.dtype_code(x.dtype)
        fast = int(nm.two_byte_compute)
        if lib.conv3x3_pixelshuffle_smem_bytes(code, fast, cin, cout, r) > build.MAX_SMEM:
            raise ValueError(f"{cin} -> {nch} channels need more shared memory than a block has")
        groups = lib.conv3x3_pixelshuffle_groups(code, fast, cin, cout, r)
        key, pack = layout(x.dtype, r, nm.compute_dtype, groups)
        wp, bp = packed_weights(key, [w], [b], pack)
        out = torch.empty((n, cout, h * r, wd * r), dtype=x.dtype, device=x.device,
                          memory_format=nn.CL)
        rc = lib.conv3x3_pixelshuffle(
            code, fast, x.data_ptr(), out.data_ptr(), wp.data_ptr(),
            bp.data_ptr(), n, h, wd, cin, cout, r,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, rc, "conv3x3_pixelshuffle")
    p = path(nm)
    launches_by_path[p] += 1
    shape = (p, cin, nch, r)
    launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    return out
