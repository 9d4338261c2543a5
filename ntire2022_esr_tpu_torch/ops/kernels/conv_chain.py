"""Fused chain of 3x3 convs (+bias, store rounding, LeakyReLU), then + x.

Replaces the TPU kernel ``ntire2022_esr_tpu/ops/pallas/conv_chain.py``
``fused_conv3x3_chain`` (``pallas_call`` at :232) with the hand-written
CUDA kernels of ``csrc/conv_chain.cu`` for Hopper (sm_90a). It is RLFN's
RLFB body: 46 -> 48 -> 48 -> 46 channels, called four times per forward.

Semantics are those of the unfused JAX graph, not of the Pallas kernel:
every stage's output is rounded to the storage dtype (saturating f16 under
``fasthi16``) before the LeakyReLU, as ``ops/nn.py`` ``conv2d`` ->
``store_out`` -> ``leaky_relu`` does; the Pallas kernel skipped that
rounding. :func:`conv3x3_chain_plain` is that graph in plain PyTorch.

Bound on an H100: at RLFN's widths the chain does 59,616 MACs and moves
184 bytes (f16 in and out) per pixel, so it is bound by operations: on f16
tensor cores (989 TFLOP/s) that is 1.03 ms at batch 128 x 256 x 256.

Design. One block per output tile; the tile and its halo are loaded once
into shared memory, all stages run there, and only the last stage's tile
is written back. Under f16 storage (``fasthi16``) the stages run on the
tensor cores (``mma.sync.m16n8k16``, f32 accumulation): the activations
are exact f16 values, and each f32 weight is split on the host into two
f16 terms under a power-of-two scale per output channel
(:func:`split_f16`), so two f16 products give the f32-grade result the
tier requires. Under f32 and bf16 storage the kernel multiplies in f32 on
CUDA cores (67 TFLOP/s peak). Weights are packed into the kernels' layouts
once per weight set and cached (:func:`packed_weights`). See ``PERF.md``
for the times on the card.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.ops import nn
from ntire2022_esr_tpu_torch.ops.kernels import build

# Launches of the CUDA kernel (not of the plain version) in this process.
launches = 0

# Times a chain's weights were packed (cache misses) in this process.
packs = 0

_MAX_DEPTH = 4  # csrc/conv_chain.cu kMaxDepth
_NT_CHUNK = 6  # csrc/mma_stage.cuh kNtChunk: n-tiles of 8 channels per chunk of packed weights
_CACHE_SIZE = 64  # weight sets kept packed
_V = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_chain")
    lib.conv3x3_chain.argtypes = [_I, _V, _V, _V, _V] + [_I] * 9 + [ctypes.c_float, _I, _V]
    lib.conv3x3_chain.restype = _I
    lib.conv3x3_chain_smem_bytes.argtypes = [_I] * 7
    lib.conv3x3_chain_smem_bytes.restype = ctypes.c_longlong
    if lib.conv3x3_chain_ntile_chunk() != _NT_CHUNK:
        raise RuntimeError("csrc/mma_stage.cuh kNtChunk and _NT_CHUNK differ")
    return lib


def conv3x3_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[Optional[torch.Tensor]], *, slope: float = 0.05,
                        residual: bool = True) -> torch.Tensor:
    """The chain as the unfused graph computes it (``F.conv2d`` per stage)."""
    h = x
    for w, b in zip(weights, biases):
        h = nn.leaky_relu(nn.conv2d(h, w, b, padding=1), slope)
    return h + x if residual else h


def split_f16(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split OIHW f32 weights into two f16 terms under a scale per output
    channel: returns ``(w_hi, w_lo, inv_scale)`` with
    ``w * S = w_hi + w_lo * 2**-11`` to about 2**-22 relative and
    ``inv_scale = 1 / S``.

    ``S`` is the power of two that brings the channel's largest ``|w|``
    into [2**13, 2**14): below f16's largest value, and high enough that
    weights down to 2**-27 of the largest keep full precision instead of
    falling into f16's subnormals. ``w * S`` is exact, and so is the
    remainder ``w * S - w_hi`` in f32. A channel of zeros gets ``S = 1``.
    """
    top = w.abs().amax(dim=(1, 2, 3))
    exp = torch.frexp(top)[1]  # top = f * 2**exp with f in [0.5, 1)
    shift = torch.where(top > 0, 14 - exp, torch.zeros_like(exp)).clamp(-100, 100)
    one = torch.ones_like(top)
    ws = w * torch.ldexp(one, shift)[:, None, None, None]
    w_hi = ws.to(torch.float16)
    w_lo = ((ws - w_hi.float()) * 2048.0).to(torch.float16)
    return w_hi, w_lo, torch.ldexp(one, -shift)


def pack_chain_f16(weights: Sequence[torch.Tensor],
                   biases: Sequence[Optional[torch.Tensor]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's weights as the tensor-core kernel reads them.

    Returns ``(wq, sb)``. ``wq`` (f16, flat) holds, per stage, the split
    weights in the order the ``mma.sync.m16n8k16`` B fragments are read:
    [chunk of ``_NT_CHUNK`` n-tiles][ky][kx][k-chunk of 16 input channels]
    [n-tile of 8 output channels][lane = 4 g + t][hi b0, hi b1, lo b0,
    lo b1], where lane (g, t) holds output channel ``8 ntile + g`` and b0,
    b1 are the input-channel pairs ``2t, 2t+1`` and ``2t+8, 2t+9`` of the
    k-chunk. Input channels are zero-padded to whole k-chunks and output
    channels to whole n-tiles. ``sb`` (f32, flat) holds, per stage,
    ``1 / S`` per output channel (1 in the pad) and then the bias (0 in
    the pad).
    """
    wq, sb = [], []
    for w, b in zip(weights, biases):
        cout, cin = int(w.shape[0]), int(w.shape[1])
        kc, nt = -(-cin // 16), -(-cout // 8)
        w_hi, w_lo, inv = split_f16(w)
        hl = torch.stack([w_hi, w_lo]).permute(0, 1, 3, 4, 2)  # [s, cout, ky, kx, cin]
        hl = F.pad(hl, (0, kc * 16 - cin, 0, 0, 0, 0, 0, nt * 8 - cout))
        # [s, ntile, g, ky, kx, k-chunk, b0/b1, t, pair]
        v = hl.reshape(2, nt, 8, 3, 3, kc, 2, 4, 2)
        for n0 in range(0, nt, _NT_CHUNK):
            wq.append(v[:, n0:n0 + _NT_CHUNK].permute(3, 4, 5, 1, 2, 7, 0, 6, 8).reshape(-1))
        sb.append(F.pad(inv, (0, nt * 8 - cout), value=1.0))
        bias = torch.zeros(nt * 8, dtype=torch.float32, device=w.device)
        if b is not None:
            bias[:cout] = b
        sb.append(bias)
    return torch.cat(wq).contiguous(), torch.cat(sb).contiguous()


def _pack_chain_f32(weights, biases, group: int):
    packed = [build.pack_conv3x3(w, b, group) for w, b in zip(weights, biases)]
    return torch.cat([p[0] for p in packed]), torch.cat([p[1] for p in packed])


_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


def packed_weights(layout: str, weights: Sequence[torch.Tensor],
                   biases: Sequence[Optional[torch.Tensor]], pack: Callable):
    """``pack(weights, biases)``, computed once per weight set.

    The key is the layout's name and each tensor's ``data_ptr()``,
    ``_version`` and device, so an in-place update or a copy on another
    device packs anew. An entry keeps its tensors alive, so no later
    tensor can take a cached one's address. Inference tensors carry no
    version and are packed on every call.
    """
    global packs
    tensors = [t for t in list(weights) + list(biases) if t is not None]
    if any(t.is_inference() for t in tensors):
        packs += 1
        return pack(weights, biases)
    key = (layout, tuple(None if b is None else i for i, b in enumerate(biases)),
           tuple((t.data_ptr(), t._version, str(t.device)) for t in tensors))
    hit = _cache.get(key)
    if hit is not None:
        _cache.move_to_end(key)
        return hit[0]
    packs += 1
    out = pack(weights, biases)
    _cache[key] = (out, tensors)
    while len(_cache) > _CACHE_SIZE:
        _cache.popitem(last=False)
    return out


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
    # the packing, the shared-memory opt-in and the launch act on the
    # current device: make it x's
    with torch.cuda.device(x.device):
        lib = _lib()
        code = build.dtype_code(x.dtype)
        if x.dtype == torch.float16:
            wp, bp = packed_weights("mma_f16", weights, biases, pack_chain_f16)
        else:
            group = lib.esr_channel_group()
            wp, bp = packed_weights(f"f32_group{group}", weights, biases,
                                    lambda ws, bs: _pack_chain_f32(ws, bs, group))
        n, c0, h, w = x.shape
        widths = [c0] + [int(wk.shape[0]) for wk in weights]
        widths += [0] * (_MAX_DEPTH + 1 - len(widths))
        depth = len(weights)
        if lib.conv3x3_chain_smem_bytes(code, depth, *widths) > build.MAX_SMEM:
            raise ValueError(f"widths {widths[:depth + 1]} need more shared memory than a block has")
        out = torch.empty((n, widths[depth], h, w), dtype=x.dtype, device=x.device,
                          memory_format=nn.CL)
        rc = lib.conv3x3_chain(
            code, x.data_ptr(), out.data_ptr(), wp.data_ptr(), bp.data_ptr(),
            n, h, w, depth, *widths, slope, int(residual),
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, rc, "conv3x3_chain")
    launches += 1
    return out
