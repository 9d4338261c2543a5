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
184 bytes (2-byte in and out) per pixel, so it is bound by operations: on
2-byte tensor cores (989 TFLOP/s, one product a MAC) that is 1.03 ms at
batch 128 x 256 x 256; with f32-grade work on split TF32 (495 TFLOP/s over
3 products) 6.1 ms under f32 activations.

Design. One block per output tile; the tile and its halo are loaded once
into shared memory, all stages run there, and only the last stage's tile
is written back. Every tier runs on the tensor cores. Under f16 storage
with f32 weights (``fasthi16``): ``mma.sync.m16n8k16`` on the activations,
which are exact f16 values, and each f32 weight split on the host into two
f16 terms under a power-of-two scale per output channel (:func:`split_f16`);
two products, f32-grade. Under ``fast16`` and ``fast`` the weights
themselves are 2-byte: the same instruction on f16 or bf16 operands, each
weight packed once rounded to the tier's dtype (:func:`pack_chain_2byte`);
one exact product, and the kernel rounds each sum to the dtype before it
adds the bias, as the unfused graph does (two roundings). Under f32
storage (``parity``, ``high``, ``mixed``) and bf16 storage with f32
weights (``fasthi``): ``mma.sync.m16n8k8`` on TF32 terms, each weight
split on the host into two (:func:`split_tf32`) and each activation in
registers, three products (two for bf16 activations, which are exact TF32
values). Weights are packed into the kernels' layouts once per weight set
and cached (:func:`packed_weights`), the 2-byte tiers' under keys of their
own (:func:`layout`). See ``PERF.md`` for the times on the card.
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

# Launches of the CUDA kernels (not of the plain version) in this process,
# by path: "f16" (f16 activations and f32 weights, two f16 products:
# fasthi16), "f16x1" and "bf16x1" (2-byte activations and weights, one
# m16n8k16 product: fast16 and fast), "tf32x3" (f32 activations: parity,
# high, mixed) and "tf32x2" (bf16 activations and f32 weights: fasthi). All
# of them: the sum of the values. PATHS maps the activation dtype of a tier
# with f32 weights to its path, FAST_PATHS that of a 2-byte tier.
PATHS = {torch.float16: "f16", torch.float32: "tf32x3", torch.bfloat16: "tf32x2"}
FAST_PATHS = {torch.float16: "f16x1", torch.bfloat16: "bf16x1"}
launches_by_path = dict.fromkeys(["f16", "f16x1", "bf16x1", "tf32x3", "tf32x2"], 0)

# Times a chain's weights were packed (cache misses) in this process.
packs = 0

_MAX_DEPTH = 4  # csrc/conv_chain.cu kMaxDepth
_NT_CHUNK = 6  # csrc/mma_stage.cuh kNtChunk: n-tiles of 8 channels per chunk of packed weights
_CACHE_SIZE = 64  # weight sets kept packed
_V = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_chain")
    lib.conv3x3_chain.argtypes = [_I, _I, _V, _V, _V, _V] + [_I] * 9 + [ctypes.c_float, _I, _V]
    lib.conv3x3_chain.restype = _I
    lib.conv3x3_chain_smem_bytes.argtypes = [_I] * 8
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


def pack_chain_2byte(weights: Sequence[torch.Tensor], biases: Sequence[Optional[torch.Tensor]],
                     dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's weights as the one-product kernel of a 2-byte tier
    (``fast16``: float16, ``fast``: bfloat16) reads them: each weight once,
    rounded to ``dtype`` as :func:`rounded` rounds it.

    Returns ``(wq, sb)``. ``wq`` (``dtype``, flat) holds, per stage, the
    weights in the order the ``mma.sync.m16n8k16`` B fragments are read,
    as :func:`pack_chain_f16` with one term: [chunk of ``_NT_CHUNK``
    n-tiles][ky][kx][k-chunk of 16 input channels][n-tile of 8 output
    channels][lane = 4 g + t][b0, b1], b0 and b1 the input-channel pairs
    ``2t, 2t+1`` and ``2t+8, 2t+9`` of the k-chunk for output channel
    ``8 ntile + g``. Pads are zero. ``sb`` (f32, flat) holds, per stage,
    the layout of :func:`pack_chain_f16`: a scale of 1 per output channel
    (the kernel does not read it under one product) and then the bias
    rounded to ``dtype`` (0 in the pad).
    """
    wr, br = rounded(weights, biases, dtype)
    wq, sb = [], []
    for w, b in zip(wr, br):
        cout, cin = int(w.shape[0]), int(w.shape[1])
        kc, nt = -(-cin // 16), -(-cout // 8)
        v = F.pad(w.to(dtype).permute(0, 2, 3, 1), (0, kc * 16 - cin, 0, 0, 0, 0, 0, nt * 8 - cout))
        # [ntile, g, ky, kx, k-chunk, b0/b1, t, pair]
        v = v.reshape(nt, 8, 3, 3, kc, 2, 4, 2)
        for n0 in range(0, nt, _NT_CHUNK):
            wq.append(v[n0:n0 + _NT_CHUNK].permute(2, 3, 4, 0, 1, 6, 5, 7).reshape(-1))
        sb.append(torch.ones(nt * 8, dtype=torch.float32, device=w.device))
        bias = torch.zeros(nt * 8, dtype=torch.float32, device=w.device)
        if b is not None:
            bias[:cout] = b
        sb.append(bias)
    return torch.cat(wq).contiguous(), torch.cat(sb).contiguous()


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 explicit mantissa bits) to the
    nearest, ties away from zero, as ``cvt.rna.tf32.f32`` rounds: add half
    an ulp of TF32 (0x1000) to the bits, then clear the low 13. Finite
    inputs only."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split f32 values into two TF32 terms: ``w_hi = rna_tf32(w)``,
    ``w_lo = rna_tf32(w - w_hi)``, so that ``w_hi + w_lo`` is ``w`` to
    about 2**-22 relative. TF32 has f32's exponent range, so no scale is
    needed (unlike :func:`split_f16`); ``w - w_hi`` is exact in f32."""
    w_hi = round_tf32(w)
    return w_hi, round_tf32(w.to(torch.float32) - w_hi)


def pack_chain_tf32(weights: Sequence[torch.Tensor],
                    biases: Sequence[Optional[torch.Tensor]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's weights as the split-TF32 kernel reads them.

    Returns ``(wq, bq)``. ``wq`` (f32, flat) holds, per stage, the TF32
    terms of :func:`split_tf32` in the order the ``mma.sync.m16n8k8`` B
    fragments are read: [chunk of ``_NT_CHUNK`` n-tiles][tap = 3 ky + kx]
    [k-chunk of 16 input channels][n-tile of 8 output channels][hi, lo]
    [lane = 4 g + t][4 words], where word j of lane (g, t) is the weight of
    output channel ``8 ntile + g`` and input channel ``16 kchunk + 4 t + j``
    (k-step 0 of the k-chunk reads words 0 and 1, k-step 1 words 2 and 3).
    Input channels are zero-padded to whole k-chunks and output channels to
    whole n-tiles. ``bq`` (f32, flat) holds, per stage, the bias padded to
    whole n-tiles with zeros.
    """
    wq, bq = [], []
    for w, b in zip(weights, biases):
        cout, cin = int(w.shape[0]), int(w.shape[1])
        kc, nt = -(-cin // 16), -(-cout // 8)
        hl = torch.stack(split_tf32(w)).permute(0, 1, 3, 4, 2)  # [s, cout, ky, kx, cin]
        hl = F.pad(hl, (0, kc * 16 - cin, 0, 0, 0, 0, 0, nt * 8 - cout))
        # [s, ntile, g, tap, k-chunk, t, j]
        v = hl.reshape(2, nt, 8, 9, kc, 4, 4)
        for n0 in range(0, nt, _NT_CHUNK):
            wq.append(v[:, n0:n0 + _NT_CHUNK].permute(3, 4, 1, 0, 2, 5, 6).reshape(-1))
        bias = torch.zeros(nt * 8, dtype=torch.float32, device=w.device)
        if b is not None:
            bias[:cout] = b
        bq.append(bias)
    return torch.cat(wq).contiguous(), torch.cat(bq).contiguous()


_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


def packed_weights(layout: str, weights: Sequence[torch.Tensor],
                   biases: Sequence[Optional[torch.Tensor]], pack: Callable):
    """``pack(weights, biases)``, computed once per weight set.

    The key is the layout's name and each tensor's ``data_ptr()``,
    ``_version`` and device, so an in-place update or a copy on another
    device packs anew. An entry keeps its tensors alive, so no later
    tensor can take a cached one's address. Inference tensors carry no
    version, so an in-place update could not be seen: they raise.
    """
    global packs
    tensors = [t for t in list(weights) + list(biases) if t is not None]
    if any(t.is_inference() for t in tensors):
        raise RuntimeError(
            "the kernel's weights are inference tensors, made under torch.inference_mode(), "
            "which carry no version for the packed-weight cache; make them outside "
            "inference mode (registry.build_model does)")
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


def path(nm: config.Numerics) -> str:
    """The kernels' path (key of ``launches_by_path``) under tier ``nm``."""
    return (FAST_PATHS if nm.two_byte_compute else PATHS)[nm.activation_dtype]


def rounded(weights: Sequence[torch.Tensor], biases: Sequence[Optional[torch.Tensor]],
            dtype: torch.dtype) -> Tuple[list, list]:
    """Weights and biases rounded to ``dtype`` as the 2-byte tiers use them,
    held in f32: the weights as ``nn.cast_compute`` casts them (saturating
    into f16), the biases as ``b.to(dtype)``."""
    return ([nn.cast_compute(w, dtype).float() for w in weights],
            [None if b is None else b.to(dtype).float() for b in biases])


def layout(dtype: torch.dtype, compute: torch.dtype = torch.float32) -> Tuple[str, Callable]:
    """The packed-weight cache key and packing of the kernel that takes
    activations of ``dtype`` under a tier that contracts in ``compute``:
    split f16 for float16, split TF32 for float32 and bfloat16 (the same
    terms; the kernel runs 3 or 2 products). Under a 2-byte ``compute``
    (``fast``, ``fast16``, whose activations are of that dtype) one term
    rounded to it (:func:`pack_chain_2byte`), under a key of its own, so
    that a pack of the same tensors for another tier is never served."""
    if compute != torch.float32:
        if dtype != compute:
            raise TypeError(f"a {compute} tier stores {compute} activations, not {dtype}")
        return f"mma_{FAST_PATHS[compute]}", lambda ws, bs: pack_chain_2byte(ws, bs, compute)
    if dtype == torch.float16:
        return "mma_f16", pack_chain_f16
    return "mma_tf32", pack_chain_tf32


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
    nm = config.numerics()
    with torch.cuda.device(x.device):
        lib = _lib()
        code = build.dtype_code(x.dtype)
        key, pack = layout(x.dtype, nm.compute_dtype)
        wp, bp = packed_weights(key, weights, biases, pack)
        n, c0, h, w = x.shape
        widths = [c0] + [int(wk.shape[0]) for wk in weights]
        widths += [0] * (_MAX_DEPTH + 1 - len(widths))
        depth = len(weights)
        fast = int(nm.two_byte_compute)
        if lib.conv3x3_chain_smem_bytes(code, fast, depth, *widths) > build.MAX_SMEM:
            raise ValueError(f"widths {widths[:depth + 1]} need more shared memory than a block has")
        out = torch.empty((n, widths[depth], h, w), dtype=x.dtype, device=x.device,
                          memory_format=nn.CL)
        rc = lib.conv3x3_chain(
            code, fast, x.data_ptr(), out.data_ptr(), wp.data_ptr(),
            bp.data_ptr(),
            n, h, w, depth, *widths, slope, int(residual),
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, rc, "conv3x3_chain")
    launches_by_path[path(nm)] += 1
    return out
