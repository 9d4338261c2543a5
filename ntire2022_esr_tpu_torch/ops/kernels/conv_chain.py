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
batch 128 x 256 x 256, 2.05 ms with the two products of f32-grade work on
f16 activations; with f32-grade work on split TF32 (495 TFLOP/s over 3
products) 6.1 ms under f32 activations. What keeps the 2-byte kernel from
its bound (a warpgroup's chain of MMAs at small N, epilogues that overlap
the MMAs only in part) is in ``csrc/conv_chain.cu`` and ``PERF.md``.

Design. A block takes one output tile at a time; the tile and its halo
are loaded once into shared memory, all stages run there, and only the
last stage's tile is written back. Every tier runs on the tensor cores.
Under the 2-byte storage tiers the kernel is built on Hopper's warpgroup
MMA (``wgmma.mma_async.m64nNk16``, f32 accumulation, both operands read
from shared memory through descriptors): activations as planes of 8
channels, so that an m-block of 64 output indices at any tap offset is an
operand; a whole step's weights (9 taps of one stage, or of one chunk of
n-tiles of a wider one) fetched by bulk asynchronous copies that report to
mbarriers; three warpgroups a block, each waiting for its own m-block's
MMAs before its epilogue, so that one's epilogue runs under the others'
MMAs; a persistent grid of one block an SM of the current device, the next
tile's window copied while this one is written out by bulk stores. Under
``fasthi16`` the activations are exact f16 values and each f32 weight is
split on the host into two f16 terms under a power-of-two scale per output
channel (:func:`split_f16`), side by side in the MMAs' N: two products,
f32-grade (:func:`pack_chain_f16`). Under ``fast16`` and ``fast`` the
weights themselves are 2-byte, each packed once rounded to the tier's
dtype (:func:`pack_chain_2byte`); one exact product, and the kernel rounds
each sum to the dtype before it adds the bias, as the unfused graph does
(two roundings). Both packs lay the weights out as the MMAs' B operands
(:func:`_wgmma_operands`), in chunks of ``_NT_CHUNK`` n-tiles. Under
f32 storage (``parity``, ``high``, ``mixed``) and bf16 storage with f32
weights (``fasthi``) the same plan runs on TF32 warpgroup MMA
(``wgmma.m64n48k8``, the activations as A in registers, the weights as B
in shared memory): each weight split on the host into two TF32 terms
(:func:`split_tf32`) and each activation in registers, three products
(two for bf16 activations, which are exact TF32 values), each tap's
products summed from zero and added in f32 (:func:`pack_chain_wgmma_tf32`);
f32 windows of a 16x16 tile at RLFN's widths, and the weights a tap at a
time through a ring of bulk copies (:func:`wgmma_tf32_plan` reckons its
shared memory). Weights are packed into the kernels' layouts once per
weight set and cached (:func:`packed_weights`), each layout under a key of
its own (:func:`layout`). See ``PERF.md`` for the times on the card.

Under the w8 tier the weights are int8 with one f32 scale per (cout, cin)
pair (``porter/quant.py``), passed as ``scales``. The pack dequantizes them
in the compute dtype of its layout, as the plain version does at every
call (``ops.nn.dequant``), and then packs those values as it packs f32
weights: the kernels see the weights the plain version sees, and their
contract (f32-grade packs) is the same. The cache keys on the int8 and
scale tensors, so a w8 model packs once.
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
# wgmma product: fast16 and fast), "tf32x3" (f32 activations: parity,
# high, mixed) and "tf32x2" (bf16 activations and f32 weights: fasthi). All
# of them: the sum of the values. PATHS maps the activation dtype of a tier
# with f32 weights to its path, FAST_PATHS that of a 2-byte tier.
PATHS = {torch.float16: "f16", torch.float32: "tf32x3", torch.bfloat16: "tf32x2"}
FAST_PATHS = {torch.float16: "f16x1", torch.bfloat16: "bf16x1"}
launches_by_path = dict.fromkeys(["f16", "f16x1", "bf16x1", "tf32x3", "tf32x2"], 0)
# The same by kernel: "wgmma" (the 2-byte paths, csrc/conv_chain.cu
# conv3x3_chain_wgmma_kernel) and "wgmma_tf32" (the split-TF32 paths,
# conv3x3_chain_wgmma_tf32_kernel): every width that fits a block takes the
# kernel of its path (:func:`kernel_of`).
launches_by_kernel = dict.fromkeys(["wgmma", "wgmma_tf32"], 0)

# Times a chain's weights were packed (cache misses) in this process.
packs = 0

_MAX_DEPTH = 4  # csrc/conv_chain.cu kMaxDepth
_NT_CHUNK = 6  # csrc/common.cuh kNtChunk: n-tiles of 8 channels a packed chunk holds, at most
_CACHE_SIZE = 64  # weight sets kept packed
_V = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_chain")
    lib.conv3x3_chain.argtypes = ([_I, _I, _V, _V, _V, _V] + [_I] * 9
                                  + [ctypes.c_float, _I, _V])
    lib.conv3x3_chain.restype = _I
    lib.conv3x3_chain_smem_bytes.argtypes = [_I] * 8
    lib.conv3x3_chain_smem_bytes.restype = ctypes.c_longlong
    if lib.conv3x3_chain_ntile_chunk() != _NT_CHUNK:
        raise RuntimeError("csrc/common.cuh kNtChunk and _NT_CHUNK differ")
    return lib


def conv3x3_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[Optional[torch.Tensor]], *, slope: float = 0.05,
                        residual: bool = True,
                        scales: Optional[Sequence[Optional[torch.Tensor]]] = None) -> torch.Tensor:
    """The chain as the unfused graph computes it (``F.conv2d`` per stage),
    w8 weights dequantized in the tier's compute dtype."""
    h = x
    for w, b, s in zip(weights, biases, scales or [None] * len(weights)):
        h = nn.leaky_relu(nn.conv2d(h, nn.dequant(w, s), b, padding=1), slope)
    return h + x if residual else h


def dequantized(weights: Sequence[torch.Tensor], scales: Optional[Sequence[Optional[torch.Tensor]]],
                compute: torch.dtype) -> list:
    """The weights as a tier that contracts in ``compute`` uses them, held
    in f32: each int8 (w8) weight times its scale in ``compute``
    (``ops.nn.dequant``), a float weight as it is."""
    if scales is None:
        return list(weights)
    return [nn.dequant(w, s, compute).float() for w, s in zip(weights, scales)]


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


def _wgmma_operands(terms: torch.Tensor) -> torch.Tensor:
    """One stage's weight terms ``[s, cout, cin, 3, 3]`` (s = 1 or 2 terms,
    2-byte values) as the wgmma kernel's B operands, flat: [chunk of
    ``_NT_CHUNK`` n-tiles (``csrc/conv_chain.cu`` kStepNt), one step of the
    kernel][tap = 3 ky + kx][k-chunk of 16 input channels] and per k-step
    [group of 8 columns][k-half][8 columns][8 k], the columns the chunk's
    output channels, term by term (all the hi terms' n-tiles, then the lo
    terms'). Input channels are zero-padded to whole k-chunks and output
    channels to whole chunks."""
    s, cout, cin = (int(d) for d in terms.shape[:3])
    ntl = _NT_CHUNK
    kc, nch = -(-cin // 16), -(-cout // (8 * ntl))
    v = F.pad(terms, (0, 0, 0, 0, 0, kc * 16 - cin, 0, nch * ntl * 8 - cout))
    # [s, chunk, ntile, n8, k-chunk, k-half, k8, ky, kx]
    v = v.reshape(s, nch, ntl, 8, kc, 2, 8, 3, 3)
    return v.permute(1, 7, 8, 4, 0, 2, 5, 3, 6).reshape(-1)


def _scales_biases(inv: torch.Tensor, b: Optional[torch.Tensor], cout: int,
                   device) -> list:
    """One stage's ``1 / S`` per output channel (1 in the pad) and bias (0 in
    the pad and where it is missing), padded to whole n-tiles."""
    nt8 = -(-cout // 8) * 8
    bias = torch.zeros(nt8, dtype=torch.float32, device=device)
    if b is not None:
        bias[:cout] = b
    return [F.pad(inv, (0, nt8 - cout), value=1.0), bias]


def pack_chain_f16(weights: Sequence[torch.Tensor],
                   biases: Sequence[Optional[torch.Tensor]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's weights as the wgmma kernel reads them under two products.

    Returns ``(wq, sb)``. ``wq`` (f16, flat) holds, per stage, the split
    weights of :func:`split_f16` as wgmma B operands (:func:`_wgmma_operands`):
    [chunk of 6 n-tiles][ky][kx][k-chunk][group of 8 columns][k-half]
    [8 columns][8 k], the columns of a chunk the hi terms of its 48 output
    channels and then their lo terms (N = 96); zero past the stage's
    channels.
    ``sb`` (f32, flat) holds, per stage, ``1 / S`` per output channel (1 in
    the pad) and then the bias (0 in the pad).
    """
    wq, sb = [], []
    for w, b in zip(weights, biases):
        w_hi, w_lo, inv = split_f16(w)
        wq.append(_wgmma_operands(torch.stack([w_hi, w_lo])))
        sb += _scales_biases(inv, b, int(w.shape[0]), w.device)
    return torch.cat(wq).contiguous(), torch.cat(sb).contiguous()


def pack_chain_2byte(weights: Sequence[torch.Tensor], biases: Sequence[Optional[torch.Tensor]],
                     dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's weights as the wgmma kernel of a 2-byte tier
    (``fast16``: float16, ``fast``: bfloat16) reads them under one product:
    each weight once, rounded to ``dtype`` as :func:`rounded` rounds it.

    Returns ``(wq, sb)``. ``wq`` (``dtype``, flat) holds, per stage, the
    weights as wgmma B operands in :func:`pack_chain_f16`'s order with one
    term (N = 48): [chunk of 6 n-tiles][ky][kx][k-chunk][group of
    8 output channels][k-half][8 channels][8 k]. Pads are zero.
    ``sb`` (f32, flat) holds, per stage, the layout of
    :func:`pack_chain_f16`: a scale of 1 per output channel (the kernel
    does not read it under one product) and then the bias rounded to
    ``dtype`` (0 in the pad).
    """
    wr, br = rounded(weights, biases, dtype)
    wq, sb = [], []
    for w, b in zip(wr, br):
        wq.append(_wgmma_operands(w.to(dtype)[None]))
        sb += _scales_biases(torch.ones(int(w.shape[0]), dtype=torch.float32, device=w.device),
                             b, int(w.shape[0]), w.device)
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


def wgmma_tf32_operands(terms: torch.Tensor, ks: int) -> torch.Tensor:
    """The split-TF32 wgmma kernels' B operands (the chain's and the
    tail's) from the TF32 terms ``terms`` (2, nch, K) of one conv: output
    channels padded to whole steps of ``_NT_CHUNK`` n-tiles, K already
    ordered as the kernel's units of ``ks`` k-steps, each k-step's 8 values
    as [k-half][k], which it takes at k = 4 k-half + k. Returns [step][unit]
    [k-step][hi, lo][group of 8 columns][k-half][8 columns][4 k], flat."""
    nch, klen = int(terms.shape[1]), int(terms.shape[2])
    steps = -(-nch // (8 * _NT_CHUNK))
    v = F.pad(terms, (0, 0, 0, steps * 8 * _NT_CHUNK - nch))
    # [term, step, column group, column, unit, k-step, k-half, k]
    v = v.reshape(2, steps, _NT_CHUNK, 8, klen // (8 * ks), ks, 2, 4)
    return v.permute(1, 4, 5, 0, 2, 6, 3, 7).reshape(-1)


def tap_operands(w: torch.Tensor) -> torch.Tensor:
    """One conv's OIHW f32 weights as the split-TF32 wgmma kernels' B
    operands in their per-tap form: the TF32 hi and lo terms
    (:func:`split_tf32`), [step of 6 n-tiles][tap = 3 ky + kx][k-step of 8
    input channels][hi, lo][group of 8 columns][k-half][8 columns][4 k],
    where k-step ``2 c + s`` of k-chunk ``c`` takes input channel
    ``16 c + 4 k + 2 s + k-half`` at position ``k`` of its k-half (the
    order in which a lane's 16-byte load of the f32 window gives its A
    registers); zero past the output channels and past cin."""
    nch, cin = int(w.shape[0]), int(w.shape[1])
    kc = -(-cin // 16)
    hl = torch.stack(split_tf32(w)).permute(0, 1, 3, 4, 2)  # [term, nch, ky, kx, cin]
    hl = F.pad(hl, (0, kc * 16 - cin))
    # [term, nch, tap, c, k, s, k-half] -> [term, nch, tap, c, s, k-half, k]
    hl = hl.reshape(2, nch, 9, kc, 4, 2, 2).permute(0, 1, 2, 3, 5, 6, 4)
    return wgmma_tf32_operands(hl.reshape(2, nch, 9 * kc * 16), 2 * kc)


def pack_chain_wgmma_tf32(weights: Sequence[torch.Tensor], biases: Sequence[Optional[torch.Tensor]]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's weights as the split-TF32 wgmma kernel reads them
    (``csrc/conv_chain.cu`` ``conv3x3_chain_wgmma_tf32_kernel``).

    Returns ``(wq, bq)``. ``wq`` (f32, flat) holds, per stage, the TF32
    terms as B operands in :func:`tap_operands`' order: [step of 6 n-tiles]
    [tap][k-step][hi, lo][group of 8 columns][k-half][8 columns][4 k]; a
    unit of the kernel's ring is one (step, tap): ``2 kchunks(cin)``
    k-steps of two 1536-byte operands. ``bq`` (f32, flat) holds, per stage,
    the bias padded to whole n-tiles with zeros."""
    wq, bq = [], []
    for w, b in zip(weights, biases):
        cout = int(w.shape[0])
        wq.append(tap_operands(w))
        bias = torch.zeros(-(-cout // 8) * 8, dtype=torch.float32, device=w.device)
        if b is not None:
            bias[:cout] = b
        bq.append(bias)
    return torch.cat(wq).contiguous(), torch.cat(bq).contiguous()


# csrc/conv_chain.cu pick_tile32 and layout32, which plan the split-TF32
# kernel's shared memory: its tiles in order of preference, the most ring
# buffers and the bytes before them, and one k-step's B operand of one term
_TILES32 = ((16, 16), (8, 16), (8, 8), (4, 4))
_RING32, _RING32_HEAD, _STEP_B32 = 4, 128, 8 * _NT_CHUNK * 8 * 4


def _pixel_words_f32(c: int) -> int:
    w = -(-c // 16) * 16
    return w if w & 16 else w + 16


def wgmma_tf32_plan(widths: Sequence[int], vbytes: int) -> Optional[dict]:
    """The split-TF32 chain kernel's plan for ``widths`` (c0, ..., c_depth)
    on activations of ``vbytes`` bytes, as ``csrc/conv_chain.cu``
    ``pick_tile32`` and ``layout32`` make it: the first tile whose buffers
    fit a block beside at least two ring buffers, as a dict of ``tile``
    (rows, columns), ``nbuf`` (ring buffers), ``unit`` (bytes of a buffer:
    the largest unit of weights, one tap of one step), ``blocks``
    (m-blocks of 64 output indices of each stage) and ``bytes`` (of shared
    memory); None if no tile fits. Stage k reads (th + 2 (depth - k)) x
    (tw + 2 (depth - k)) pixels at ``sw`` words a pixel (16 mod 32), and its
    last m-block up to 64 blocks + 2 wi + 2 pixels from the buffer's start;
    the last stage writes th x tw x c_depth values of ``vbytes``; a table
    of the units a tile reads (8 bytes each) follows the biases."""
    depth = len(widths) - 1
    sw = _pixel_words_f32(max(widths[:depth]))
    for th, tw in _TILES32:
        cap, reach, unit, nbias, blocks, per_tile = [0, 0], [0, 0], 0, 0, [], 0
        for k in range(depth):
            wi, ho = tw + 2 * (depth - k), th + 2 * (depth - k) - 2
            nb = -(-(ho * wi - 2) // 64)
            blocks.append(nb)
            cap[k & 1] = max(cap[k & 1], (ho + 2) * wi * sw * 4)
            reach[k & 1] = max(reach[k & 1], (64 * nb + 2 * wi + 2) * sw * 4)
            unit = max(unit, 2 * -(-widths[k] // 16) * 2 * _STEP_B32)
            nbias += 8 * -(-widths[k + 1] // 8)
            # units a tile reads: 9 taps of each pass of 6 m-blocks of each step
            per_tile += 9 * -(-nb // 6) * -(-widths[k + 1] // (8 * _NT_CHUNK))
        cap[depth & 1] = max(cap[depth & 1], th * tw * widths[depth] * vbytes)
        for nbuf in range(_RING32, 1, -1):
            buf0 = _RING32_HEAD + nbuf * unit
            buf1 = buf0 + -(-cap[0] // 16) * 16
            end = buf1 + -(-cap[1] // 16) * 16 + 4 * nbias + 8 * per_tile
            total = max(end, buf0 + reach[0], buf1 + reach[1])
            if total <= build.MAX_SMEM:
                return {"tile": (th, tw), "nbuf": nbuf, "unit": unit, "blocks": blocks,
                        "bytes": total}
    return None


def kernel_of(p: str) -> str:
    """The kernel (key of ``launches_by_kernel``) that serves a launch on
    path ``p`` (key of ``launches_by_path``)."""
    return "wgmma_tf32" if p.startswith("tf32") else "wgmma"


_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


def packed_weights(layout: str, weights: Sequence[torch.Tensor],
                   biases: Sequence[Optional[torch.Tensor]], pack: Callable,
                   scales: Optional[Sequence[Optional[torch.Tensor]]] = None):
    """``pack(weights, biases)``, or ``pack(weights, biases, scales)`` for
    w8 weights, computed once per weight set.

    The key is the layout's name and each tensor's ``data_ptr()``,
    ``_version`` and device (the scales' too), so an in-place update or a
    copy on another device packs anew. An entry keeps its tensors alive, so
    no later tensor can take a cached one's address. Inference tensors
    carry no version, so an in-place update could not be seen: they raise.
    """
    global packs
    scales = None if scales is None else list(scales)
    tensors = [t for t in list(weights) + list(biases) + (scales or []) if t is not None]
    if any(t.is_inference() for t in tensors):
        raise RuntimeError(
            "the kernel's weights are inference tensors, made under torch.inference_mode(), "
            "which carry no version for the packed-weight cache; make them outside "
            "inference mode (registry.build_model does)")
    key = (layout, tuple(None if b is None else i for i, b in enumerate(biases)),
           None if scales is None else tuple(s is not None for s in scales),
           tuple((t.data_ptr(), t._version, str(t.device)) for t in tensors))
    hit = _cache.get(key)
    if hit is not None:
        _cache.move_to_end(key)
        return hit[0]
    packs += 1
    out = pack(weights, biases) if scales is None else pack(weights, biases, scales)
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
    split f16 as wgmma operands for float16, split TF32 as TF32 wgmma
    operands for float32 and bfloat16 (the same terms; the kernel runs 3 or
    2 products) under ``wgmma_chain_tf32``, which no tail layout shares.
    The wgmma layouts' keys start with ``wgmma_``, so that no pack of
    another layout is ever served to those kernels. Under a 2-byte
    ``compute``
    (``fast``, ``fast16``, whose activations are of that dtype) one term
    rounded to it (:func:`pack_chain_2byte`), under a key of its own, so
    that a pack of the same tensors for another tier is never served. The
    packing takes ``(weights, biases)``, or ``(weights, biases, scales)``
    for w8 weights, which it dequantizes in ``compute`` first
    (:func:`dequantized`)."""
    if compute != torch.float32:
        if dtype != compute:
            raise TypeError(f"a {compute} tier stores {compute} activations, not {dtype}")
        return (f"wgmma_{FAST_PATHS[compute]}",
                lambda ws, bs, ss=None: pack_chain_2byte(dequantized(ws, ss, compute), bs, compute))
    if dtype == torch.float16:
        return "wgmma_f16", lambda ws, bs, ss=None: pack_chain_f16(dequantized(ws, ss, compute), bs)
    return "wgmma_chain_tf32", lambda ws, bs, ss=None: pack_chain_wgmma_tf32(
        dequantized(ws, ss, compute), bs)


def check_scales(weights, scales) -> Optional[list]:
    """The w8 scales of ``weights`` (None where no weight is int8): an int8
    weight must come with its scale, of shape (cout, cin, 1, 1); a float
    weight with none. Raises otherwise: no w8 weight reaches a kernel, or
    its plain version, without its scale."""
    scales = [None] * len(weights) if scales is None else list(scales)
    if len(scales) != len(weights):
        raise ValueError(f"{len(weights)} weights but {len(scales)} scales")
    for w, s in zip(weights, scales):
        if (w.dtype == torch.int8) != (s is not None):
            raise TypeError("an int8 (w8) weight needs its scale and a float weight takes none; "
                            f"got a {w.dtype} weight with scale {None if s is None else 'given'}")
        if s is not None and tuple(s.shape) != (w.shape[0], w.shape[1], 1, 1):
            raise ValueError(f"scale {tuple(s.shape)} does not fit weight {tuple(w.shape)}")
    return None if all(s is None for s in scales) else scales


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


def check_device(x: torch.Tensor, weights, extras) -> None:
    """The kernels take float32 weights (or int8 ones with their scales),
    and float32 biases and scales (``extras``), all on ``x``'s device."""
    if any(t.device != x.device for t in list(weights) + list(extras)):
        raise TypeError("weights, biases and scales must be on x's device")
    if (any(w.dtype not in (torch.float32, torch.int8) for w in weights)
            or any(t.dtype != torch.float32 for t in extras)):
        raise TypeError("weights must be float32 (or int8 with scales), biases and scales float32")


def fused_conv3x3_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[Optional[torch.Tensor]], *, slope: float = 0.05,
                        residual: bool = True,
                        scales: Optional[Sequence[Optional[torch.Tensor]]] = None) -> torch.Tensor:
    """``depth`` same-padded 3x3 convs, each + bias, stored in the tier's
    dtype, then LeakyReLU(``slope``); then + ``x`` if ``residual``.

    ``x``: (N, C, H, W) channels_last in the tier's activation dtype;
    ``weights``: OIHW float32, or int8 (w8) with their f32 ``scales``
    (cout, cin, 1, 1). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises.
    """
    _check(x, weights, biases, residual)
    scales = check_scales(weights, scales)
    if x.device.type == "cpu":
        return conv3x3_chain_plain(x, weights, biases, slope=slope, residual=residual,
                                   scales=scales)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if not x.is_contiguous(memory_format=nn.CL):
        raise ValueError("x must be channels_last contiguous")
    check_device(x, weights, [t for t in list(biases) + (scales or []) if t is not None])
    # the packing, the shared-memory opt-in and the launch act on the
    # current device: make it x's
    nm = config.numerics()
    with torch.cuda.device(x.device):
        lib = _lib()
        code = build.dtype_code(x.dtype)
        key, pack = layout(x.dtype, nm.compute_dtype)
        wp, bp = packed_weights(key, weights, biases, pack, scales)
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
    launches_by_kernel[kernel_of(path(nm))] += 1
    return out
