"""Fused conv3x3 + PixelShuffle(r): the zoo's x4 upsamplers and its x2 ones.

Replaces the TPU kernel ``ntire2022_esr_tpu/ops/pallas/tail.py``
``fused_conv3x3_pixelshuffle`` (``pallas_call`` at :112) with the
hand-written CUDA kernel ``csrc/tail.cu`` for Hopper (sm_90a). No JAX
model calls the Pallas kernel; the port's RLFN calls this one for its
upsampler (46 -> 48 channels, r = 4), once per forward; 34 other zoo
models for their x4 upsamplers (3 to 64 -> 48, and SCET's 64 -> 64 and
3 -> 64 to 4 channels; ``models.blocks.conv_shuffle``); and the HR tails
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
intermediate never reaches device memory. The shuffle costs the kernels
nothing: the packs put the output channels in the order ``(i, j, c)``
(:func:`shuffled_order`), so the ``r * cout`` channels of a pixel that
belong to output row ``r*y + i`` are one contiguous run there. Under
2-byte storage the conv is one stage of
the chain's warpgroup-MMA design (``csrc/wgmma_chain.cuh``:
``wgmma.mma_async.m64nNk16``, f32 accumulation, both operands read from
shared memory through descriptors; the window as planes of 8 channels, the
hi and lo terms side by side in N, three warpgroups): under ``fasthi16``
on f16 activations and f32 weights split into two f16 terms (f32-grade,
see ``conv_chain.split_f16``; :func:`pack_tail_wgmma_f16`), under
``fast16`` and ``fast`` on f16 or bf16 activations and weights packed
once rounded to the dtype, one exact product, with the two-rounding
epilogue (:func:`pack_tail_wgmma_2byte`). One persistent block per SM
walks over tiles (16x22 at RLFN's widths) with the conv's whole packed
weights in shared memory where they fit; tensor copies (TMA) bring the
next tile's window under this tile's MMAs, the block re-lays it as planes,
and tensor copies take the result away. Under f32 and bf16 storage with f32 weights
(``parity``, ``high``, ``mixed``, ``fasthi``) the same plan runs on split
TF32 (three products under f32 activations, two under bf16;
``conv_chain.split_tf32``) on TF32 warpgroup MMA
(``wgmma.m64n48k8`` with the split activations as A in registers, the
weights' TF32 terms as B in shared memory): each tap's products summed
from zero and added in f32 (:func:`pack_tail_wgmma_tf32`), or, up to
``FOLD_MAX_CIN`` input channels, the taps folded into K and each k-step of
8 (tap, channel) pairs summed from zero (:func:`pack_tail_wgmma_tf32_fold`:
the zoo's cin = 3 runs 4 k-steps a step instead of 18); the weights come a
tap (or k-step) at a time through a ring of bulk copies, the window by
plain loads, the tile out by a tensor store. Weights are packed once per
weight set (``conv_chain.packed_weights``), each kernel's layout under a
key of its own (:func:`layout`). See ``PERF.md`` for the times on the
card.

One channel group. Every shape runs one block a tile: the conv's
channels go in steps of 48 (one N of the MMAs); a conv of one step, or a
plan with room for it, keeps the whole tile's result and writes it out
by one tensor store after the last step, and otherwise each step's
result leaves the block as soon as its epilogue ends, a chunk of every
pixel's run a tensor store (or by plain stores; ``csrc/tail.cu``
StepOut), so no block needs room for a whole tile's result. Where a
conv's 2-byte weights fit beside the rest at no tile (52 -> 208 and
64 -> 256 at r = 2, and SCET's 64 -> 64 under ``fasthi16``), they stream
a tap of a step at a time through a ring of bulk copies, as the
split-TF32 weights always do; the split-TF32 per-tap form takes any
number of k-chunks (inputs over 64 channels too). :func:`wgmma_plan`
reckons the plan a launch takes (tile, ring, result buffers, shared
memory) as ``csrc/tail.cu`` does; it follows from the shapes alone.

w8 weights (int8 with an f32 ``scale``, ``porter/quant.py``) are
dequantized by the pack in its layout's compute dtype and packed as f32
weights are, as in ``conv_chain``; the cache keys on the int8 and scale
tensors.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.ops import nn
from ntire2022_esr_tpu_torch.ops.kernels import build
from ntire2022_esr_tpu_torch.ops.kernels import conv_chain
from ntire2022_esr_tpu_torch.ops.kernels.conv_chain import (_NT_CHUNK, FAST_PATHS, PATHS,
                                                            check_scales, dequantized,
                                                            packed_weights, path, split_tf32,
                                                            tap_operands, wgmma_tf32_operands)

# Launches of the CUDA kernels (not of the plain version) in this process,
# by path, as in conv_chain; by (path, cin, r * r * cout, r); and by kernel:
# "wgmma" (a 2-byte path) and "wgmma_tf32" (a split-TF32 path).
launches_by_path = dict.fromkeys(conv_chain.launches_by_path, 0)
launches_by_shape: Dict[Tuple[str, int, int, int], int] = {}
launches_by_kernel = dict.fromkeys(["wgmma", "wgmma_tf32"], 0)
FOLD_MAX_CIN = 16  # csrc/tail.cu kFoldMaxCin

_V = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("tail")
    lib.conv3x3_pixelshuffle.argtypes = [_I, _I, _V, _V, _V, _V] + [_I] * 6 + [_V]
    lib.conv3x3_pixelshuffle.restype = _I
    lib.conv3x3_pixelshuffle_smem_bytes.argtypes = [_I] * 5
    lib.conv3x3_pixelshuffle_smem_bytes.restype = ctypes.c_longlong
    lib.conv3x3_pixelshuffle_plan.argtypes = [_I] * 5 + [ctypes.POINTER(_I)]
    lib.conv3x3_pixelshuffle_plan.restype = None
    return lib


def conv3x3_pixelshuffle_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                               *, r: int = 4, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tail as the unfused graph computes it, a w8 weight dequantized
    in the tier's compute dtype."""
    return nn.pixel_shuffle(nn.conv2d(x, nn.dequant(w, scale), b, padding=1), r)


def shuffled_order(cout: int, r: int) -> torch.Tensor:
    """The conv's output channels in the order the tensor-core kernel
    computes them: position ``(i*r + j)*cout + c`` holds channel
    ``c*r*r + i*r + j``, so that what PixelShuffle puts side by side in an
    output row (``j`` and ``c`` for one ``i``) is contiguous."""
    return torch.arange(cout * r * r).reshape(cout, r * r).t().reshape(-1)


def shuffled_channels(w: torch.Tensor, b: Optional[torch.Tensor],
                      r: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The conv's weights and bias with the output channels permuted by
    :func:`shuffled_order` (each channel's sum is independent, so no value
    changes): the one stage that the packings take."""
    order = shuffled_order(int(w.shape[0]) // (r * r), r).to(w.device)
    return w[order], None if b is None else b[order]


def pack_tail_wgmma_f16(w: torch.Tensor, b: Optional[torch.Tensor],
                        r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the wgmma kernel reads them under fasthi16
    (``csrc/tail.cu`` ``conv3x3_pixelshuffle_wgmma_kernel<half, 2, false>``):
    the conv with its channels in shuffled order (:func:`shuffled_channels`)
    packed as one stage of the chain's wgmma pack
    (``conv_chain.pack_chain_f16``): the split f16 terms as B operands,
    [step of 6 n-tiles][ky][kx][k-chunk][column group][k-half][8 columns]
    [8 k], the hi terms' 48 columns of a step and then the lo terms'
    (N = 96), zero past the conv's channels; then ``1 / S`` and the bias
    per channel, padded to whole n-tiles. A unit of the kernel's weights
    (one tap of one step, which stays in shared memory or streams through
    its ring) is ``kchunks(cin)`` k-steps of 96 x 16 values at
    ``(step * 9 + tap)`` units from the start."""
    ws, bs = shuffled_channels(w, b, r)
    return conv_chain.pack_chain_f16([ws], [bs])


def pack_tail_wgmma_2byte(w: torch.Tensor, b: Optional[torch.Tensor], r: int,
                          dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the one-product wgmma kernel of a 2-byte tier
    (``fast16``: float16, ``fast``: bfloat16) reads them: the conv with its
    channels in shuffled order packed as one stage of
    ``conv_chain.pack_chain_2byte``: each weight once, rounded to
    ``dtype``, as B operands (N = 48 a step), then a scale of 1 and the
    rounded bias per channel. Its units are :func:`pack_tail_wgmma_f16`'s
    with one term."""
    ws, bs = shuffled_channels(w, b, r)
    return conv_chain.pack_chain_2byte([ws], [bs], dtype)


def _bias_nt(b: Optional[torch.Tensor], nch: int, device) -> torch.Tensor:
    bias = torch.zeros(-(-nch // 8) * 8, dtype=torch.float32, device=device)
    if b is not None:
        bias[:nch] = b
    return bias


def pack_tail_wgmma_tf32(w: torch.Tensor, b: Optional[torch.Tensor],
                         r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the split-TF32 wgmma kernel reads them in its
    per-tap form (``csrc/tail.cu`` ``conv3x3_pixelshuffle_wgmma_tf32_kernel``
    with KC = the input's k-chunks of 16): the conv with its channels in
    shuffled order (:func:`shuffled_channels`), its TF32 hi and lo
    terms as the MMAs' B operands in the per-tap order of the chain's
    split-TF32 kernel (``conv_chain.tap_operands``): [step of 6 n-tiles]
    [tap = 3 ky + kx][k-step of 8 channels][hi, lo][group of 8 columns]
    [k-half][8 columns][4 k], where k-step ``2 c + s`` of k-chunk ``c``
    takes input channel ``16 c + 4 k + 2 s + k-half`` at position ``k`` of
    its k-half; zero past the conv's channels and past cin. Then the bias
    in that order, padded to whole n-tiles."""
    ws, bs = shuffled_channels(w, b, r)
    return tap_operands(ws).contiguous(), _bias_nt(bs, int(ws.shape[0]), w.device)


def pack_tail_wgmma_tf32_fold(w: torch.Tensor, b: Optional[torch.Tensor],
                              r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the split-TF32 wgmma kernel reads them in its
    folded form (KC = 0, up to ``FOLD_MAX_CIN`` input channels): the taps
    folded into K, ``k = (3 ky + kx) * cin + c``, zero-padded to whole
    k-steps of 8, a unit each (whose products the kernel sums from zero);
    the conv's channels in shuffled order and its TF32 hi and lo terms as B
    operands, [step of 6 n-tiles][k-step][hi, lo][group of 8 columns]
    [k-half][8 columns][4 k], k-step ``s`` taking ``k = 8 s + 4 k-half +
    k``; zero past the conv's channels. Then the bias in that order, padded
    to whole n-tiles."""
    ws, bs = shuffled_channels(w, b, r)
    nch, cin = int(ws.shape[0]), int(ws.shape[1])
    klen = -(-9 * cin // 8) * 8
    hl = torch.stack(split_tf32(ws)).permute(0, 1, 3, 4, 2).reshape(2, nch, 9 * cin)
    hl = F.pad(hl, (0, klen - 9 * cin))
    return wgmma_tf32_operands(hl, 1).contiguous(), _bias_nt(bs, nch, w.device)


def folded(cin: int) -> bool:
    """Whether the split-TF32 wgmma kernel takes ``cin`` input channels in
    its folded form (``csrc/tail.cu`` ``tail_tf32_folded``)."""
    return cin <= FOLD_MAX_CIN


def layout(dtype: torch.dtype, r: int, compute: torch.dtype = torch.float32,
           cin: Optional[int] = None) -> Tuple[str, Callable]:
    """The packed-weight cache key and packing (of ``[w], [b]``) of the
    kernel that takes activations of ``dtype`` under a tier that contracts
    in ``compute``, as ``conv_chain.layout``; a w8 weight (``[w], [b],
    [scale]``) is dequantized in ``compute`` first. A 2-byte path is the
    wgmma kernel's (``csrc/tail.cu`` plan_of), the split-TF32 paths (f32
    and bf16 activations) the split-TF32 wgmma kernel's,
    ``wgmma_tail_tf32_r<r>`` for its per-tap form and
    ``wgmma_tail_tf32_fold_r<r>`` for the folded form, which ``cin``
    chooses (:func:`folded`; None: per tap). Every key starts with
    ``wgmma_tail_``: no chain pack is ever served to a tail kernel, nor one
    of the tail's packs to the chain."""
    if compute != torch.float32:
        if dtype != compute:
            raise TypeError(f"a {compute} tier stores {compute} activations, not {dtype}")
        return (f"wgmma_tail_{FAST_PATHS[compute]}_r{r}",
                lambda ws, bs, ss=None: pack_tail_wgmma_2byte(
                    dequantized(ws, ss, compute)[0], bs[0], r, compute))
    if dtype == torch.float16:
        return f"wgmma_tail_f16_r{r}", lambda ws, bs, ss=None: pack_tail_wgmma_f16(
            dequantized(ws, ss, compute)[0], bs[0], r)
    if cin is not None and folded(cin):
        return f"wgmma_tail_tf32_fold_r{r}", lambda ws, bs, ss=None: pack_tail_wgmma_tf32_fold(
            dequantized(ws, ss, compute)[0], bs[0], r)
    return f"wgmma_tail_tf32_r{r}", lambda ws, bs, ss=None: pack_tail_wgmma_tf32(
        dequantized(ws, ss, compute)[0], bs[0], r)


def kernel_of(p: str) -> str:
    """The kernel (key of ``launches_by_kernel``) that serves a launch on
    path ``p`` (key of ``launches_by_path``)."""
    return "wgmma_tf32" if p.startswith("tf32") else "wgmma"


# csrc/tail.cu pick_tail_plan and pick_tail_plan32, which plan the two
# kernels' shared memory: their tiles in order of preference, the ring
# depths tried (the 2-byte paths first try every unit resident), m-blocks
# of a tile at most (two for each of three warpgroups), the bytes before the
# weights (the ring's mbarriers and counters) and one k-step's TF32 B
# operand of one term
_TILES = ((16, 22), (8, 22), (16, 14), (8, 14), (8, 8))
_TILES32 = ((16, 22), (8, 22), (8, 8), (4, 4))
_RINGS = (4, 3, 2)
_MAX_BLOCKS, _HEAD, _STEP_CH = 6, 128, 8 * _NT_CHUNK
_STEP_B32 = _STEP_CH * 8 * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _res_bytes(nch: int, th: int, tw: int, vb: int, nres: int) -> int:
    """A result buffer: one step's 48 values of each tile pixel, or (nres =
    0) the whole tile's channels."""
    return _cdiv(th * tw * (_STEP_CH if nres else nch) * vb, 128) * 128


def _res_choices(cout: int, r: int) -> Tuple[int, ...]:
    """The result buffers tried, in order: the whole tile (0) where the conv
    has more than one step, two step results, one."""
    return (0, 2, 1) if _cdiv(_cdiv(cout * r * r, 8), _NT_CHUNK) > 1 else (2, 1)


def _layout_2byte(cin: int, cout: int, r: int, th: int, tw: int, p: int, nbuf: int,
                  nres: int) -> Tuple[int, int, int]:
    """(bytes, m-blocks, unit bytes) of ``csrc/tail.cu`` wg_tail."""
    kc, nt = _cdiv(cin, 16), _cdiv(cout * r * r, 8)
    steps, hi, wi = _cdiv(nt, _NT_CHUNK), th + 2, tw + 2
    ps, blocks = (hi * wi) | 1, _cdiv(th * wi - 2, 64)
    ppb = 3 if cin <= 62 else 2  # boxes_of: pixels a box (log 2)
    box_w = ((cin // 2) << ppb) + 4
    raw_b = _cdiv(wi, 1 << ppb) * _cdiv(hi * box_w * 4, 128) * 128
    unit = kc * _STEP_CH * p * 32
    res = _HEAD + (nbuf or steps * 9) * unit + raw_b
    win = res + max(nres, 1) * _res_bytes(cout * r * r, th, tw, 2, nres)
    sb = win + ((2 * kc - 1) * ps + 64 * blocks + 2 * wi + 2) * 16
    return sb + 64 * nt + 32 * nt, blocks, unit


def _layout_tf32(cin: int, cout: int, r: int, th: int, tw: int, vb: int, nbuf: int,
                 nres: int) -> Tuple[int, int, int]:
    """(bytes, m-blocks, unit bytes) of ``csrc/tail.cu`` wg_tail32."""
    fold, kc, nt = folded(cin), _cdiv(cin, 16), _cdiv(cout * r * r, 8)
    wi = tw + 2
    units = _cdiv(9 * cin, 8) if fold else 9
    sw = (cin | 1) if fold else conv_chain._pixel_words_f32(cin)
    blocks = _cdiv(th * wi - 2, 64)
    unit = (1 if fold else 2 * kc) * 2 * _STEP_B32
    win = _HEAD + nbuf * unit + max(nres, 1) * _res_bytes(cout * r * r, th, tw, vb, nres)
    tab = win + _cdiv((64 * blocks + 2 * wi + 2) * sw * 4, 16) * 16 + 32 * nt
    return tab + 32 * nt + (32 * units if fold else 0), blocks, unit


def wgmma_plan(cin: int, cout: int, r: int, dtype: torch.dtype,
               compute: torch.dtype = torch.float32) -> dict:
    """The tail kernels' plan for ``cin -> r * r * cout`` channels on
    activations of ``dtype`` under a tier that contracts in ``compute``, as
    ``csrc/tail.cu`` ``plan_of`` makes it: the first tile (in order of
    preference) whose layout fits a block with the deepest ring, the whole
    tile's result (a conv of more than one step), else two step results
    where they fit, else one. A dict of ``kernel`` (key of ``launches_by_kernel``),
    ``tile`` (rows, columns), ``nbuf`` (ring buffers; 0: the weights stay
    in shared memory), ``nres`` (step result buffers; 0: one of the whole
    tile, written out after its last step), ``unit`` (bytes of
    one unit of weights: a tap of a step, or a folded k-step), ``blocks``
    (m-blocks of 64 output indices) and ``bytes`` (of shared memory; over
    ``build.MAX_SMEM`` where no plan fits, and the launch raises).
    The 2-byte paths keep their weights resident, with the whole tile's
    result, at the first tile where both fit (the resident kernel), and
    stream them only where they fit at none (the ring kernel)."""
    choices = _res_choices(cout, r)
    if compute != torch.float32 or dtype == torch.float16:
        kernel, tiles = "wgmma", _TILES
        p = 1 if compute != torch.float32 else 2
        reckon = lambda th, tw, nbuf, nres: _layout_2byte(  # noqa: E731
            cin, cout, r, th, tw, p, nbuf, nres)
        # the weights resident with the whole tile's result at any tile,
        # else streamed
        order = ([(t, 0, 0) for t in tiles]
                 + [(t, nbuf, nres) for t in tiles for nbuf in _RINGS for nres in choices])
    else:
        kernel, tiles = "wgmma_tf32", _TILES32
        vb = 4 if dtype == torch.float32 else 2
        reckon = lambda th, tw, nbuf, nres: _layout_tf32(  # noqa: E731
            cin, cout, r, th, tw, vb, nbuf, nres)
        order = [(t, nbuf, nres) for t in tiles for nbuf in _RINGS for nres in choices]
    for (th, tw), nbuf, nres in order:
        nbytes, blocks, unit = reckon(th, tw, nbuf, nres)
        if nbytes <= build.MAX_SMEM and blocks <= _MAX_BLOCKS:
            return {"kernel": kernel, "tile": (th, tw), "nbuf": nbuf, "nres": nres,
                    "unit": unit, "blocks": blocks, "bytes": nbytes}
    th, tw = tiles[-1]
    nbytes, blocks, unit = reckon(th, tw, 2, 1)
    return {"kernel": kernel, "tile": (th, tw), "nbuf": 2, "nres": 1, "unit": unit,
            "blocks": blocks, "bytes": nbytes}


def fused_conv3x3_pixelshuffle(x: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor] = None, *, r: int = 4,
                               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv2d(x, w, b, padding=1) then pixel_shuffle(r).

    ``x``: (N, C, H, W) channels_last in the tier's activation dtype, or
    in f32 under a tier that contracts in f32 (the kernel's f32 path, its
    output then rounded into the tier's storage dtype); ``w``: OIHW
    float32 with ``cout * r * r`` output channels, or int8 (w8) with its
    f32 ``scale`` (cout * r * r, cin, 1, 1). Returns (N, cout,
    r*H, r*W) channels_last in the tier's activation dtype. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    """
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"weight {tuple(w.shape)} does not fit x {tuple(x.shape)} as a 3x3 conv")
    nch = int(w.shape[0])
    if nch % (r * r):
        raise ValueError(f"{nch} output channels do not shuffle by r={r}")
    nm = config.numerics()
    act = nm.activation_dtype
    if x.dtype != act and (x.dtype != torch.float32 or nm.two_byte_compute):
        raise TypeError(f"x is {x.dtype} but the {config.mode()} tier stores {act}")
    scales = check_scales([w], [scale])
    if x.device.type == "cpu":
        return conv3x3_pixelshuffle_plain(x, w, b, r=r, scale=scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if not x.is_contiguous(memory_format=nn.CL):
        raise ValueError("x must be channels_last contiguous")
    conv_chain.check_device(x, [w], [t for t in (b, scale) if t is not None])
    # the packing, the shared-memory opt-in, the SM count and the launch
    # act on the current device: make it x's
    with torch.cuda.device(x.device):
        lib = _lib()
        n, cin, h, wd = x.shape
        cout = nch // (r * r)
        code = build.dtype_code(x.dtype)
        fast = int(nm.two_byte_compute)
        if lib.conv3x3_pixelshuffle_smem_bytes(code, fast, cin, cout, r) > build.MAX_SMEM:
            raise ValueError(f"{cin} -> {nch} channels need more shared memory than a block has")
        key, pack = layout(x.dtype, r, nm.compute_dtype, cin)
        wp, bp = packed_weights(key, [w], [b], pack, scales)
        out = torch.empty((n, cout, h * r, wd * r), dtype=x.dtype, device=x.device,
                          memory_format=nn.CL)
        rc = lib.conv3x3_pixelshuffle(
            code, fast, x.data_ptr(), out.data_ptr(), wp.data_ptr(),
            bp.data_ptr(), n, h, wd, cin, cout, r,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, rc, "conv3x3_pixelshuffle")
    p = path(nm) if x.dtype == act else PATHS[x.dtype]
    launches_by_path[p] += 1
    launches_by_kernel[kernel_of(p)] += 1
    shape = (p, cin, nch, r)
    launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    return out if x.dtype == act else nn.store_out(out, nm)
