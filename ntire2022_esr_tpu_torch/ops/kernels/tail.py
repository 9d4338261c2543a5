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
2-byte storage in one channel group (every x4 upsampler, the library's,
and the x2 upsamplers 24 -> 96 and 32 -> 128) the conv is one stage of
the chain's warpgroup-MMA design (``csrc/wgmma_chain.cuh``:
``wgmma.mma_async.m64nNk16``, f32 accumulation, both operands read from
shared memory through descriptors; the window as planes of 8 channels, the
hi and lo terms side by side in N, three warpgroups): under ``fasthi16``
on f16 activations and f32 weights split into two f16 terms (f32-grade,
see ``conv_chain.split_f16``; :func:`pack_tail_wgmma_f16`), under
``fast16`` and ``fast`` on f16 or bf16 activations and weights packed
once rounded to the dtype, one exact product, with the two-rounding
epilogue (:func:`pack_tail_wgmma_2byte`). One persistent block per SM
keeps the conv's whole packed weights in shared memory and walks over
tiles (16x22 at RLFN's widths); tensor copies (TMA) bring the next tile's window under this
tile's MMAs, the block re-lays it as planes, and a tensor copy takes the
finished tile away. Under f32 and bf16 storage with f32 weights
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

Channel groups. Where a block cannot hold the whole conv's packed weights
and result (52 -> 208 and 64 -> 256 at r = 2 under the 2-byte tiers and
under f32 activations; under ``fasthi16`` SCET's 64 -> 64), the kernel
splits the output channels, in
their shuffled order, into groups of equal width: one a shuffle position
(i, j), or a part of one. Each block computes one group of each tile it
takes and writes the group's run of each pixel with plain stores; the
window of a tile is read by the blocks of all its groups at about the same
time. Under 2-byte storage a grouped plan runs ``mma.sync.m16n8k16``
(``csrc/mma_stage.cuh``) on fragment-order packs (:func:`pack_tail_f16`,
:func:`pack_tail_2byte`); under split TF32 (inputs over 64 channels, and
52 -> 208 and 64 -> 256 at r = 2 under f32 activations)
``mma.sync.m16n8k8`` on :func:`pack_tail_tf32`. The packs then hold the groups one after the
other, each as a stage of its own (``groups`` of the packing functions),
and the C entry point ``conv3x3_pixelshuffle_groups`` says how many a
launch takes: which kernel serves a plan follows from its shapes alone.

w8 weights (int8 with an f32 ``scale``, ``porter/quant.py``) are
dequantized by the pack in its layout's compute dtype and packed as f32
weights are, as in ``conv_chain``; the cache keys on the int8 and scale
tensors.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.ops import nn
from ntire2022_esr_tpu_torch.ops.kernels import build
from ntire2022_esr_tpu_torch.ops.kernels import conv_chain
from ntire2022_esr_tpu_torch.ops.kernels.conv_chain import (_NT_CHUNK, FAST_PATHS, PATHS,
                                                            check_scales, dequantized,
                                                            pack_chain_tf32, packed_weights,
                                                            path, rounded, split_tf32,
                                                            tap_operands, wgmma_tf32_operands)

# Launches of the CUDA kernels (not of the plain version) in this process,
# by path, as in conv_chain; by (path, cin, r * r * cout, r); and by kernel:
# "wgmma" (a 2-byte path in one channel group), "mma_groups" (a 2-byte path
# in more), "wgmma_tf32" (a split-TF32 path in one group) and
# "tf32_groups" (a split-TF32 path in more).
launches_by_path = dict.fromkeys(conv_chain.launches_by_path, 0)
launches_by_shape: Dict[Tuple[str, int, int, int], int] = {}
launches_by_kernel = dict.fromkeys(["wgmma", "mma_groups", "wgmma_tf32", "tf32_groups"], 0)
FOLD_MAX_CIN = 16  # csrc/tail.cu kFoldMaxCin

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


def pack_stages_f16(weights: Sequence[torch.Tensor], biases: Sequence[Optional[torch.Tensor]]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages of split f16 weights (``conv_chain.split_f16``) as the grouped
    m16n8k16 kernel reads its B fragments, one stage a channel group.

    Returns ``(wq, sb)``. ``wq`` (f16, flat) holds, per stage, [chunk of
    ``_NT_CHUNK`` n-tiles][ky][kx][k-chunk of 16 input channels][n-tile of
    8 output channels][lane = 4 g + t][hi b0, hi b1, lo b0, lo b1], where
    lane (g, t) holds output channel ``8 ntile + g`` and b0, b1 are the
    input-channel pairs ``2t, 2t+1`` and ``2t+8, 2t+9`` of the k-chunk.
    Input channels are zero-padded to whole k-chunks and output channels to
    whole n-tiles. ``sb`` (f32, flat) holds, per stage, ``1 / S`` per
    output channel (1 in the pad) and then the bias (0 in the pad).
    """
    wq, sb = [], []
    for w, b in zip(weights, biases):
        cout, cin = int(w.shape[0]), int(w.shape[1])
        kc, nt = -(-cin // 16), -(-cout // 8)
        w_hi, w_lo, inv = conv_chain.split_f16(w)
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


def pack_stages_2byte(weights: Sequence[torch.Tensor], biases: Sequence[Optional[torch.Tensor]],
                      dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages as the one-product m16n8k16 kernel of a 2-byte tier
    (``fast16``: float16, ``fast``: bfloat16) reads them: each weight once,
    rounded to ``dtype`` as ``conv_chain.rounded`` rounds it.

    Returns ``(wq, sb)``. ``wq`` (``dtype``, flat) holds, per stage, the
    weights in :func:`pack_stages_f16`'s order with one term: [chunk of
    ``_NT_CHUNK`` n-tiles][ky][kx][k-chunk][n-tile][lane = 4 g + t][b0, b1].
    Pads are zero. ``sb`` (f32, flat) holds, per stage, a scale of 1 per
    output channel (not read under one product) and then the bias rounded
    to ``dtype`` (0 in the pad).
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


def pack_tail_f16(w: torch.Tensor, b: Optional[torch.Tensor], r: int,
                  groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the grouped m16n8k16 kernel reads them under
    fasthi16: the channel groups of :func:`channel_groups`, each packed as
    one stage (:func:`pack_stages_f16`): split f16 weights in fragment
    order, then ``1 / S`` and the bias per channel."""
    return pack_stages_f16(*channel_groups(w, b, r, groups))


def pack_tail_2byte(w: torch.Tensor, b: Optional[torch.Tensor], r: int,
                    dtype: torch.dtype, groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the grouped one-product m16n8k16 kernel of a
    2-byte tier (``fast16``, ``fast``) reads them: the channel groups of
    :func:`channel_groups`, each packed as one stage by
    :func:`pack_stages_2byte`: each weight once, rounded to ``dtype``, in
    fragment order, then a scale of 1 and the rounded bias per channel."""
    return pack_stages_2byte(*channel_groups(w, b, r, groups), dtype)


def pack_tail_wgmma_f16(w: torch.Tensor, b: Optional[torch.Tensor],
                        r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the wgmma kernel reads them under fasthi16
    (``csrc/tail.cu`` ``conv3x3_pixelshuffle_wgmma_kernel<half, 2, false>``):
    the conv with its channels in shuffled order (:func:`channel_groups`,
    one group) packed as one stage of the chain's wgmma pack
    (``conv_chain.pack_chain_f16``): the split f16 terms as B operands,
    [step of 6 n-tiles][ky][kx][k-chunk][column group][k-half][8 columns]
    [8 k], the hi terms' 48 columns of a step and then the lo terms'
    (N = 96), zero past the conv's channels; then ``1 / S`` and the bias
    per channel, padded to whole n-tiles."""
    return conv_chain.pack_chain_f16(*channel_groups(w, b, r))


def pack_tail_wgmma_2byte(w: torch.Tensor, b: Optional[torch.Tensor], r: int,
                          dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the one-product wgmma kernel of a 2-byte tier
    (``fast16``: float16, ``fast``: bfloat16) reads them: the conv with its
    channels in shuffled order packed as one stage of
    ``conv_chain.pack_chain_2byte``: each weight once, rounded to
    ``dtype``, as B operands (N = 48 a step), then a scale of 1 and the
    rounded bias per channel."""
    return conv_chain.pack_chain_2byte(*channel_groups(w, b, r), dtype)


def pack_tail_tf32(w: torch.Tensor, b: Optional[torch.Tensor], r: int,
                   groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail's weights as the split-TF32 kernel reads them: the channel
    groups of :func:`channel_groups`, each packed as one stage of the chain
    (``conv_chain.pack_chain_tf32``): TF32 hi and lo terms in fragment
    order, then the bias per channel."""
    return pack_chain_tf32(*channel_groups(w, b, r, groups))


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
    shuffled order (:func:`channel_groups`, one group), its TF32 hi and lo
    terms as the MMAs' B operands in the per-tap order of the chain's
    split-TF32 kernel (``conv_chain.tap_operands``): [step of 6 n-tiles]
    [tap = 3 ky + kx][k-step of 8 channels][hi, lo][group of 8 columns]
    [k-half][8 columns][4 k], where k-step ``2 c + s`` of k-chunk ``c``
    takes input channel ``16 c + 4 k + 2 s + k-half`` at position ``k`` of
    its k-half; zero past the conv's channels and past cin. Then the bias
    in that order, padded to whole n-tiles."""
    (ws,), (bs,) = channel_groups(w, b, r)
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
    (ws,), (bs,) = channel_groups(w, b, r)
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
           groups: int = 1, cin: Optional[int] = None) -> Tuple[str, Callable]:
    """The packed-weight cache key and packing (of ``[w], [b]``) of the
    kernel that takes activations of ``dtype`` under a tier that contracts
    in ``compute``, as ``conv_chain.layout``, in ``groups`` channel
    groups; a w8 weight (``[w], [b], [scale]``) is dequantized in
    ``compute`` first. A 2-byte path in one group is the wgmma kernel's
    (``csrc/tail.cu`` plan_of), whose keys start with ``wgmma_tail_``: no
    grouped m16n8k16 or split-TF32 pack of the same tensors, and no chain
    pack, is ever served to it, nor one of its packs to them. The same holds
    for the split-TF32 wgmma kernel (f32 and bf16 activations in one group),
    ``wgmma_tail_tf32_r<r>`` for its per-tap form and
    ``wgmma_tail_tf32_fold_r<r>`` for the folded form, which ``cin``
    chooses (:func:`folded`; None: per tap)."""
    g = f"_r{r}_g{groups}"
    if compute != torch.float32:
        if dtype != compute:
            raise TypeError(f"a {compute} tier stores {compute} activations, not {dtype}")
        if groups == 1:
            return (f"wgmma_tail_{FAST_PATHS[compute]}_r{r}",
                    lambda ws, bs, ss=None: pack_tail_wgmma_2byte(
                        dequantized(ws, ss, compute)[0], bs[0], r, compute))
        return (f"tail_mma_{FAST_PATHS[compute]}{g}", lambda ws, bs, ss=None: pack_tail_2byte(
            dequantized(ws, ss, compute)[0], bs[0], r, compute, groups))
    if dtype == torch.float16:
        if groups == 1:
            return f"wgmma_tail_f16_r{r}", lambda ws, bs, ss=None: pack_tail_wgmma_f16(
                dequantized(ws, ss, compute)[0], bs[0], r)
        return f"tail_mma_f16{g}", lambda ws, bs, ss=None: pack_tail_f16(
            dequantized(ws, ss, compute)[0], bs[0], r, groups)
    if groups == 1:
        if cin is not None and folded(cin):
            return f"wgmma_tail_tf32_fold_r{r}", lambda ws, bs, ss=None: pack_tail_wgmma_tf32_fold(
                dequantized(ws, ss, compute)[0], bs[0], r)
        return f"wgmma_tail_tf32_r{r}", lambda ws, bs, ss=None: pack_tail_wgmma_tf32(
            dequantized(ws, ss, compute)[0], bs[0], r)
    return f"tail_mma_tf32{g}", lambda ws, bs, ss=None: pack_tail_tf32(
        dequantized(ws, ss, compute)[0], bs[0], r, groups)


def kernel_of(p: str, groups: int) -> str:
    """The kernel (key of ``launches_by_kernel``) that serves a launch on
    path ``p`` (key of ``launches_by_path``) in ``groups`` channel groups."""
    if p.startswith("tf32"):
        return "wgmma_tf32" if groups == 1 else "tf32_groups"
    return "wgmma" if groups == 1 else "mma_groups"


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
        groups = lib.conv3x3_pixelshuffle_groups(code, fast, cin, cout, r)
        key, pack = layout(x.dtype, r, nm.compute_dtype, groups, cin)
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
    launches_by_kernel[kernel_of(p, groups)] += 1
    shape = (p, cin, nch, r)
    launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    return out if x.dtype == act else nn.store_out(out, nm)
