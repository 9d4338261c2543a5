"""The port's kernel modules on the CPU: each kernel's plain PyTorch
version against the JAX Pallas kernel (interpret mode) and the unfused JAX
graph, the host-side weight packing the CUDA kernels read, the wrappers'
dispatch and checks, and the port's independence from JAX.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each against its plain version there.
"""

import ast
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu_torch import config, ops, porter
from ntire2022_esr_tpu_torch.ops.kernels import build, conv_chain, tail

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    yield


def _t(a):
    return ops.from_nhwc(torch.from_numpy(np.ascontiguousarray(a)))


def _n(t):
    return ops.to_nhwc(t).float().numpy()


def _oihw(w_hwio):
    return porter.to_torch({"c": {"weight": w_hwio}})["c.weight"]


def _chain_case(rng, shape, chans):
    x = rng.randn(*shape).astype(np.float32) * 0.5
    ws = [rng.randn(3, 3, ci, co).astype(np.float32) * 0.05 for ci, co in chans]
    bs = [rng.randn(co).astype(np.float32) * 0.1 for _, co in chans]
    return x, ws, bs


# the shapes of tests/test_pallas_kernels.py (chains, then the mixed-width RLFB chain)
CHAIN_CASES = [
    ((1, 40, 52, 16), [(16, 16)] * 3, True),
    ((2, 33, 47, 8), [(8, 8)], False),
    ((1, 64, 64, 24), [(24, 24)] * 2, True),
    ((1, 40, 40, 20), [(20, 24), (24, 24), (24, 20)], True),
]


@pytest.mark.parametrize("shape,chans,residual", CHAIN_CASES)
def test_chain_plain_matches_pallas(rng, interpret_pallas, shape, chans, residual):
    from ntire2022_esr_tpu.ops.pallas import fused_conv3x3_chain as pallas_chain

    x, ws, bs = _chain_case(rng, shape, chans)
    ref = np.asarray(pallas_chain(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                  [jnp.asarray(b) for b in bs], slope=0.05, residual=residual))
    out = conv_chain.fused_conv3x3_chain(_t(x), [_oihw(w) for w in ws],
                                         [torch.from_numpy(b) for b in bs],
                                         slope=0.05, residual=residual)
    # f32 both; the bar of tests/test_pallas_kernels.py
    np.testing.assert_allclose(_n(out), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tier", ["fasthi16", "fasthi"])
def test_chain_plain_matches_unfused_jax_storage_tiers(rng, tier):
    """Under a storage tier the chain rounds every stage to the storage
    dtype (f16 / bf16), as the unfused JAX graph does (the Pallas kernel
    does not)."""
    x, ws, bs = _chain_case(rng, (2, 24, 20, 46), [(46, 48), (48, 48), (48, 46)])
    act, tdt, ulp = {"fasthi16": (np.float16, torch.float16, 2.0 ** -10),
                     "fasthi": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}[tier]
    x = np.asarray(jnp.asarray(x * 8).astype(act))
    with jconfig.numerics_mode(tier):
        h = jnp.asarray(x)
        for w, b in zip(ws, bs):
            h = jops.leaky_relu(jops.conv2d(h, jnp.asarray(w), jnp.asarray(b)), 0.05)
        ref = np.asarray(h + jnp.asarray(x)).astype(np.float32)
    xt = ops.from_nhwc(torch.from_numpy(x.astype(np.float32)).to(tdt))
    with config.numerics_mode(tier):
        out = conv_chain.fused_conv3x3_chain(xt, [_oihw(w) for w in ws],
                                             [torch.from_numpy(b) for b in bs])
    assert out.dtype == tdt
    d = np.abs(_n(out) - ref)
    # each stage's store may round the other way where the two frameworks'
    # f32 sums differ in the last bits; such a one-ulp flip feeds the next
    # stage, so allow 4 ulps and an eighth of one on average
    assert (d <= 4 * ulp * np.maximum(np.abs(ref), 1.0)).all(), d.max()
    assert d.mean() < ulp / 8 * np.abs(ref).mean() + 1e-4, d.mean()


@pytest.mark.parametrize("shape,cin,cout", [((1, 40, 52, 16), 16, 3), ((2, 33, 47, 12), 12, 3)])
def test_tail_plain_matches_pallas(rng, interpret_pallas, shape, cin, cout):
    from ntire2022_esr_tpu.ops.pallas import fused_conv3x3_pixelshuffle as pallas_tail

    r = 4
    x = rng.randn(*shape).astype(np.float32) * 0.5
    w = rng.randn(3, 3, cin, cout * r * r).astype(np.float32) * 0.05
    b = rng.randn(cout * r * r).astype(np.float32) * 0.1
    ref = np.asarray(pallas_tail(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), r=r))
    out = tail.fused_conv3x3_pixelshuffle(_t(x), _oihw(w), torch.from_numpy(b), r=r)
    assert out.shape == (shape[0], cout, shape[1] * r, shape[2] * r)
    np.testing.assert_allclose(_n(out), ref, rtol=1e-4, atol=1e-5)


def test_tail_plain_matches_unfused_jax_fasthi16(rng):
    x = (rng.randn(1, 9, 7, 46) * 4).astype(np.float16)
    w = rng.randn(3, 3, 46, 48).astype(np.float32) * 0.05
    b = rng.randn(48).astype(np.float32)
    with jconfig.numerics_mode("fasthi16"):
        ref = np.asarray(jops.pixel_shuffle(jops.conv2d(jnp.asarray(x), jnp.asarray(w),
                                                        jnp.asarray(b)), 4))
    with config.numerics_mode("fasthi16"):
        out = tail.fused_conv3x3_pixelshuffle(_t(x), _oihw(w), torch.from_numpy(b))
    assert out.dtype == torch.float16
    # one f16 store: one ulp at most
    np.testing.assert_allclose(_n(out), ref.astype(np.float32), rtol=2.0 ** -9, atol=1e-6)


# (cin, cout, r): RLFN's upsampler, a wider input (4 k-chunks), and widths whose
# conv channels (27, 12) and runs (18, 12 bytes) are no multiples of 8
TAIL_CASES = [(46, 3, 4), (50, 3, 4), (24, 3, 3), (5, 3, 2)]


def _tail_case(rng, cin, cout, r, hw=(9, 7), n=2):
    x = torch.from_numpy((rng.randn(n, cin, *hw) * 4).astype(np.float16))
    w = torch.from_numpy(rng.randn(cout * r * r, cin, 3, 3).astype(np.float32) * 0.05)
    b = torch.from_numpy(rng.randn(cout * r * r).astype(np.float32))
    return x.contiguous(memory_format=torch.channels_last), w, b


def _copy_runs(conv, cout, r):
    """What the tensor-core kernel's copy-out does with a conv result whose
    channels are in shuffled order: the r*cout channels [i*r*cout,
    (i+1)*r*cout) of pixel (y, x) are the run (j, c) of output row r*y + i
    at column r*x."""
    n, _, h, w = conv.shape
    runs = conv.reshape(n, r, r, cout, h, w)  # [n, i, j, c, y, x]
    return runs.permute(0, 3, 4, 1, 5, 2).reshape(n, cout, h * r, w * r)


@pytest.mark.parametrize("cin,cout,r", TAIL_CASES)
def test_tail_shuffled_order_is_pixel_shuffle(rng, cin, cout, r):
    """A conv with the output channels permuted to (i, j, c), copied out run
    by run, is the conv followed by PixelShuffle, bit for bit in f32."""
    x, w, b = _tail_case(rng, cin, cout, r)
    order = tail.shuffled_order(cout, r)
    assert sorted(order.tolist()) == list(range(cout * r * r))
    for kp, k in enumerate(order.tolist()):
        ij, c = divmod(kp, cout)
        assert k == c * r * r + ij
    conv = torch.nn.functional.conv2d(x.float(), w[order], b[order], padding=1)
    ref = tail.conv3x3_pixelshuffle_plain(x.float(), w, b, r=r)
    assert torch.equal(_copy_runs(conv, cout, r), ref)


@pytest.mark.parametrize("cin,cout,r", TAIL_CASES)
def test_pack_tail_f16_layout(rng, cin, cout, r):
    """pack_tail_f16 is the chain's one-stage packing of the permuted
    weights: B fragments [chunk of 6 n-tiles][ky][kx][k-chunk][n-tile][lane]
    [hi b0, hi b1, lo b0, lo b1], 9 * kc * nt * 32 units of 16 bytes, zeros
    in the pads of cin (to 16s) and of cout*r*r (to 8s); then 1/S (1 in the
    pad) and the bias (0 in the pad) in the permuted order."""
    _, w, b = _tail_case(rng, cin, cout, r)
    nch = cout * r * r
    kc, nt = -(-cin // 16), -(-nch // 8)
    wq, sb = tail.pack_tail_f16(w, b, r)
    assert wq.dtype == torch.float16 and wq.numel() == 9 * kc * nt * 32 * 8
    assert sb.dtype == torch.float32 and sb.numel() == 2 * 8 * nt
    order = tail.shuffled_order(cout, r)
    hi, lo, inv = (a.numpy() for a in conv_chain.split_f16(w[order]))
    full = np.zeros((2, nt * 8, kc * 16, 3, 3), np.float16)
    full[0, :nch, :cin], full[1, :nch, :cin] = hi, lo
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    wq, woff = wq.numpy(), 0
    for n0 in range(0, nt, 6):
        ntl = min(6, nt - n0)
        blk = wq[woff:woff + 9 * kc * ntl * 32 * 8].reshape(3, 3, kc, ntl, 32, 4, 2)
        woff += blk.size
        for n in range(ntl):
            co = (n0 + n) * 8 + g
            for word, (s, k0) in enumerate([(0, 0), (0, 8), (1, 0), (1, 8)]):
                for e in range(2):
                    for k in range(kc):
                        want = full[s, co, k * 16 + k0 + 2 * t + e]  # [lane, ky, kx]
                        np.testing.assert_array_equal(
                            blk[:, :, k, n, :, word, e], want.transpose(1, 2, 0))
    assert woff == wq.size
    sb = sb.numpy()
    np.testing.assert_array_equal(sb[:nch], inv)
    assert (sb[nch:nt * 8] == 1).all()
    np.testing.assert_array_equal(sb[nt * 8:nt * 8 + nch], b[order].numpy())
    assert (sb[nt * 8 + nch:] == 0).all()
    _, sb0 = tail.pack_tail_f16(w, None, r)
    assert (sb0[nt * 8:] == 0).all()


@pytest.mark.parametrize("cin,cout,r", TAIL_CASES)
def test_tail_kernel_arithmetic_matches_plain_fasthi16(rng, cin, cout, r):
    """The tensor-core kernel's arithmetic in plain PyTorch, from the packed
    scales and biases: on f16 inputs, f32 convs with w_hi and w_lo in the
    shuffled order, acc_hi + acc_lo * 2^-11, unscale, bias, the saturating
    round to f16 and the run-wise copy; against the plain version under
    fasthi16. Both round the same f32-grade sums once, so values differ
    only where the two sums straddle a rounding boundary: by one f16 ulp at
    most (or by the sums' own f32 noise, where it is larger), in under 1% of
    the values."""
    x, w, b = _tail_case(rng, cin, cout, r, hw=(24, 20))
    x[0, 0, 0, 0], w[0, 0, 1, 1] = 60000.0, 2.0  # one sum past f16's range: the store saturates
    nch = cout * r * r
    order = tail.shuffled_order(cout, r)
    hi, lo, _ = conv_chain.split_f16(w[order])
    _, sb = tail.pack_tail_f16(w, b, r)
    nt8 = sb.numel() // 2
    inv, bias = sb[:nch], sb[nt8:nt8 + nch]
    F = torch.nn.functional
    acc = F.conv2d(x.float(), hi.float(), padding=1) + \
        F.conv2d(x.float(), lo.float(), padding=1) * 2.0 ** -11
    val = acc * inv[None, :, None, None] + bias[None, :, None, None]
    out = _copy_runs(val.clamp(-65504.0, 65504.0).half(), cout, r)
    with config.numerics_mode("fasthi16"):
        ref = tail.fused_conv3x3_pixelshuffle(x, w, b, r=r)
    assert ref.dtype == torch.float16 and out.shape == ref.shape
    assert bool(torch.isfinite(out.float()).all()) and float(out.float().abs().max()) == 65504.0
    # neighbouring f16 values: their bit patterns (sign folded in) are 1 apart
    def ordinal(h):
        i = h.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    steps = (ordinal(out) - ordinal(ref)).abs()
    # where a sum's terms cancel, its f32 rounding noise (8 f32 ulps of the
    # sum of the terms' magnitudes) is more than one f16 ulp of the small result
    noise = 8 * 2.0 ** -24 * tail.conv3x3_pixelshuffle_plain(x.float().abs(), w.abs(), b.abs(),
                                                             r=r)
    assert bool(((steps <= 1) | ((out.float() - ref.float()).abs() <= noise)).all())
    share = float((steps > 0).float().mean())
    print(f"tail {cin}->{nch} r={r}: {share:.2e} of f16 values differ, "
          f"{int(steps.max())} steps at most")
    assert share < 1e-2


def test_tail_weights_are_packed_once(rng, monkeypatch):
    """The wrapper's packing goes through the chain's cache and counter:
    a second call with the same weights packs nothing, an in-place update
    packs anew, and another r is another layout."""
    _, w, b = _tail_case(rng, 5, 3, 2)
    pack = lambda ws, bs: tail.pack_tail_f16(ws[0], bs[0], 2)  # noqa: E731
    assert tail.packed_weights is conv_chain.packed_weights
    before = conv_chain.packs
    first = tail.packed_weights("tail_mma_f16_r2", [w], [b], pack)
    again = tail.packed_weights("tail_mma_f16_r2", [w], [b], pack)
    assert conv_chain.packs == before + 1 and again[0] is first[0]
    w.mul_(2.0)
    fresh = tail.packed_weights("tail_mma_f16_r2", [w], [b], pack)
    assert conv_chain.packs == before + 2
    # doubling a weight doubles S's inverse and leaves the split terms alone
    assert torch.equal(fresh[0], first[0]) and torch.equal(fresh[1][:12], first[1][:12] * 2)
    tail.packed_weights("tail_mma_f16_r2", [w], [None], pack)
    assert conv_chain.packs == before + 3


def test_cpu_wrappers_count_no_launch(rng):
    x, ws, bs = _chain_case(rng, (1, 8, 8, 4), [(4, 4)] * 3)
    before = (conv_chain.launches, tail.launches)
    args = (_t(x), [_oihw(w) for w in ws], [torch.from_numpy(b) for b in bs])
    assert torch.equal(conv_chain.fused_conv3x3_chain(*args), conv_chain.conv3x3_chain_plain(*args))
    w = _oihw(rng.randn(3, 3, 4, 16).astype(np.float32))
    assert torch.equal(tail.fused_conv3x3_pixelshuffle(_t(x), w, None),
                       tail.conv3x3_pixelshuffle_plain(_t(x), w, None))
    assert (conv_chain.launches, tail.launches) == before


def test_wrappers_reject_bad_inputs(rng):
    x, ws, bs = _chain_case(rng, (1, 8, 8, 4), [(4, 6), (6, 5)])
    args = ([_oihw(w) for w in ws], [torch.from_numpy(b) for b in bs])
    with pytest.raises(ValueError, match="residual"):
        conv_chain.fused_conv3x3_chain(_t(x), *args, residual=True)
    with config.numerics_mode("fasthi16"), pytest.raises(TypeError, match="fasthi16"):
        conv_chain.fused_conv3x3_chain(_t(x), *args, residual=False)  # f32 x, f16 tier
    with pytest.raises(ValueError, match="3x3"):
        tail.fused_conv3x3_pixelshuffle(_t(x), torch.zeros(16, 5, 3, 3))
    with pytest.raises(RuntimeError, match="no kernel"):
        tail.fused_conv3x3_pixelshuffle(_t(x).to("meta"), torch.zeros(16, 4, 3, 3, device="meta"))


def test_pack_conv3x3_layout(rng):
    """The CUDA kernels read weights as [ky][kx][cin][cout padded to the
    channel group], zeros in the pad, and the bias padded likewise."""
    w_hwio = rng.randn(3, 3, 5, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    wk, bk = build.pack_conv3x3(_oihw(w_hwio), torch.from_numpy(b), group=4)
    wk = wk.numpy().reshape(3, 3, 5, 8)
    np.testing.assert_array_equal(wk[..., :7], w_hwio)
    assert (wk[..., 7] == 0).all()
    np.testing.assert_array_equal(bk.numpy(), np.concatenate([b, [0.0]]).astype(np.float32))
    _, bk0 = build.pack_conv3x3(_oihw(w_hwio), None, group=12)
    assert bk0.shape == (12,) and (bk0 == 0).all()


def _spread_weights(rng, cout, cin):
    """Magnitudes spread log-uniformly over 1e-6..1, random signs."""
    mag = 10.0 ** rng.uniform(-6, 0, (cout, cin, 3, 3))
    return (mag * rng.choice([-1.0, 1.0], mag.shape)).astype(np.float32)


@pytest.mark.parametrize("cout,cin,top", [(48, 46, 1.0), (7, 5, 1.0), (16, 16, 3e-5), (8, 8, 700.0)])
def test_split_f16_is_f32_grade(rng, cout, cin, top):
    """w * S = w_hi + w_lo * 2^-11 within 2^-21 relative for every weight of
    a channel whose magnitudes span six decades; S is a power of two that
    puts the channel's largest weight into [2^13, 2^14]; a channel of
    zeros splits into zeros."""
    w = _spread_weights(rng, cout, cin) * np.float32(top)
    w[0, 0, 0, 0] = top  # channel 0 reaches the top of the range
    w[1] = 0.0
    hi, lo, inv = conv_chain.split_f16(torch.from_numpy(w))
    assert hi.dtype == lo.dtype == torch.float16 and inv.dtype == torch.float32
    assert bool(torch.isfinite(hi.float()).all() and torch.isfinite(lo.float()).all())
    mant, _ = np.frexp(inv.numpy())
    assert (mant == 0.5).all(), "S is not a power of two"
    scaled = w.astype(np.float64) / inv.numpy().astype(np.float64)[:, None, None, None]
    rec = hi.double().numpy() + lo.double().numpy() * 2.0 ** -11
    nz = scaled != 0
    assert (np.abs(rec - scaled)[nz] <= 2.0 ** -21 * np.abs(scaled)[nz]).all()
    assert (rec[~nz] == 0).all() and inv[1] == 1.0
    tops = np.abs(hi.float().numpy()).reshape(cout, -1).max(1)
    live = np.abs(w).reshape(cout, -1).max(1) > 0
    assert ((tops[live] >= 2.0 ** 13) & (tops[live] <= 2.0 ** 14)).all(), tops
    # no weight of a live channel was lost to f16's subnormal range
    assert (np.abs(hi.float().numpy())[nz] >= 2.0 ** -14).all()


@pytest.mark.parametrize("cin,cout", [(46, 48), (5, 7)])
def test_split_f16_products_match_f32_conv(rng, cin, cout):
    """The tensor-core kernel's arithmetic in plain PyTorch: on f16-exact
    inputs, an f32 conv with w_hi plus an f32 conv with w_lo * 2^-11,
    unscaled, against F.conv2d with the f32 weights. Both sum the same
    9 * cin products in f32, so they differ by the rounding of the sums
    alone: 8 f32 ulps of the largest output."""
    x = torch.from_numpy((rng.randn(2, cin, 12, 10) * 8).astype(np.float16)).float()
    w = torch.from_numpy(_spread_weights(rng, cout, cin))
    b = torch.from_numpy(rng.randn(cout).astype(np.float32))
    hi, lo, inv = conv_chain.split_f16(w)
    F = torch.nn.functional
    acc = F.conv2d(x, hi.float(), padding=1) + F.conv2d(x, lo.float(), padding=1) * 2.0 ** -11
    out = acc * inv[None, :, None, None] + b[None, :, None, None]
    ref = F.conv2d(x, w, b, padding=1)
    exact = F.conv2d(x.double(), w.double(), b.double(), padding=1)
    bar = 8 * 2.0 ** -24 * float(ref.abs().max())
    assert float((out - ref).abs().max()) <= bar
    # and it is as close to the exact sums as the f32 conv is
    assert float((out - exact).abs().max()) <= bar and float((ref - exact).abs().max()) <= bar


@pytest.mark.parametrize("chans", [[(46, 48), (48, 48), (48, 46)], [(5, 7)], [(20, 56), (56, 20)]])
def test_pack_chain_f16_layout(rng, chans):
    """The tensor-core kernel reads each stage's weights as B fragments of
    mma.sync.m16n8k16, [chunk of 6 n-tiles][ky][kx][k-chunk][n-tile][lane]
    [hi b0, hi b1, lo b0, lo b1]: lane 4g+t holds output channel 8*ntile+g,
    b0 the input channels 2t, 2t+1 of the k-chunk and b1 2t+8, 2t+9. Pad
    channels (cin to 16s, cout to 8s) are zero; then per stage 1/S (1 in
    the pad) and the bias (0 in the pad). A missing bias packs as zeros."""
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32) * 0.05) for ci, co in chans]
    bs = [torch.from_numpy(rng.randn(co).astype(np.float32)) for _, co in chans]
    bs[-1] = None
    wq, sb = conv_chain.pack_chain_f16(ws, bs)
    assert wq.dtype == torch.float16 and sb.dtype == torch.float32
    wq, sb = wq.numpy(), sb.numpy()
    woff = soff = 0
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for w, b, (cin, cout) in zip(ws, bs, chans):
        hi, lo, inv = (a.numpy() for a in conv_chain.split_f16(w))
        kc, nt = -(-cin // 16), -(-cout // 8)
        full = np.zeros((2, nt * 8, kc * 16, 3, 3), np.float16)
        full[0, :cout, :cin], full[1, :cout, :cin] = hi, lo
        for n0 in range(0, nt, 6):
            ntl = min(6, nt - n0)
            blk = wq[woff:woff + 9 * kc * ntl * 32 * 8].reshape(3, 3, kc, ntl, 32, 4, 2)
            woff += blk.size
            for ky in range(3):
                for kx in range(3):
                    for k in range(kc):
                        for n in range(ntl):
                            co = (n0 + n) * 8 + g
                            for word, (s, k0) in enumerate([(0, 0), (0, 8), (1, 0), (1, 8)]):
                                for e in range(2):
                                    want = full[s, co, k * 16 + k0 + 2 * t + e, ky, kx]
                                    np.testing.assert_array_equal(blk[ky, kx, k, n, :, word, e], want)
        np.testing.assert_array_equal(sb[soff:soff + cout], inv)
        assert (sb[soff + cout:soff + nt * 8] == 1).all()
        want_b = np.zeros(nt * 8, np.float32)
        if b is not None:
            want_b[:cout] = b.numpy()
        np.testing.assert_array_equal(sb[soff + nt * 8:soff + 2 * nt * 8], want_b)
        soff += 2 * nt * 8
    assert woff == wq.size and soff == sb.size


def test_packed_weights_cache(rng):
    """A weight set is packed once: the same tensors hit the cache, an
    in-place update, another device or another layout pack anew, and
    inference tensors (which carry no version) are packed every time."""
    ws = [torch.from_numpy(rng.randn(8, 8, 3, 3).astype(np.float32)) for _ in range(2)]
    bs = [torch.from_numpy(rng.randn(8).astype(np.float32)), None]
    before = conv_chain.packs
    first = conv_chain.packed_weights("mma_f16", ws, bs, conv_chain.pack_chain_f16)
    assert conv_chain.packs == before + 1
    again = conv_chain.packed_weights("mma_f16", list(ws), list(bs), conv_chain.pack_chain_f16)
    assert conv_chain.packs == before + 1 and again[0] is first[0] and again[1] is first[1]
    # views of the same storage are the same weights
    conv_chain.packed_weights("mma_f16", [w.detach() for w in ws], bs, conv_chain.pack_chain_f16)
    assert conv_chain.packs == before + 1
    ws[1].add_(0.5)
    fresh = conv_chain.packed_weights("mma_f16", ws, bs, conv_chain.pack_chain_f16)
    assert conv_chain.packs == before + 2 and not torch.equal(fresh[0], first[0])
    bs[0].add_(1.0)
    conv_chain.packed_weights("mma_f16", ws, bs, conv_chain.pack_chain_f16)
    assert conv_chain.packs == before + 3
    calls = []
    other = lambda w, b: calls.append(w[0].device.type) or (w[0], w[0])  # noqa: E731
    conv_chain.packed_weights("other", ws, bs, other)
    conv_chain.packed_weights("other", ws, bs, other)
    conv_chain.packed_weights("other", [w.to("meta") for w in ws], [bs[0].to("meta"), None], other)
    assert calls == ["cpu", "meta"] and conv_chain.packs == before + 5
    with torch.inference_mode():
        inf = [w.clone() for w in ws]
    conv_chain.packed_weights("other", inf, [None, None], other)
    conv_chain.packed_weights("other", inf, [None, None], other)
    assert len(calls) == 4 and conv_chain.packs == before + 7


def test_pack_chain_f16_sizes_match_kernel_offsets(rng):
    """The kernel finds stage k's weights after 9 * kchunks * ntiles * 32
    16-byte units per earlier stage, and its scales and biases after
    2 * 8 * ntiles floats per earlier stage (csrc/conv_chain.cu stage_of)."""
    chans = [(46, 48), (48, 48), (48, 46), (20, 56)]
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32)) for ci, co in chans]
    for depth in range(1, 5):
        wq, sb = conv_chain.pack_chain_f16(ws[:depth], [None] * depth)
        units = sum(9 * -(-ci // 16) * -(-co // 8) * 32 for ci, co in chans[:depth])
        assert wq.numel() == units * 8  # 8 halves per 16 bytes
        assert sb.numel() == sum(2 * 8 * -(-co // 8) for _, co in chans[:depth])


@pytest.mark.parametrize("kernel,variant", [
    (k, v) for k in ("chain", "tail") for v in ("base", "nob", "noa", "noload", "nomma", "nofetch")
    if (k, v) != ("tail", "nofetch")])
def test_clock_tool_patches_fit_the_sources(tmp_path, kernel, variant):
    """tools/chain_clocks.py instruments a copy of the CUDA sources by text
    patches; every anchor of every variant must still be there exactly once
    (the tool runs only on the card, where a lost anchor costs a call)."""
    import shutil
    from ntire2022_esr_tpu_torch.tools import chain_clocks

    csrc = tmp_path / "csrc"
    shutil.copytree(os.path.join(REPO, "ntire2022_esr_tpu_torch", "csrc"), csrc)
    source = chain_clocks.instrument(str(csrc), kernel, variant)
    text = (csrc / f"{source}.cu").read_text()
    assert text.count("g_prof") >= 3 and "read_prof" in text and "clock" in text


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is held by chip_smoke.py")
    from ntire2022_esr_tpu_torch.harness import registry, serving

    with pytest.raises(RuntimeError, match="CUDA"):
        config.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.build_model(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.SRServer(model_id=4, device="cuda")


def _port_files():
    pkg = os.path.join(REPO, "ntire2022_esr_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    files = list(_port_files())
    assert len(files) > 10
    assert os.path.join(REPO, "ntire2022_esr_tpu_torch", "utils", "image.py") in files
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                # the card's machine has no image library either
                assert top not in ("jax", "jaxlib", "ntire2022_esr_tpu", "cv2", "PIL"), \
                    f"{path} imports {name}"
