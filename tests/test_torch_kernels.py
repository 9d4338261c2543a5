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
    before = (dict(conv_chain.launches_by_path), dict(tail.launches_by_path))
    args = (_t(x), [_oihw(w) for w in ws], [torch.from_numpy(b) for b in bs])
    assert torch.equal(conv_chain.fused_conv3x3_chain(*args), conv_chain.conv3x3_chain_plain(*args))
    w = _oihw(rng.randn(3, 3, 4, 16).astype(np.float32))
    assert torch.equal(tail.fused_conv3x3_pixelshuffle(_t(x), w, None),
                       tail.conv3x3_pixelshuffle_plain(_t(x), w, None))
    assert (conv_chain.launches_by_path, tail.launches_by_path) == before


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
    inference tensors (which carry no version) are refused."""
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
    with pytest.raises(RuntimeError, match=r"torch\.inference_mode\(\)"):
        conv_chain.packed_weights("other", inf, [None, None], other)
    assert len(calls) == 2 and conv_chain.packs == before + 5


def test_model_built_in_inference_mode_packs_once():
    """A model built inside ``torch.inference_mode()`` holds ordinary
    tensors (``registry.build_model`` makes them outside it), so its
    weights are packed once however often they are used; its forwards on
    the CPU (the plain versions) pack nothing."""
    from ntire2022_esr_tpu_torch.harness import registry

    with torch.inference_mode():
        model, _, _, _ = registry.build_model(4, device="cpu")
        tensors = list(model.parameters()) + list(model.buffers())
        assert tensors and not any(t.is_inference() for t in tensors)
        before = conv_chain.packs
        for _ in range(3):
            model(torch.zeros(1, 24, 20, 3))
        assert conv_chain.packs == before
        convs = (model.B1.c1_r, model.B1.c2_r, model.B1.c3_r)
        key, pack = conv_chain.layout(torch.float32)
        for _ in range(3):
            conv_chain.packed_weights(key, [c.weight for c in convs], [c.bias for c in convs],
                                      pack)
        assert conv_chain.packs == before + 1


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


def _unpack_2byte_stage(wq, woff, cin, cout):
    """One stage of a one-term 2-byte pack (float32 copy of its values)
    back to OIHW, padded to whole k-chunks and n-tiles, by the lanes' own
    reads: [chunk of 6 n-tiles][ky][kx][k-chunk][n-tile][lane 4g+t][b0, b1],
    b0 the input channels 2t, 2t+1 and b1 2t+8, 2t+9 of the k-chunk, for
    output channel 8 ntile + g. Returns (weights, offset after the stage)."""
    kc, nt = -(-cin // 16), -(-cout // 8)
    full = np.full((nt * 8, kc * 16, 3, 3), np.nan, np.float32)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for n0 in range(0, nt, 6):
        ntl = min(6, nt - n0)
        blk = wq[woff:woff + 9 * kc * ntl * 32 * 4].reshape(3, 3, kc, ntl, 32, 2, 2)
        woff += blk.size
        for k in range(kc):
            for n in range(ntl):
                co = (n0 + n) * 8 + g
                for word, k0 in enumerate((0, 8)):
                    for e in range(2):
                        full[co, k * 16 + k0 + 2 * t + e] = \
                            blk[:, :, k, n, :, word, e].transpose(2, 0, 1)
    return full, woff


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("chans", [[(46, 48), (48, 48), (48, 46)], [(5, 7)], [(20, 56), (56, 20)]])
def test_pack_chain_2byte_layout(rng, chans, dtype):
    """The one-product kernel of fast16 (f16) and fast (bf16) reads each
    stage's weights once, rounded to the dtype as conv_chain.rounded rounds
    them (saturating into f16), as B fragments of mma.sync.m16n8k16 in the
    f16 pack's order with one term: 9 * kc * nt * 16 units of 16 bytes a
    stage (csrc/conv_chain.cu stage_of with P = 1), zero in the pads of cin
    (to 16s) and cout (to 8s). Then per stage a scale of 1 per channel and
    the bias rounded to the dtype, zero in the pad and where it is missing."""
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32) * 0.05) for ci, co in chans]
    ws[0][0, 0, 1, 1] = 1e5  # past f16's range: the f16 pack saturates it
    bs = [torch.from_numpy(rng.randn(co).astype(np.float32)) for _, co in chans]
    bs[-1] = None
    wq, sb = conv_chain.pack_chain_2byte(ws, bs, dtype)
    assert wq.dtype == dtype and sb.dtype == torch.float32
    wr, br = conv_chain.rounded(ws, bs, dtype)
    assert float(wr[0][0, 0, 1, 1]) == (65504.0 if dtype == torch.float16 else 99840.0)
    wq, sb = wq.float().numpy(), sb.numpy()
    woff = soff = 0
    for w, b, (cin, cout) in zip(wr, br, chans):
        start = woff
        full, woff = _unpack_2byte_stage(wq, woff, cin, cout)
        assert woff - start == 9 * -(-cin // 16) * -(-cout // 8) * 16 * 8  # 8 values a unit
        np.testing.assert_array_equal(full[:cout, :cin], w.numpy())
        assert (full[cout:] == 0).all() and (full[:, cin:] == 0).all()
        nt8 = -(-cout // 8) * 8
        assert (sb[soff:soff + nt8] == 1).all()
        want_b = np.zeros(nt8, np.float32)
        if b is not None:
            want_b[:cout] = b.numpy()
        np.testing.assert_array_equal(sb[soff + nt8:soff + 2 * nt8], want_b)
        soff += 2 * nt8
    assert woff == wq.size and soff == sb.size


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_pack_chain_2byte_sizes_match_kernel_offsets(rng, dtype):
    """Under one product the kernel finds stage k's weights after
    9 * kchunks * ntiles * frag_units(1) = 16 units of 16 bytes per earlier
    stage, and its scales and biases after 2 * 8 * ntiles floats, as under
    two (csrc/conv_chain.cu stage_of)."""
    chans = [(46, 48), (48, 48), (48, 46), (20, 56)]
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32)) for ci, co in chans]
    for depth in range(1, 5):
        wq, sb = conv_chain.pack_chain_2byte(ws[:depth], [None] * depth, dtype)
        units = sum(9 * -(-ci // 16) * -(-co // 8) * 16 for ci, co in chans[:depth])
        assert wq.numel() == units * 8  # 8 two-byte values per 16 bytes
        assert sb.numel() == sum(2 * 8 * -(-co // 8) for _, co in chans[:depth])
        f16 = conv_chain.pack_chain_f16(ws[:depth], [None] * depth)
        assert 2 * wq.numel() == f16[0].numel() and sb.numel() == f16[1].numel()


@pytest.mark.parametrize("kernel,variant", [
    (k, v) for k in ("chain", "tail")
    for v in ("base", "nob", "noa", "noload", "nomma", "nofetch", "mt4")
    if (k, v) != ("tail", "nofetch")] + [
    (k, v) for k in ("chain_tf32", "tail_tf32") for v in ("base", "noload", "nomma", "nofetch")
    if (k, v) != ("tail_tf32", "nofetch")])
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


# ---- the split-TF32 path (parity, high: f32 activations; fasthi: bf16) ----

def _low_bits(t):
    return t.contiguous().view(torch.int32) & 0x1FFF


@pytest.mark.parametrize("cout,cin,top", [(48, 46, 1.0), (7, 5, 1.0), (16, 16, 3e-5), (8, 8, 700.0)])
def test_split_tf32(rng, cout, cin, top):
    """Each term of split_tf32 is a TF32 value (13 zero low mantissa bits),
    w_hi is w rounded to the nearest TF32 value, ties away from zero (the
    rounding of cvt.rna.tf32.f32), and w_hi + w_lo recovers w within 2^-21
    relative, over weights whose magnitudes span six decades; zeros split
    into zeros."""
    w = _spread_weights(rng, cout, cin) * np.float32(top)
    w[1] = 0.0
    hi, lo = conv_chain.split_tf32(torch.from_numpy(w))
    assert hi.dtype == lo.dtype == torch.float32
    assert bool((_low_bits(hi) == 0).all() and (_low_bits(lo) == 0).all())
    # round to nearest, ties away: the nearest multiple of the TF32 ulp
    m, e = np.frexp(w.astype(np.float64))  # w = m * 2**e, 0.5 <= |m| < 1
    ulp = np.ldexp(1.0, e - 11)
    want = np.sign(w) * np.floor(np.abs(w) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(hi.double().numpy(), want)
    rec = hi.double().numpy() + lo.double().numpy()
    w64 = w.astype(np.float64)
    assert (np.abs(rec - w64) <= 2.0 ** -21 * np.abs(w64)).all()
    assert (hi[1] == 0).all() and (lo[1] == 0).all()
    # ties: 1 + 2^-11 lies halfway between two TF32 values and goes up
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -11 - 2.0 ** -23])
    assert conv_chain.round_tf32(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]


def _unpack_tf32(wq, cin, cout, n0, ntl, woff):
    """One chunk of ``ntl`` n-tiles of one stage's packed TF32 weights, as
    [tap][k-chunk][n-tile][hi/lo][lane][word]; and the offset after it."""
    kc = -(-cin // 16)
    size = 9 * kc * ntl * 2 * 32 * 4
    return wq[woff:woff + size].reshape(9, kc, ntl, 2, 32, 4), woff + size


def _check_tf32_stage(wq, woff, w, cin, cout):
    """Asserts that stage weights ``w`` (OIHW) lie at ``woff`` of ``wq`` in
    the split-TF32 fragment order; returns the offset after them."""
    kc, nt = -(-cin // 16), -(-cout // 8)
    hi, lo = (a.numpy() for a in conv_chain.split_tf32(w))
    full = np.zeros((2, nt * 8, kc * 16, 3, 3), np.float32)
    full[0, :cout, :cin], full[1, :cout, :cin] = hi, lo
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for n0 in range(0, nt, 6):
        ntl = min(6, nt - n0)
        blk, woff = _unpack_tf32(wq, cin, cout, n0, ntl, woff)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            for k in range(kc):
                for n in range(ntl):
                    co = (n0 + n) * 8 + g
                    for s in range(2):
                        for j in range(4):
                            want = full[s, co, k * 16 + 4 * t + j, ky, kx]
                            np.testing.assert_array_equal(blk[tap, k, n, s, :, j], want)
    return woff


@pytest.mark.parametrize("chans", [[(46, 48), (48, 48), (48, 46)], [(5, 7)], [(20, 56), (56, 20)]])
def test_pack_chain_tf32_layout(rng, chans):
    """The split-TF32 kernel reads each stage's weights as B fragments of
    mma.sync.m16n8k8: [chunk of 6 n-tiles][tap][k-chunk of 16][n-tile]
    [hi, lo][lane 4g+t][word j] = w[8 ntile + g][16 kchunk + 4t + j], zero
    in the pads of cin (to 16s) and cout (to 8s); 9 * kc * nt * 64 units of
    16 bytes a stage (csrc/conv_chain.cu stage32_of). Then per stage the
    bias padded with zeros to whole n-tiles; a missing bias packs as zeros."""
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32) * 0.05) for ci, co in chans]
    bs = [torch.from_numpy(rng.randn(co).astype(np.float32)) for _, co in chans]
    bs[-1] = None
    wq, bq = conv_chain.pack_chain_tf32(ws, bs)
    assert wq.dtype == bq.dtype == torch.float32
    wq, bq = wq.numpy(), bq.numpy()
    woff = boff = 0
    for w, b, (cin, cout) in zip(ws, bs, chans):
        start = woff
        woff = _check_tf32_stage(wq, woff, w, cin, cout)
        assert woff - start == 9 * -(-cin // 16) * -(-cout // 8) * 64 * 4
        nt8 = -(-cout // 8) * 8
        want_b = np.zeros(nt8, np.float32)
        if b is not None:
            want_b[:cout] = b.numpy()
        np.testing.assert_array_equal(bq[boff:boff + nt8], want_b)
        boff += nt8
    assert woff == wq.size and boff == bq.size


# the zoo's upsampler widths (40, 42, 50, 64 -> 48) and RLFN's 46, r = 4; and
# widths whose conv channels (27, 12) are no multiples of 8
TAIL32_CASES = [(40, 3, 4), (42, 3, 4), (46, 3, 4), (50, 3, 4), (64, 3, 4), (24, 3, 3), (5, 3, 2)]


@pytest.mark.parametrize("cin,cout,r", TAIL32_CASES)
def test_pack_tail_tf32_layout(rng, cin, cout, r):
    """pack_tail_tf32 is the chain's one-stage split-TF32 packing of the
    weights with the output channels in shuffled order (i, j, c), and the
    bias in that order."""
    _, w, b = _tail_case(rng, cin, cout, r)
    nch = cout * r * r
    order = tail.shuffled_order(cout, r)
    wq, bq = tail.pack_tail_tf32(w, b, r)
    assert _check_tf32_stage(wq.numpy(), 0, w[order], cin, nch) == wq.numel()
    nt8 = -(-nch // 8) * 8
    np.testing.assert_array_equal(bq.numpy()[:nch], b[order].numpy())
    assert bq.numel() == nt8 and (bq[nch:] == 0).all()
    assert (tail.pack_tail_tf32(w, None, r)[1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,r", TAIL32_CASES)
def test_pack_tail_2byte_layout(rng, cin, cout, r, dtype):
    """pack_tail_2byte is the chain's one-stage one-term packing of the
    weights rounded to the dtype, with the output channels in shuffled order
    (i, j, c): 9 * kc * nt * 16 units of 16 bytes (csrc/tail.cu tail_geom
    with P = 1), then a scale of 1 per channel and the rounded bias in that
    order, zero in the pad and where it is missing."""
    _, w, b = _tail_case(rng, cin, cout, r)
    nch = cout * r * r
    order = tail.shuffled_order(cout, r)
    wq, sb = tail.pack_tail_2byte(w, b, r, dtype)
    assert wq.dtype == dtype and sb.dtype == torch.float32
    (wr,), (br,) = conv_chain.rounded([w[order]], [b[order]], dtype)
    full, woff = _unpack_2byte_stage(wq.float().numpy(), 0, cin, nch)
    assert woff == wq.numel() == 9 * -(-cin // 16) * -(-nch // 8) * 16 * 8
    np.testing.assert_array_equal(full[:nch, :cin], wr.numpy())
    assert (full[nch:] == 0).all() and (full[:, cin:] == 0).all()
    nt8 = -(-nch // 8) * 8
    assert sb.numel() == 2 * nt8 and (sb[:nt8] == 1).all()
    np.testing.assert_array_equal(sb[nt8:nt8 + nch].numpy(), br.numpy())
    assert (sb[nt8 + nch:] == 0).all()
    assert (tail.pack_tail_2byte(w, None, r, dtype)[1][nt8:] == 0).all()


def _conv_tf32(x, w, b, products):
    """The split-TF32 kernel's arithmetic for one conv in plain PyTorch: the
    activations split as the kernel splits them in registers (a_lo is
    exactly 0 for bf16 inputs, which then take 2 products), the weights as
    the host packs them; the sum of the products a_hi * w_hi, a_hi * w_lo
    and a_lo * w_hi (each an f32 conv: sums of exact products in f32), then
    + bias. ``products=1`` is a control short of f32 grade: a_hi * w_hi
    alone."""
    F = torch.nn.functional
    a = x.float()
    a_hi = conv_chain.round_tf32(a)
    a_lo = conv_chain.round_tf32(a - a_hi)
    if x.dtype == torch.bfloat16:
        assert products in (1, 2) and bool((a_lo == 0).all()) and torch.equal(a_hi, a)
    w_hi, w_lo = conv_chain.split_tf32(w)
    out = F.conv2d(a_hi, w_hi, padding=1)
    if products >= 2:
        out = out + F.conv2d(a_hi, w_lo, padding=1)
    if products >= 3:
        out = out + F.conv2d(a_lo, w_hi, padding=1)
    return out if b is None else out + b[None, :, None, None]


def _chain_tf32(x, ws, bs, slope, residual, products):
    """The split-TF32 chain kernel's arithmetic: per stage the emulated
    conv, the store's rounding to x's dtype, LeakyReLU with the slope
    rounded to it; then + x."""
    h = x
    for w, b in zip(ws, bs):
        h = ops.nn.leaky_relu(_conv_tf32(h, w, b, products).to(x.dtype), slope)
    return (h.float() + x.float()).to(x.dtype) if residual else h


def _chain_magnitude(x, ws, bs, residual):
    """The chain on |x|, |w|, |b| with LeakyReLU off: at every stage a bound
    on the sum of the magnitudes of the terms of each output, which bounds
    the f32 rounding of any order of summing them, carried through the
    later stages."""
    h = x.abs().float()
    for w, b in zip(ws, bs):
        h = torch.nn.functional.conv2d(h, w.abs(), b.abs(), padding=1)
    return h + x.abs().float() if residual else h


@pytest.mark.parametrize("shape,chans,residual", CHAIN_CASES + [
    ((2, 24, 20, 46), [(46, 48), (48, 48), (48, 46)], True)])
def test_chain_tf32_arithmetic_matches_plain_and_pallas(rng, interpret_pallas, shape, chans,
                                                        residual):
    """Under parity (f32 activations, 3 products) the split-TF32 chain's
    arithmetic, emulated on the CPU, agrees with the plain version and with
    the JAX Pallas kernel (interpret mode) within the f32 conv's own
    reordering error: 8 f32 ulps of the magnitude sum at each stage, carried
    through the chain (x depth), plus one of the output for the residual's
    rounding."""
    from ntire2022_esr_tpu.ops.pallas import fused_conv3x3_chain as pallas_chain

    x, ws, bs = _chain_case(rng, shape, chans)
    wt, bt = [_oihw(w) for w in ws], [torch.from_numpy(b) for b in bs]
    xt = _t(x)
    emu = _chain_tf32(xt, wt, bt, 0.05, residual, 3)
    plain = conv_chain.fused_conv3x3_chain(xt, wt, bt, slope=0.05, residual=residual)
    ref = np.asarray(pallas_chain(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                  [jnp.asarray(b) for b in bs], slope=0.05, residual=residual))
    bar = (len(ws) * 8 * 2.0 ** -24 * _chain_magnitude(xt, wt, bt, residual)
           + 2.0 ** -24 * plain.abs())
    assert bool(((emu - plain).abs() <= bar).all()), float((emu - plain).abs().max())
    assert (np.abs(_n(emu) - ref) <= _n(bar)).all(), np.abs(_n(emu) - ref).max()
    # and the split's own error is below that bar's scale: 3 products, not 1
    one = _chain_tf32(xt, [conv_chain.round_tf32(w) for w in wt], bt, 0.05, residual, 2)
    assert float((one - plain).abs().max()) > float((emu - plain).abs().max())


def test_chain_tf32_arithmetic_fasthi(rng):
    """Under fasthi (bf16 activations) every activation is an exact TF32
    value: a_lo is 0 and two products give the f32-grade sums. Emulated on
    the CPU against the plain version and the unfused JAX graph under
    fasthi: each stage's bf16 store rounds the same f32-grade sums, so they
    differ only where two sums straddle a rounding boundary, and a one-ulp
    flip is carried on; at most 4 bf16 ulps anywhere and an eighth of one
    on average (the bar of test_chain_plain_matches_unfused_jax_storage_tiers)."""
    x, ws, bs = _chain_case(rng, (2, 24, 20, 46), [(46, 48), (48, 48), (48, 46)])
    x = np.asarray(jnp.asarray(x * 8).astype(jnp.bfloat16))
    ulp = 2.0 ** -7
    with jconfig.numerics_mode("fasthi"):
        h = jnp.asarray(x)
        for w, b in zip(ws, bs):
            h = jops.leaky_relu(jops.conv2d(h, jnp.asarray(w), jnp.asarray(b)), 0.05)
        ref = np.asarray(h + jnp.asarray(x)).astype(np.float32)
    xt = ops.from_nhwc(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))
    wt, bt = [_oihw(w) for w in ws], [torch.from_numpy(b) for b in bs]
    emu = _chain_tf32(xt, wt, bt, 0.05, True, 2)
    with config.numerics_mode("fasthi"):
        plain = conv_chain.fused_conv3x3_chain(xt, wt, bt)
    assert emu.dtype == plain.dtype == torch.bfloat16
    for other in (_n(plain), ref):
        d = np.abs(_n(emu) - other)
        assert (d <= 4 * ulp * np.maximum(np.abs(other), 1.0)).all(), d.max()
        assert d.mean() < ulp / 8 * np.abs(other).mean() + 1e-4, d.mean()


@pytest.mark.parametrize("cin,cout,r", TAIL32_CASES)
def test_tail_tf32_arithmetic_matches_plain_and_pallas(rng, interpret_pallas, cin, cout, r):
    """Under parity the split-TF32 tail's arithmetic, emulated on the CPU
    with the weights in shuffled order and the run-wise copy, agrees with
    the plain version and with the JAX Pallas kernel (interpret mode) within
    the f32 conv's own reordering error (8 f32 ulps of the magnitude sum)."""
    from ntire2022_esr_tpu.ops.pallas import fused_conv3x3_pixelshuffle as pallas_tail

    x16, w, b = _tail_case(rng, cin, cout, r, hw=(11, 9))
    x = x16.float() * (1 + torch.from_numpy(rng.rand(*x16.shape).astype(np.float32)) * 1e-3)
    x = x.contiguous(memory_format=torch.channels_last)  # full f32 mantissas: a_lo != 0
    order = tail.shuffled_order(cout, r)
    wq, bq = tail.pack_tail_tf32(w, b, r)
    emu = _copy_runs(_conv_tf32(x, w[order], bq[:cout * r * r], 3), cout, r)
    plain = tail.fused_conv3x3_pixelshuffle(x, w, b, r=r)
    w_hwio = w.permute(2, 3, 1, 0).numpy()
    ref = np.asarray(pallas_tail(jnp.asarray(_n(x)), jnp.asarray(w_hwio), jnp.asarray(b.numpy()),
                                 r=r))
    bar = 8 * 2.0 ** -24 * tail.conv3x3_pixelshuffle_plain(x.abs(), w.abs(), b.abs(), r=r)
    assert bool(((emu - plain).abs() <= bar).all()), float((emu - plain).abs().max())
    assert (np.abs(_n(emu) - ref) <= _n(bar)).all()


@pytest.mark.parametrize("cin", [46, 50])
def test_tail_tf32_arithmetic_fasthi(rng, cin):
    """Under fasthi the emulated 2-product tail (a_lo = 0 on bf16 inputs)
    rounds the same f32-grade sums to bf16 as the plain version and the
    unfused JAX graph: values differ by one bf16 ulp at most, in under 1%
    of them."""
    r, cout = 4, 3
    x = (rng.randn(1, 9, 7, cin) * 4).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    w = rng.randn(3, 3, cin, cout * r * r).astype(np.float32) * 0.05
    b = rng.randn(cout * r * r).astype(np.float32)
    with jconfig.numerics_mode("fasthi"):
        ref = np.asarray(jops.pixel_shuffle(jops.conv2d(jnp.asarray(x), jnp.asarray(w),
                                                        jnp.asarray(b)), r)).astype(np.float32)
    xt = ops.from_nhwc(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))
    wt, bt = _oihw(w), torch.from_numpy(b)
    order = tail.shuffled_order(cout, r)
    emu = _copy_runs(_conv_tf32(xt, wt[order], bt[order], 2).to(torch.bfloat16), cout, r)
    with config.numerics_mode("fasthi"):
        plain = tail.fused_conv3x3_pixelshuffle(xt, wt, bt, r=r)
    assert emu.dtype == plain.dtype == torch.bfloat16
    for other in (_n(plain), ref):
        d = np.abs(_n(emu) - other)
        assert (d <= 2.0 ** -7 * np.abs(other) + 1e-6).all(), d.max()
        assert (d > 0).mean() < 1e-2


@pytest.mark.parametrize("kernel", ["chain", "tail"])
def test_fasthi_flip_bar_separates_two_products_from_one(kernel):
    """chip_smoke.py holds the 2-product (fasthi) kernels' flip rate against
    the plain version to tools/chain_check.py's bar. On RLFN's weights and
    the smoke's (2, 63, 41, 46) input (numpy seed 1, 8 * randn, bf16) the
    emulated 2-product arithmetic stays under that bar and a kernel that
    multiplies by TF32 weights alone (one product) is over 10 times it."""
    from ntire2022_esr_tpu_torch.harness import registry
    from ntire2022_esr_tpu_torch.tools.chain_check import FASTHI_FLIP_BARS

    model = registry.build_model(4, device="cpu")[0]
    x = np.random.RandomState(1).standard_normal((2, 63, 41, 46)).astype(np.float32) * 8
    x = ops.from_nhwc(torch.from_numpy(x)).to(torch.bfloat16)
    rates = {}
    with config.numerics_mode("fasthi"), torch.inference_mode():
        if kernel == "chain":
            convs = (model.B1.c1_r, model.B1.c2_r, model.B1.c3_r)
            ws, bs = [c.weight for c in convs], [c.bias for c in convs]
            plain = conv_chain.conv3x3_chain_plain(x, ws, bs, slope=0.05, residual=True)
            for p in (2, 1):
                rates[p] = float((_chain_tf32(x, ws, bs, 0.05, True, p) != plain).float().mean())
        else:
            w, b = model.upsampler[0].weight, model.upsampler[0].bias
            plain = tail.conv3x3_pixelshuffle_plain(x, w, b, r=4)
            order = tail.shuffled_order(3, 4)
            for p in (2, 1):
                emu = _copy_runs(_conv_tf32(x, w[order], b[order], p).to(torch.bfloat16), 3, 4)
                rates[p] = float((emu != plain).float().mean())
    bar = FASTHI_FLIP_BARS[kernel]
    assert rates[2] <= bar and rates[1] > 10 * bar, rates


def test_one_product_control_patch_fits(tmp_path):
    """tools/chain_check.py --one-product builds a copy whose fasthi
    kernels drop a_hi * w_lo: its text patches still fit, and in each
    kernel's source only fasthi's launch changes, to the split-TF32
    template with one product (which no tier launches) and fasthi's
    single rounding."""
    from ntire2022_esr_tpu_torch.tools import chain_check

    dst = chain_check.one_product_copy(str(tmp_path / "control"))
    for fname in ("conv_chain.cu", "tail.cu"):
        rel = os.path.join(chain_check.PKG, "csrc", fname)
        with open(os.path.join(chain_check.REPO, rel)) as fh:
            before = fh.read().splitlines()
        with open(os.path.join(dst, rel)) as fh:
            after = fh.read().splitlines()
        changed = [(a, b) for a, b in zip(before, after) if a != b]
        assert len(before) == len(after) and len(changed) == 1, fname
        assert "_tf32_kernel<__nv_bfloat16, 1>" in changed[0][1], fname


def test_packed_weights_keys_tf32(rng):
    """The wrappers pack f16 and TF32 layouts under distinct cache keys: the
    same weights pack once per layout, and parity and fasthi share the
    TF32 one (the same packed terms, 3 or 2 products at run time)."""
    ws = [torch.from_numpy(rng.randn(8, 8, 3, 3).astype(np.float32))]
    bs = [torch.from_numpy(rng.randn(8).astype(np.float32))]
    keys = {dt: conv_chain.layout(dt)[0] for dt in conv_chain.PATHS}
    assert keys[torch.float32] == keys[torch.bfloat16] != keys[torch.float16]
    tkeys = {dt: tail.layout(dt, 4)[0] for dt in conv_chain.PATHS}
    assert tkeys[torch.float32] == tkeys[torch.bfloat16] != tkeys[torch.float16]
    assert tail.layout(torch.float32, 2)[0] != tkeys[torch.float32]
    assert len(set(keys.values()) | set(tkeys.values())) == 4
    before = conv_chain.packs
    got = {}
    for dt in (torch.float16, torch.float32, torch.bfloat16):
        key, pack = conv_chain.layout(dt)
        got[dt] = conv_chain.packed_weights(key, ws, bs, pack)
    assert conv_chain.packs == before + 2
    assert got[torch.float32] is got[torch.bfloat16]
    assert torch.equal(got[torch.float32][0], conv_chain.pack_chain_tf32(ws, bs)[0])
    assert torch.equal(got[torch.float16][0], conv_chain.pack_chain_f16(ws, bs)[0])


def test_accumulation_model_per_tap_beats_hi_lo(capsys, monkeypatch):
    """tools/accumulation_model.py, which the split-TF32 kernels' way of
    summing rests on, still runs and still ranks fresh sums per tap below
    hi/lo sets over the whole sum, and below an f32 FMA chain, in both
    alignment models (3000 outputs, seed 0)."""
    import re
    import sys
    from ntire2022_esr_tpu_torch.tools import accumulation_model

    monkeypatch.setattr(sys, "argv", ["accumulation_model.py"])
    assert accumulation_model.main() == 0
    ratios = re.findall(r"hi/lo \S+ \(([\d.]+)x the FMA chain\), per tap \S+ \(([\d.]+)x\)",
                        capsys.readouterr().out)
    assert len(ratios) == 2
    for hilo, tap in ratios:  # measured at seed 0: 0.65 < 1.93 and 0.91 < 2.02
        assert float(tap) < 1.0 and float(tap) < float(hilo)
