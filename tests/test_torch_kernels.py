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


# the zoo's new widths on the tail: ESAN's and SCET's 3-channel LR input
# (34: 3 -> 48, 30: 3 -> 64), FDEN's odd 29 -> 48 (17), and SCET's 64 -> 64
# to 4 channels (30)
@pytest.mark.parametrize("shape,cin,cout", [((1, 40, 52, 16), 16, 3), ((2, 33, 47, 12), 12, 3),
                                            ((1, 10, 12, 3), 3, 3), ((1, 10, 12, 29), 29, 3),
                                            ((1, 10, 12, 64), 64, 4), ((1, 10, 12, 3), 3, 4)])
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
def test_pack_tail_wgmma_f16_layout(rng, cin, cout, r):
    """pack_tail_wgmma_f16 is the chain's one-stage wgmma packing of the
    permuted weights: B operands [step of 6 n-tiles][ky][kx][k-chunk]
    [column group][k-half][8 columns][8 k], the hi terms' 48 columns of a
    step and then the lo terms', zeros in the pads of cin (to 16s) and of
    cout*r*r (to whole steps); steps * 9 units of kc * 96 * 16 values (a
    unit is one tap of one step, csrc/tail.cu wg_tail); then 1/S (1 in the
    pad) and the bias (0 in the pad) in the permuted order."""
    _, w, b = _tail_case(rng, cin, cout, r)
    nch = cout * r * r
    kc, nt = -(-cin // 16), -(-nch // 8)
    steps = -(-nt // 6)
    wq, sb = tail.pack_tail_wgmma_f16(w, b, r)
    assert wq.dtype == torch.float16 and wq.numel() == steps * 9 * kc * 96 * 16
    assert sb.dtype == torch.float32 and sb.numel() == 2 * 8 * nt
    assert 2 * wq.numel() == steps * 9 * tail.wgmma_plan(cin, cout, r, torch.float16)["unit"]
    order = tail.shuffled_order(cout, r)
    hi, lo, inv = (a.numpy() for a in conv_chain.split_f16(w[order]))
    full = np.zeros((2, steps * 48, kc * 16, 3, 3), np.float16)
    full[0, :nch, :cin], full[1, :nch, :cin] = hi, lo
    # [term, step, column group, column, k-chunk, k-half, k, ky, kx]
    want = full.reshape(2, steps, 6, 8, kc, 2, 8, 3, 3).transpose(1, 7, 8, 4, 0, 2, 5, 3, 6)
    np.testing.assert_array_equal(wq.numpy(), want.reshape(-1))
    sb = sb.numpy()
    np.testing.assert_array_equal(sb[:nch], inv)
    assert (sb[nch:nt * 8] == 1).all()
    np.testing.assert_array_equal(sb[nt * 8:nt * 8 + nch], b[order].numpy())
    assert (sb[nt * 8 + nch:] == 0).all()
    _, sb0 = tail.pack_tail_wgmma_f16(w, None, r)
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
    _, sb = tail.pack_tail_wgmma_f16(w, b, r)
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
    key, pack = tail.layout(torch.float16, 2)
    assert key == "wgmma_tail_f16_r2" and tail.packed_weights is conv_chain.packed_weights
    before = conv_chain.packs
    first = tail.packed_weights(key, [w], [b], pack)
    again = tail.packed_weights(key, [w], [b], pack)
    assert conv_chain.packs == before + 1 and again[0] is first[0]
    assert torch.equal(first[0], tail.pack_tail_wgmma_f16(w, b, 2)[0])
    w.mul_(2.0)
    fresh = tail.packed_weights(key, [w], [b], pack)
    assert conv_chain.packs == before + 2
    # doubling a weight doubles S's inverse and leaves the split terms alone
    assert torch.equal(fresh[0], first[0]) and torch.equal(fresh[1][:12], first[1][:12] * 2)
    tail.packed_weights(key, [w], [None], pack)
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


def _wgmma_stage(wq, woff, cin, cout, terms, ntl):
    """One stage of a wgmma pack (a float32 copy of its values) back to OIHW
    terms ``[terms, chunks * ntl * 8, kc * 16, 3, 3]``, by the kernel's own
    reads (csrc/conv_chain.cu fetch_step and the B descriptors): the step
    of chunk nc starts 9 * kc * N * 16 values after the last, N = 8 ntl
    terms; a tap's k-chunk c is the N x 16 operand at (tap * kc + c) * N * 16
    values, its core matrix of column group j and k-half h at
    (2 j + h) * 64 (SBO 256 bytes, LBO 128), 8 columns of 8 k each; column
    group j holds term j // ntl of n-tile nc * ntl + j % ntl. Returns the
    weights and the offset after the stage."""
    kc, nch = -(-cin // 16), -(-cout // (8 * ntl))
    n = 8 * ntl * terms
    full = np.full((terms, nch * ntl * 8, kc * 16, 3, 3), np.nan, np.float32)
    for nc in range(nch):
        for tap in range(9):
            for c in range(kc):
                op = wq[woff + (tap * kc + c) * n * 16:][:n * 16]
                for j in range(terms * ntl):
                    for h in range(2):
                        core = op[(2 * j + h) * 64:(2 * j + h + 1) * 64].reshape(8, 8)
                        nt = nc * ntl + j % ntl
                        full[j // ntl, nt * 8:nt * 8 + 8, c * 16 + 8 * h:c * 16 + 8 * h + 8,
                             tap // 3, tap % 3] = core
        woff += 9 * kc * n * 16
    return full, woff


def _wgmma_units(chans, terms):
    """Each stage's 16-byte units in a chain's wgmma pack, as
    csrc/conv_chain.cu wg_stage counts them: 9 * kc * 16 * P * ntl per
    chunk of ntl = 6 n-tiles (kStepNt), the last chunk zero-padded."""
    ntl = 6
    return [9 * -(-ci // 16) * 16 * terms * ntl * -(-(-(-co // 8)) // ntl) for ci, co in chans]


CHAIN_PACK_CHANS = [[(46, 48), (48, 48), (48, 46)], [(5, 7)], [(20, 56), (56, 20)]]


@pytest.mark.parametrize("chans", CHAIN_PACK_CHANS)
def test_pack_chain_f16_layout(rng, chans):
    """The wgmma kernel reads each stage's split weights as N x 16 B
    operands, [chunk of ntl n-tiles][ky][kx][k-chunk][column group][k-half]
    [8 columns][8 k] with N = 16 ntl: the hi terms' n-tiles, then the lo
    terms'; ntl is 6 (one step of the kernel, kStepNt) at every width and
    the last chunk is zero-padded. Value at (chunk, ky, kx, kc, s * ntl + j, h,
    n, k) is term s of output channel 8 (chunk * ntl + j) + n and input
    channel 16 kc + 8 h + k. Pad channels (cin to 16s, cout to whole
    chunks) are zero; then per stage 1/S (1 in the pad) and the bias (0 in
    the pad). A missing bias packs as zeros."""
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32) * 0.05) for ci, co in chans]
    bs = [torch.from_numpy(rng.randn(co).astype(np.float32)) for _, co in chans]
    bs[-1] = None
    wq, sb = conv_chain.pack_chain_f16(ws, bs)
    assert wq.dtype == torch.float16 and sb.dtype == torch.float32
    ntl = conv_chain._NT_CHUNK
    assert ntl == 6
    wq, sb = wq.numpy(), sb.numpy()
    woff = soff = 0
    for w, b, (cin, cout) in zip(ws, bs, chans):
        hi, lo, inv = (a.numpy() for a in conv_chain.split_f16(w))
        kc, nt = -(-cin // 16), -(-cout // 8)
        nch = -(-nt // ntl)
        full = np.zeros((2, nch * ntl * 8, kc * 16, 3, 3), np.float16)
        full[0, :cout, :cin], full[1, :cout, :cin] = hi, lo
        want = full.reshape(2, nch, ntl, 8, kc, 2, 8, 3, 3).transpose(1, 7, 8, 4, 0, 2, 5, 3, 6)
        np.testing.assert_array_equal(wq[woff:woff + want.size], want.reshape(-1))
        woff += want.size
        np.testing.assert_array_equal(sb[soff:soff + cout], inv)
        assert (sb[soff + cout:soff + nt * 8] == 1).all()
        want_b = np.zeros(nt * 8, np.float32)
        if b is not None:
            want_b[:cout] = b.numpy()
        np.testing.assert_array_equal(sb[soff + nt * 8:soff + 2 * nt * 8], want_b)
        soff += 2 * nt * 8
    assert woff == wq.size and soff == sb.size


@pytest.mark.parametrize("kind", ["split_f16", "float16", "bfloat16"])
@pytest.mark.parametrize("chans", [[(46, 48), (48, 48), (48, 46)], [(5, 7)], [(20, 56), (56, 20)]])
def test_chain_pack_round_trip(rng, kind, chans):
    """Each pack read back by the kernel's own addressing (_wgmma_stage)
    gives the weights it packed, OIHW: the split f16 pack its hi and lo
    terms (w * S = w_hi + w_lo * 2^-11 to 2^-22 relative), the f16 and bf16
    packs the weights rounded to the dtype; zero in every pad, and the
    stages one after the other with nothing between or after them."""
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32) * 0.05) for ci, co in chans]
    bs = [torch.from_numpy(rng.randn(co).astype(np.float32)) for _, co in chans]
    if kind == "split_f16":
        wq, _ = conv_chain.pack_chain_f16(ws, bs)
        terms, want = 2, [conv_chain.split_f16(w) for w in ws]
    else:
        dt = getattr(torch, kind)
        wq, _ = conv_chain.pack_chain_2byte(ws, bs, dt)
        terms, want = 1, [(w,) for w in conv_chain.rounded(ws, bs, dt)[0]]
    ntl = conv_chain._NT_CHUNK
    wq = wq.float().numpy()
    woff = 0
    for (cin, cout), w, parts in zip(chans, ws, want):
        full, woff = _wgmma_stage(wq, woff, cin, cout, terms, ntl)
        for s in range(terms):
            np.testing.assert_array_equal(full[s, :cout, :cin], parts[s].float().numpy())
        assert (full[:, cout:] == 0).all() and (full[:, :, cin:] == 0).all()
        if kind == "split_f16":
            inv = parts[2].numpy()[:, None, None, None]
            back = (full[0, :cout, :cin] + full[1, :cout, :cin] * 2.0 ** -11) * inv
            np.testing.assert_allclose(back, w.numpy(), rtol=2.0 ** -21, atol=0)
    assert woff == wq.size


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


@pytest.mark.parametrize("chans", [[(46, 48), (48, 48), (48, 46), (20, 56)],
                                   [(5, 7), (7, 24), (24, 16), (16, 8)]])
def test_pack_chain_f16_sizes_match_kernel_offsets(rng, chans):
    """At every depth 1-4 the kernel finds stage k's weights after
    9 * kchunks * 16 * 2 * ntl * chunks 16-byte units per earlier stage
    (csrc/conv_chain.cu wg_stage, ntl = 6 however narrow the chain: the
    second one's stages are all narrower), each stage read back in full by
    _wgmma_stage from that offset, and its scales and biases after
    2 * 8 * ntiles floats per earlier stage."""
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32)) for ci, co in chans]
    for depth in range(1, 5):
        wq, sb = conv_chain.pack_chain_f16(ws[:depth], [None] * depth)
        units = _wgmma_units(chans[:depth], 2)
        assert wq.numel() == sum(units) * 8  # 8 halves per 16 bytes
        assert sb.numel() == sum(2 * 8 * -(-co // 8) for _, co in chans[:depth])
        ntl, woff, flat = conv_chain._NT_CHUNK, 0, wq.float().numpy()
        for (ci, co), u in zip(chans[:depth], units):
            start = woff
            full, woff = _wgmma_stage(flat, woff, ci, co, 2, ntl)
            assert woff - start == u * 8 and not np.isnan(full).any()


def _tail_units_2byte(wq, cin, nch, terms):
    """A wgmma tail pack (float32 copy of its values) read unit by unit as
    the kernel streams it (csrc/tail.cu: unit (step, tap) is kc k-steps of
    an N x 16 B operand, N = 48 terms, at (step * 9 + tap) units from the
    start; core matrix (term, column group, k-half) of 8 columns x 8 k)
    back to OIHW terms [terms, steps * 48, kc * 16, 3, 3]."""
    kc, steps = -(-cin // 16), -(-nch // 48)
    unit = kc * 48 * terms * 16
    assert wq.size == steps * 9 * unit
    full = np.full((terms, steps * 48, kc * 16, 3, 3), np.nan, np.float32)
    for step in range(steps):
        for tap in range(9):
            u = wq[(step * 9 + tap) * unit:][:unit].reshape(kc, terms, 6, 2, 8, 8)
            # [k-chunk, term, column group, k-half, column, k] -> [term, channel, input]
            full[:, step * 48:(step + 1) * 48, :, tap // 3, tap % 3] = (
                u.transpose(1, 2, 4, 0, 3, 5).reshape(terms, 48, kc * 16))
    return full


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("chans", CHAIN_PACK_CHANS)
def test_pack_chain_2byte_layout(rng, chans, dtype):
    """The wgmma kernel of fast16 (f16) and fast (bf16) reads each stage's
    weights once, rounded to the dtype as conv_chain.rounded rounds them
    (saturating into f16), as N x 16 B operands in the f16 pack's order
    with one term (N = 8 ntl): [chunk][ky][kx][k-chunk][group of 8 output
    channels][k-half][8 channels][8 k], zero in the pads of cin (to 16s)
    and cout (to whole chunks). Then per stage a scale of 1 per channel and
    the bias rounded to the dtype, zero in the pad and where it is
    missing."""
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32) * 0.05) for ci, co in chans]
    ws[0][0, 0, 1, 1] = 1e5  # past f16's range: the f16 pack saturates it
    bs = [torch.from_numpy(rng.randn(co).astype(np.float32)) for _, co in chans]
    bs[-1] = None
    wq, sb = conv_chain.pack_chain_2byte(ws, bs, dtype)
    assert wq.dtype == dtype and sb.dtype == torch.float32
    wr, br = conv_chain.rounded(ws, bs, dtype)
    assert float(wr[0][0, 0, 1, 1]) == (65504.0 if dtype == torch.float16 else 99840.0)
    ntl = conv_chain._NT_CHUNK
    wq, sb = wq.float().numpy(), sb.numpy()
    woff = soff = 0
    for w, b, (cin, cout) in zip(wr, br, chans):
        kc, nt = -(-cin // 16), -(-cout // 8)
        nch = -(-nt // ntl)
        full = np.zeros((nch * ntl * 8, kc * 16, 3, 3), np.float32)
        full[:cout, :cin] = w.numpy()
        want = full.reshape(nch, ntl, 8, kc, 2, 8, 3, 3).transpose(0, 6, 7, 3, 1, 4, 2, 5)
        np.testing.assert_array_equal(wq[woff:woff + want.size], want.reshape(-1))
        woff += want.size
        assert (sb[soff:soff + nt * 8] == 1).all()
        want_b = np.zeros(nt * 8, np.float32)
        if b is not None:
            want_b[:cout] = b.numpy()
        np.testing.assert_array_equal(sb[soff + nt * 8:soff + 2 * nt * 8], want_b)
        soff += 2 * nt * 8
    assert woff == wq.size and soff == sb.size


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_pack_chain_2byte_sizes_match_kernel_offsets(rng, dtype):
    """Under one product the kernel finds stage k's weights after
    9 * kchunks * 16 * ntl * chunks units of 16 bytes per earlier stage,
    half the split pack's, and its scales and biases after 2 * 8 * ntiles
    floats, as under two (csrc/conv_chain.cu wg_stage), at every depth 1-4."""
    chans = [(46, 48), (48, 48), (48, 46), (20, 56)]
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32)) for ci, co in chans]
    for depth in range(1, 5):
        wq, sb = conv_chain.pack_chain_2byte(ws[:depth], [None] * depth, dtype)
        assert wq.numel() == sum(_wgmma_units(chans[:depth], 1)) * 8  # 8 values a unit
        assert sb.numel() == sum(2 * 8 * -(-co // 8) for _, co in chans[:depth])
        f16 = conv_chain.pack_chain_f16(ws[:depth], [None] * depth)
        assert 2 * wq.numel() == f16[0].numel() and sb.numel() == f16[1].numel()


@pytest.mark.parametrize("kernel,variant", [
    ("chain", v) for v in ("base", "nomma", "noepi", "nofetch", "nowindow", "noout", "wg1")] + [
    (k, v) for k in ("tail", "tail_ring")
    for v in ("base", "nomma", "noepi", "norelay", "noout", "wg1")] + [
    ("chain_tf32", v) for v in ("base", "noload", "nomma", "wg1", "kgunit")] + [
    ("tail_tf32", v) for v in ("base", "noload", "nomma", "wg1", "kgunit")])
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


@pytest.mark.parametrize("chans", [[(46, 48), (48, 48), (48, 46)], [(5, 7)], [(20, 56), (56, 20)]])
def test_pack_chain_wgmma_tf32_stages(rng, chans):
    """The split-TF32 chain's pack read back stage by stage as the kernel
    addresses it (csrc/conv_chain.cu stage32_of: steps of 6 n-tiles x 9
    taps x kc k-chunks x 2 k-steps x hi and lo B operands of [column group
    j][k-half h][8 columns n][4 k], k-step 2c + s taking input channel
    16c + 4k + 2s + h) is each stage's TF32 split of its weights, zero in
    every pad; then per stage the bias padded with zeros to whole n-tiles;
    a missing bias packs as zeros."""
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32) * 0.05) for ci, co in chans]
    bs = [torch.from_numpy(rng.randn(co).astype(np.float32)) for _, co in chans]
    bs[-1] = None
    wq, bq = conv_chain.pack_chain_wgmma_tf32(ws, bs)
    assert wq.dtype == bq.dtype == torch.float32
    woff = boff = 0
    for w, b, (cin, cout) in zip(ws, bs, chans):
        kc, steps = -(-cin // 16), -(-cout // 48)
        n = steps * 9 * kc * 2 * 2 * 48 * 8
        # [step, tap, k-chunk, s, term, j, h, n, k] -> [term, step, j, n, tap, k-chunk, k, s, h]
        v = wq[woff:woff + n].numpy().reshape(steps, 9, kc, 2, 2, 6, 2, 8, 4)
        full = v.transpose(4, 0, 5, 7, 1, 2, 8, 3, 6).reshape(2, steps * 48, 9, kc * 16)
        for term, want in enumerate(a.numpy() for a in conv_chain.split_tf32(w)):
            np.testing.assert_array_equal(full[term, :cout, :, :cin],
                                          want.reshape(cout, cin, 9).transpose(0, 2, 1))
        assert (full[:, cout:] == 0).all() and (full[:, :, :, cin:] == 0).all()
        woff += n
        nt8 = -(-cout // 8) * 8
        want_b = np.zeros(nt8, np.float32)
        if b is not None:
            want_b[:cout] = b.numpy()
        np.testing.assert_array_equal(bq[boff:boff + nt8].numpy(), want_b)
        boff += nt8
    assert woff == wq.numel() and boff == bq.numel()


# the zoo's upsampler widths (40, 42, 50, 64 -> 48) and RLFN's 46, r = 4; and
# widths whose conv channels (27, 12) are no multiples of 8
TAIL32_CASES = [(40, 3, 4), (42, 3, 4), (46, 3, 4), (50, 3, 4), (64, 3, 4), (24, 3, 3), (5, 3, 2)]


@pytest.mark.parametrize("cin,cout,r", TAIL32_CASES)
def test_pack_tail_wgmma_tf32_units(rng, cin, cout, r):
    """pack_tail_wgmma_tf32 read unit by unit as the kernel streams it
    through its ring (unit (step, tap) at (step * 9 + tap) units, 2 kc
    k-steps of hi and lo 48 x 8 operands, [column group][k-half][8 columns]
    [4 k], k-step 2c + s taking input channel 16c + 4k + 2s + k-half) is
    the TF32 split of the weights with the output channels in shuffled
    order (i, j, c), zero in every pad; then the bias in that order."""
    _, w, b = _tail_case(rng, cin, cout, r)
    nch = cout * r * r
    kc, steps = -(-cin // 16), -(-nch // 48)
    order = tail.shuffled_order(cout, r)
    wq, bq = tail.pack_tail_wgmma_tf32(w, b, r)
    unit = 2 * kc * 2 * 48 * 8
    assert wq.numel() == steps * 9 * unit
    # the plan's unit, where cin takes the per-tap form (not the folded one)
    assert tail.folded(cin) or 4 * unit == tail.wgmma_plan(cin, cout, r, torch.float32)["unit"]
    v = wq.numpy().reshape(steps, 9, kc, 2, 2, 6, 2, 8, 4)  # [.., k-chunk, s, term, j, h, n, k]
    # -> [term, step, j, n, tap, k-chunk, k, s, h]: input channel 16c + 4k + 2s + h
    full = v.transpose(4, 0, 5, 7, 1, 2, 8, 3, 6).reshape(2, steps * 48, 9, kc * 16)
    hi, lo = (a.numpy() for a in conv_chain.split_tf32(w[order]))
    for term, want in enumerate((hi, lo)):
        np.testing.assert_array_equal(full[term, :nch, :, :cin], want.reshape(nch, cin, 9)
                                      .transpose(0, 2, 1))
    assert (full[:, nch:] == 0).all() and (full[:, :, :, cin:] == 0).all()
    nt8 = -(-nch // 8) * 8
    np.testing.assert_array_equal(bq.numpy()[:nch], b[order].numpy())
    assert bq.numel() == nt8 and (bq[nch:] == 0).all()
    assert (tail.pack_tail_wgmma_tf32(w, None, r)[1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,r", TAIL32_CASES)
def test_pack_tail_wgmma_2byte_units(rng, cin, cout, r, dtype):
    """pack_tail_wgmma_2byte read unit by unit as the kernel reads it
    (resident, or streamed through its ring; _tail_units_2byte) is the
    weights rounded to the dtype with the output channels in shuffled order
    (i, j, c), zero in every pad; a unit is the plan's (wgmma_plan) bytes;
    then a scale of 1 per channel and the rounded bias in that order, zero
    in the pad and where it is missing."""
    _, w, b = _tail_case(rng, cin, cout, r)
    nch = cout * r * r
    order = tail.shuffled_order(cout, r)
    wq, sb = tail.pack_tail_wgmma_2byte(w, b, r, dtype)
    assert wq.dtype == dtype and sb.dtype == torch.float32
    (wr,), (br,) = conv_chain.rounded([w[order]], [b[order]], dtype)
    full = _tail_units_2byte(wq.float().numpy(), cin, nch, 1)
    assert wq.numel() * 2 == -(-nch // 48) * 9 * tail.wgmma_plan(cin, cout, r, dtype,
                                                                 dtype)["unit"]
    np.testing.assert_array_equal(full[0, :nch, :cin], wr.numpy())
    assert (full[0, nch:] == 0).all() and (full[0, :, cin:] == 0).all()
    nt8 = -(-nch // 8) * 8
    assert sb.numel() == 2 * nt8 and (sb[:nt8] == 1).all()
    np.testing.assert_array_equal(sb[nt8:nt8 + nch].numpy(), br.numpy())
    assert (sb[nt8 + nch:] == 0).all()
    assert (tail.pack_tail_wgmma_2byte(w, None, r, dtype)[1][nt8:] == 0).all()


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


def _chain_wgmma(x, ws, bs, slope, residual, tier):
    """The wgmma chain kernel's arithmetic on the CPU, from its packs under
    ``tier`` (fasthi16: the split f16 pack, two products; fast16, fast:
    the one-term pack rounded to the dtype, one): the B operands read back
    by the kernel's addressing (_wgmma_stage); per stage the products in
    f32, summed k-step by k-step in the kernel's order (tap, then k-chunk,
    16 products each); the epilogue of csrc/common.cuh epilogue_value
    ((hi + lo * 2^-11) / S + bias, or the sum rounded to the dtype and then
    + the rounded bias), f16's saturation, the store's rounding and
    LeakyReLU with the slope rounded to the dtype; zero padding between the
    stages; then + x in f32, rounded once."""
    nm = config._MODES[tier]
    dt, products = nm.activation_dtype, 2 if tier == "fasthi16" else 1
    _, pack = conv_chain.layout(dt, nm.compute_dtype)
    wq, sb = pack(ws, bs)
    wq = wq.float().numpy()
    slope_t = torch.tensor(slope).to(dt).float()
    h, woff, soff = x, 0, 0
    for w in ws:
        y, woff, soff = _wgmma_conv(h, wq, sb, woff, soff, int(w.shape[0]), products, dt)
        h = torch.where(y < 0, (y.float() * slope_t).to(dt), y)
    return (h.float() + x.float()).to(dt) if residual else h


def _wgmma_conv(h, wq, sb, woff, soff, cout, products, dt):
    """One stage of a wgmma kernel (the chain's or the tail's) on the CPU:
    its B operands read back from the pack ``wq`` (float32 copy) from
    ``woff`` on by the kernel's addressing (_wgmma_stage), its scales and
    biases from ``sb`` from ``soff`` on; the products in f32, summed k-step
    by k-step in the kernel's order (tap, then k-chunk, 16 products each);
    the epilogue of csrc/common.cuh epilogue_value ((hi + lo * 2^-11) / S
    + bias, or the sum rounded to the dtype and then + the rounded bias),
    f16's saturation and the store's rounding. Returns the stage's output
    (NCHW, ``dt``) and the offsets after the stage."""
    n, cin, hh, ww = h.shape
    kc, nt = -(-cin // 16), -(-cout // 8)
    full, woff = _wgmma_stage(wq, woff, cin, cout, products, conv_chain._NT_CHUNK)
    inv, bias = sb[soff:soff + cout], sb[soff + nt * 8:soff + nt * 8 + cout]
    hp = torch.zeros(n, kc * 16, hh + 2, ww + 2)
    hp[:, :cin, 1:-1, 1:-1] = h.float()
    acc = [torch.zeros(n * hh * ww, cout) for _ in range(products)]
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        patch = hp[:, :, ky:ky + hh, kx:kx + ww].permute(0, 2, 3, 1).reshape(-1, kc * 16)
        for c in range(kc):
            a = patch[:, 16 * c:16 * c + 16]
            for t in range(products):
                acc[t] = acc[t] + a @ torch.from_numpy(full[t, :cout, 16 * c:16 * c + 16,
                                                            ky, kx]).T
    if products == 2:
        v = (acc[0] + acc[1] * 2.0 ** -11) * inv + bias
    else:
        v = acc[0].to(dt).float() + bias
    if dt == torch.float16:
        v = v.clamp(-65504.0, 65504.0)
    y = v.to(dt).reshape(n, hh, ww, cout).permute(0, 3, 1, 2)
    return y, woff, soff + 2 * nt * 8


@pytest.mark.parametrize("tier", ["fasthi16", "fast16", "fast"])
@pytest.mark.parametrize("shape,chans,residual", [
    ((1, 20, 18, 46), [(46, 48), (48, 48), (48, 46)], True),
    ((1, 13, 17, 5), [(5, 7), (7, 5)], True),
    ((1, 11, 9, 16), [(16, 56), (56, 24)], False)])
def test_chain_wgmma_arithmetic_matches_plain(rng, tier, shape, chans, residual):
    """The wgmma kernel's arithmetic (_chain_wgmma, decoded from its packs)
    agrees with the plain version under the tier: both round the same
    f32-grade (fasthi16) or exact-product (fast16, fast) sums, in another
    order, so a store may round the other way and the next stage carries
    that one-ulp flip on: at most 4 ulps of the dtype anywhere and an
    eighth of one on average (the bar of
    test_chain_plain_matches_unfused_jax_storage_tiers). Under fasthi16 the
    same holds against the unfused JAX graph at RLFN's widths. The first
    stage alone, which no flip feeds, differs in under 1% of its values: a
    lost lo term flips about 40% there, and a bias added inside the sum's
    rounding, or a pack read in the wrong order, fails the bars above."""
    x, ws, bs = _chain_case(rng, shape, chans)
    dt = config._MODES[tier].activation_dtype
    ulp = 2.0 ** -10 if dt == torch.float16 else 2.0 ** -7
    xt = _t(x * 8).to(dt)
    wt, bt = [_oihw(w) for w in ws], [torch.from_numpy(b) for b in bs]
    emu = _chain_wgmma(xt, wt, bt, 0.05, residual, tier)
    with config.numerics_mode(tier):
        plain = conv_chain.fused_conv3x3_chain(xt, wt, bt, slope=0.05, residual=residual)
    assert emu.dtype == plain.dtype == dt and emu.shape == plain.shape
    others = [_n(plain)]
    if tier == "fasthi16" and chans[0] == (46, 48):
        with jconfig.numerics_mode(tier):
            hj = jnp.asarray(_n(xt).astype(np.float16))
            for w, b in zip(ws, bs):
                hj = jops.leaky_relu(jops.conv2d(hj, jnp.asarray(w), jnp.asarray(b)), 0.05)
            others.append(np.asarray(hj + jnp.asarray(_n(xt).astype(np.float16))).astype(np.float32))
    for other in others:
        d = np.abs(_n(emu) - other)
        assert (d <= 4 * ulp * np.maximum(np.abs(other), 1.0)).all(), d.max()
        assert d.mean() < ulp / 8 * np.abs(other).mean() + 1e-4, d.mean()
    one = _chain_wgmma(xt, wt[:1], bt[:1], 0.05, False, tier)
    with config.numerics_mode(tier):
        ref = conv_chain.fused_conv3x3_chain(xt, wt[:1], bt[:1], slope=0.05, residual=False)
    assert float((one != ref).float().mean()) < 1e-2


# (cin, cout, r) of the wgmma tail's tests: RLFN's upsampler, SCET's 64 -> 64
# (two steps of 48 channels), m_RFDN's x2 upsampler 24 -> 96 (two full
# steps) and a narrow 5 -> 12 (one step, mostly pad)
TAIL_WGMMA_CASES = [(46, 3, 4), (64, 4, 4), (24, 24, 2), (5, 3, 2)]


@pytest.mark.parametrize("kind", ["split_f16", "float16", "bfloat16"])
@pytest.mark.parametrize("cin,cout,r", TAIL_WGMMA_CASES)
def test_tail_wgmma_pack_round_trip(rng, kind, cin, cout, r):
    """The wgmma tail's packs (the one-group 2-byte layouts of
    ``tail.layout``) read back by the kernel's own addressing (_wgmma_stage:
    steps of 6 n-tiles, a step's tap k-chunk an N x 16 B operand of core
    matrices) are the OIHW weights with the conv's channels in the shuffled
    order k' = (i r + j) cout + c: the split f16 pack its hi and lo terms
    (w * S = w_hi + w_lo * 2^-11 to 2^-22 relative), the f16 and bf16 packs
    the weights rounded to the dtype; zero in every pad (cin to 16s, the
    channels to whole steps), nothing after; then 1/S (1 under one
    product) and the bias in the shuffled order, padded to whole n-tiles."""
    _, w, b = _tail_case(rng, cin, cout, r)
    nch = cout * r * r
    order = tail.shuffled_order(cout, r)
    ws, bs = w[order], b[order]
    tier = {"split_f16": "fasthi16", "float16": "fast16", "bfloat16": "fast"}[kind]
    nm = config._MODES[tier]
    key, pack = tail.layout(nm.activation_dtype, r, nm.compute_dtype)
    assert key.startswith("wgmma_tail_") and key.endswith(f"_r{r}")
    wq, sb = pack([w], [b])
    if kind == "split_f16":
        terms, want = 2, conv_chain.split_f16(ws)
        assert torch.equal(wq, tail.pack_tail_wgmma_f16(w, b, r)[0])
    else:
        terms, want = 1, conv_chain.rounded([ws], [bs], getattr(torch, kind))[0]
        assert wq.dtype == getattr(torch, kind)
    full, woff = _wgmma_stage(wq.float().numpy(), 0, cin, nch, terms, conv_chain._NT_CHUNK)
    assert woff == wq.numel() == 9 * -(-cin // 16) * 16 * -(-nch // 48) * 48 * terms
    for t in range(terms):
        np.testing.assert_array_equal(full[t, :nch, :cin], want[t].float().numpy())
    assert (full[:, nch:] == 0).all() and (full[:, :, cin:] == 0).all()
    nt8 = -(-nch // 8) * 8
    sb = sb.numpy()
    assert sb.size == 2 * nt8 and (sb[nch:nt8] == 1).all() and (sb[nt8 + nch:] == 0).all()
    if kind == "split_f16":
        inv = want[2].numpy()
        np.testing.assert_array_equal(sb[:nch], inv)
        back = (full[0, :nch, :cin] + full[1, :nch, :cin] * 2.0 ** -11) * inv[:, None, None, None]
        np.testing.assert_allclose(back, ws.numpy(), rtol=2.0 ** -21, atol=0)
        np.testing.assert_array_equal(sb[nt8:nt8 + nch], bs.numpy())
    else:
        assert (sb[:nt8] == 1).all()
        np.testing.assert_array_equal(sb[nt8:nt8 + nch],
                                      bs.to(getattr(torch, kind)).float().numpy())


def _tail_wgmma(x, w, b, r, tier):
    """The wgmma tail's arithmetic on the CPU under ``tier``, from the packs
    it reads (one stage of _wgmma_conv on the channels in shuffled order),
    the result's channels put back in torch's order and shuffled."""
    nm = config._MODES[tier]
    dt, products = nm.activation_dtype, 2 if tier == "fasthi16" else 1
    _, pack = tail.layout(dt, r, nm.compute_dtype)
    wq, sb = pack([w], [b])
    nch = int(w.shape[0])
    y, woff, soff = _wgmma_conv(x, wq.float().numpy(), sb, 0, 0, nch, products, dt)
    assert woff == wq.numel() and soff == sb.numel()
    conv = torch.empty_like(y)
    conv[:, tail.shuffled_order(nch // (r * r), r)] = y
    return torch.nn.functional.pixel_shuffle(conv, r)


@pytest.mark.parametrize("tier", ["fasthi16", "fast16", "fast"])
@pytest.mark.parametrize("cin,cout,r", TAIL_WGMMA_CASES[:3])
def test_tail_wgmma_arithmetic_matches_plain_and_pallas(rng, interpret_pallas, tier, cin, cout,
                                                         r):
    """The wgmma tail's arithmetic (_tail_wgmma: fresh f32 sums over the
    whole conv, k-step by k-step, from its packs; under fasthi16 the split
    terms, under fast16 and fast the sum rounded to the dtype before the
    rounded bias) agrees with the plain version under the tier and with the
    JAX Pallas kernel run in interpret mode on the same operands (the f32
    weights and bias under fasthi16, its output rounded once to f16; the
    weights rounded to the dtype and no bias under fast16 and fast, its sums
    then rounded, the rounded bias added and rounded again): both round the
    same f32 sums, taken in another order, so a value may round the other
    way: one ulp of the dtype at most, in under 1% of the values. A lost lo
    term or a bias added inside the sum's rounding flips far more."""
    from ntire2022_esr_tpu.ops.pallas import fused_conv3x3_pixelshuffle as pallas_tail

    nm = config._MODES[tier]
    dt = nm.activation_dtype
    x, w, b = _tail_case(rng, cin, cout, r, hw=(9, 11))
    x = x.to(dt).contiguous(memory_format=torch.channels_last)
    emu = _tail_wgmma(x, w, b, r, tier)
    with config.numerics_mode(tier):
        plain = tail.fused_conv3x3_pixelshuffle(x, w, b, r=r)
    xs = _n(x)
    ulp = 2.0 ** -10 if dt == torch.float16 else 2.0 ** -7
    if tier == "fasthi16":
        ref = np.asarray(pallas_tail(jnp.asarray(xs), jnp.asarray(w.permute(2, 3, 1, 0).numpy()),
                                     jnp.asarray(b.numpy()), r=r))
        ref = torch.from_numpy(np.clip(ref, -65504.0, 65504.0)).to(dt)
        sums = torch.zeros(ref.shape)  # one rounding: one ulp of the output
    else:
        (wr,), (br,) = conv_chain.rounded([w], [b], dt)
        sums = torch.from_numpy(np.array(pallas_tail(
            jnp.asarray(xs), jnp.asarray(wr.permute(2, 3, 1, 0).numpy()),
            jnp.zeros(wr.shape[0], jnp.float32), r=r)))
        # the bias of output (r y + i, r x + j, c) is that of conv channel c r r + i r + j
        n_, hh, ww, co = sums.shape
        bias = br.reshape(co, r, r).permute(1, 2, 0)[None, None, :, None, :, :]
        y = (sums.to(dt).float().reshape(n_, hh // r, r, ww // r, r, co) + bias).reshape(sums.shape)
        ref = (y.clamp(-65504.0, 65504.0) if dt == torch.float16 else y).to(dt)
    assert emu.dtype == plain.dtype == dt and emu.shape == plain.shape
    for other in (ops.to_nhwc(plain), ref):
        e, o = ops.to_nhwc(emu).float(), other.float()
        d = (e - o).abs()
        # a flip of the sum's rounding (two roundings: one ulp of the sum
        # before the bias) or of the output's
        assert bool((d <= ulp * (o.abs().clamp_min(1.0) + sums.abs())).all()), float(d.max())
        assert float((d > 0).float().mean()) < 1e-2


@pytest.mark.parametrize("tier", ["fasthi16", "fast16", "fast"])
def test_tail_wgmma_packs_have_keys_of_their_own(rng, tier):
    """A wgmma tail pack (key ``wgmma_tail_<path>_r<r>``) is never served to
    a launch at another r, to the split-TF32 tail (per tap or folded) or to
    the chain, nor their packs of the same tensors to it: each key packs
    once, its own layout, and each launch counts against the kernel that
    its path names (``wgmma``; the split-TF32 paths ``wgmma_tf32``)."""
    nm = config._MODES[tier]
    dt, c = nm.activation_dtype, nm.compute_dtype
    _, w, b = _tail_case(rng, 52, 52, 2)
    keys = {r: tail.layout(dt, r, c)[0] for r in (2, 4)}
    others = {tail.layout(torch.float32, 2, cin=52)[0], tail.layout(torch.float32, 2, cin=3)[0],
              conv_chain.layout(dt, c)[0]}
    assert all(k.startswith("wgmma_tail_") for k in keys.values())
    assert len(set(keys.values()) | others) == 5
    before = conv_chain.packs
    got = tail.packed_weights(keys[2], [w], [b], tail.layout(dt, 2, c)[1])
    tf32 = tail.packed_weights(tail.layout(torch.float32, 2, cin=52)[0], [w], [b],
                               tail.layout(torch.float32, 2, cin=52)[1])
    again = tail.packed_weights(keys[2], [w], [b], tail.layout(dt, 2, c)[1])
    assert conv_chain.packs == before + 2 and again is got
    if tier == "fasthi16":
        assert torch.equal(got[0], tail.pack_tail_wgmma_f16(w, b, 2)[0])
    else:
        assert torch.equal(got[0], tail.pack_tail_wgmma_2byte(w, b, 2, dt)[0])
    assert torch.equal(tf32[0], tail.pack_tail_wgmma_tf32(w, b, 2)[0])
    assert got[0].dtype != tf32[0].dtype
    assert tail.kernel_of(conv_chain.path(nm)) == "wgmma"
    assert tail.kernel_of(conv_chain.PATHS[torch.float32]) == "wgmma_tf32"
    assert set(tail.launches_by_kernel) == {"wgmma", "wgmma_tf32"}


@pytest.mark.parametrize("tier", ["fast16", "fast"])
@pytest.mark.parametrize("chans", [[(5, 7), (7, 5)], [(20, 24), (24, 20)]])
def test_chain_check_references(rng, tier, chans):
    """The references that chip_smoke.py's phase 2 holds the chain to at
    other widths than RLFN's (tools/chain_check.py): the plain version on
    the widths zero-padded to 16s computes the same chain (the pad's
    outputs are zero), and the f64 sums rounded as the tier rounds (twice,
    the bias between) differ from the plain version's f32 sums in under 1%
    of the values, while the control with the bias inside one rounding
    differs from both at least 10 times as often."""
    from ntire2022_esr_tpu_torch.tools import chain_check

    x, ws, bs = _chain_case(rng, (2, 13, 11, chans[0][0]), chans)
    dt = config._MODES[tier].activation_dtype
    xt = _t(x * 16).to(dt)
    wt, bt = [_oihw(w) for w in ws], [torch.from_numpy(b) for b in bs]
    with config.numerics_mode(tier):
        plain = conv_chain.conv3x3_chain_plain(xt, wt, bt)
        pad = chain_check.padded_chain_plain(xt, wt, bt, 0.05, True)
        exact = chain_check.exact_chain_two_byte(xt, wt, bt, 0.05, True, dt)
        one = chain_check.one_rounding("chain", wt, bt)(xt)
        first = chain_check.exact_chain_two_byte(xt, wt[:1], bt[:1], 0.05, False, dt)
        first_plain = conv_chain.conv3x3_chain_plain(xt, wt[:1], bt[:1], residual=False)
    assert pad.dtype == exact.dtype == dt and pad.shape == exact.shape == plain.shape
    rate = lambda a, b: float((a != b).float().mean())  # noqa: E731
    assert rate(pad, plain) < 1e-2 and rate(exact, plain) < 1e-2
    assert rate(first, first_plain) < 1e-2
    assert rate(one, plain) >= 10 * max(rate(exact, plain), 1e-3)
    assert rate(one, exact) >= 10 * max(rate(exact, plain), 1e-3)


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
    wq, bq = tail.pack_tail_wgmma_tf32(w, b, r)
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
        assert "tf32" in changed[0][1] and "<__nv_bfloat16, 1>" in changed[0][1], fname


def test_packed_weights_keys_tf32(rng):
    """The wrappers pack f16 and TF32 layouts under distinct cache keys: the
    same weights pack once per layout, and parity and fasthi share the
    TF32 one (the same packed terms, 3 or 2 products at run time), the
    split-TF32 wgmma kernel's (``pack_chain_wgmma_tf32``)."""
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
    assert torch.equal(got[torch.float32][0], conv_chain.pack_chain_wgmma_tf32(ws, bs)[0])
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
