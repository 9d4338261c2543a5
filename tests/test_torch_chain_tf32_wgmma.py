"""The chain's split-TF32 path on warpgroup MMA (``csrc/conv_chain.cu``
``conv3x3_chain_wgmma_tf32_kernel``) on the CPU: its pack read back by the
kernel's own addressing, its arithmetic emulated from the pack against the
plain version and the JAX package's Pallas chain, its cache key, and the
plan that gives every width the kernel. The kernel itself runs only on the
card (``chip_smoke.py`` phase 2)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu.ops.pallas import fused_conv3x3_chain as pallas_chain
from ntire2022_esr_tpu_torch import config, ops
from ntire2022_esr_tpu_torch.ops.kernels import build, conv_chain, tail
from ntire2022_esr_tpu_torch.tools.chain_check import CHAIN_WIDTHS

NT = conv_chain._NT_CHUNK  # n-tiles of 8 output channels a step
STEP_FLOATS = 8 * NT * 8  # one k-step's B operand of one term: 48 columns x 8 values
RLFN = (46, 48, 48, 46)


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    yield


def _stage_floats(cin, cout):
    """Floats of one stage's pack: its steps x 9 taps x units of 2 kc
    k-steps x hi, lo (csrc/conv_chain.cu stage32_of, woff)."""
    return -(-cout // (8 * NT)) * 9 * 2 * -(-cin // 16) * 2 * STEP_FLOATS


def _channel_of(kc):
    """The input channel of each (k-step s, position k, k-half e) of a tap:
    16 (s // 2) + 4 k + 2 (s % 2) + e, as csrc/wgmma_chain.cuh split_a gives
    a lane's A registers from its 16-byte loads."""
    s, k, e = np.meshgrid(np.arange(2 * kc), np.arange(4), np.arange(2), indexing="ij")
    return 16 * (s // 2) + 4 * k + 2 * (s % 2) + e


def _decode_stage(v, cin, cout):
    """One stage's TF32 terms (2, cout, cin, 3, 3) read from its pack ``v``
    by the kernel's addressing: unit (step, tap) at (9 step + tap) units of
    2 kc k-steps x [hi, lo] x [group of 8 columns][k-half][8 columns][4 k];
    column 8 group + c of step is output channel 48 step + 8 group + c.
    Asserts that every input channel lies at exactly one K position and
    that the pads are zero."""
    kc, steps = -(-cin // 16), -(-cout // (8 * NT))
    assert v.size == _stage_floats(cin, cout)
    # [step, tap, k-step, term, group, k-half, column, k] -> [term, channel, tap, k-step, k, k-half]
    a = v.reshape(steps, 9, 2 * kc, 2, NT, 2, 8, 4).transpose(3, 0, 4, 6, 1, 2, 7, 5)
    a = a.reshape(2, steps * 8 * NT, 9, 2 * kc * 8)
    chan = _channel_of(kc).reshape(-1)
    assert sorted(chan.tolist()) == list(range(16 * kc))
    full = np.zeros((2, steps * 8 * NT, 16 * kc, 9), np.float32)
    full[:, :, chan, :] = a.transpose(0, 1, 3, 2)
    assert (full[:, cout:] == 0).all() and (full[:, :, cin:] == 0).all()
    return torch.from_numpy(full[:, :cout, :cin].reshape(2, cout, cin, 3, 3).copy())


def _weights(rng, chans, scale=0.05):
    ws = [torch.from_numpy(rng.randn(co, ci, 3, 3).astype(np.float32) * scale) for ci, co in chans]
    bs = [torch.from_numpy(rng.randn(co).astype(np.float32) * 0.1) for _, co in chans]
    return ws, bs


# RLFN's widths; odd and narrow ones; two steps a stage (56, 64 channels);
# a depth of 4; 112 channels, 7 k-chunks
PACK_CASES = [[(46, 48), (48, 48), (48, 46)], [(5, 7), (7, 5)], [(64, 56), (56, 64)],
              [(16, 40), (40, 32), (32, 8), (8, 16)], [(112, 112)]]


@pytest.mark.parametrize("chans", PACK_CASES)
def test_pack_chain_wgmma_tf32_layout(rng, chans):
    """The new pack, read back stage by stage by the kernel's addressing
    (stage offsets, units of (step, tap), k-steps, core matrices, hi and lo
    terms), is each stage's weights split into TF32 terms, every pad zero;
    then the biases, per stage padded with zeros to whole n-tiles (a
    missing bias packs as zeros). The layout's key serves this pack."""
    ws, bs = _weights(rng, chans)
    bs[-1] = None
    key, pack = conv_chain.layout(torch.float32)
    assert key == "wgmma_chain_tf32"
    wq, bq = pack(ws, bs)
    assert wq.dtype == bq.dtype == torch.float32
    assert torch.equal(wq, conv_chain.pack_chain_wgmma_tf32(ws, bs)[0])
    v, off, boff = wq.numpy(), 0, 0
    for w, b, (cin, cout) in zip(ws, bs, chans):
        n = _stage_floats(cin, cout)
        terms = _decode_stage(v[off:off + n], cin, cout)
        hi, lo = conv_chain.split_tf32(w)
        assert torch.equal(terms[0], hi) and torch.equal(terms[1], lo)
        off += n
        nt8 = -(-cout // 8) * 8
        want = torch.zeros(nt8) if b is None else torch.cat([b, torch.zeros(nt8 - cout)])
        assert torch.equal(bq[boff:boff + nt8], want)
        boff += nt8
    assert off == wq.numel() and boff == bq.numel()


def _emulate(x, chans, wq, bq, slope, residual, products):
    """The kernel's arithmetic from its pack: per stage and tap the products
    a_hi w_hi, a_hi w_lo (and a_lo w_hi under 3 products) summed in f32 from
    zero (the activations split as the kernel splits them in registers),
    the tap sums added in f32 in tap order, + bias, rounded to x's dtype,
    LeakyReLU with the slope rounded to it; zero padding between the
    stages; then + x in f32, rounded once."""
    conv = torch.nn.functional.conv2d
    h, off, boff = x, 0, 0
    for cin, cout in chans:
        n = _stage_floats(cin, cout)
        terms = _decode_stage(wq.numpy()[off:off + n], cin, cout)
        off += n
        b = bq[boff:boff + cout]
        boff += -(-cout // 8) * 8
        a = h.float()
        a_hi = conv_chain.round_tf32(a)
        a_lo = conv_chain.round_tf32(a - a_hi)
        if x.dtype == torch.bfloat16:
            assert bool((a_lo == 0).all())
        total = 0
        for tap in range(9):
            m = torch.zeros(3, 3)
            m[tap // 3, tap % 3] = 1
            wh, wl = terms[0] * m, terms[1] * m
            s = conv(a_hi, wh, padding=1) + conv(a_hi, wl, padding=1)
            if products == 3:
                s = s + conv(a_lo, wh, padding=1)
            total = total + s
        h = ops.nn.leaky_relu((total + b[None, :, None, None]).to(x.dtype), slope)
    return (h.float() + x.float()).to(x.dtype) if residual else h


def _magnitude(x, ws, bs, residual):
    """The chain on |x|, |w|, |b| with LeakyReLU off: a bound on the sum of
    the magnitudes of every output's terms at each stage, carried through."""
    h = x.abs().float()
    for w, b in zip(ws, bs):
        h = torch.nn.functional.conv2d(h, w.abs(), b.abs(), padding=1)
    return h + x.abs().float() if residual else h


# RLFN's widths at an image no 16x16 tile divides; widths whose stages pad
# to k-chunks and n-tiles; two steps a stage; a depth of 4 without residual
ARITH_CASES = [((1, 24, 20, 46), [(46, 48), (48, 48), (48, 46)], True),
               ((2, 11, 9, 5), [(5, 7), (7, 5)], True),
               ((1, 13, 17, 24), [(24, 56), (56, 24)], True),
               ((1, 12, 10, 16), [(16, 40), (40, 32), (32, 8), (8, 12)], False)]


@pytest.mark.parametrize("shape,chans,residual", ARITH_CASES)
def test_chain_wgmma_tf32_arithmetic_matches_plain_and_pallas(rng, interpret_pallas, shape, chans,
                                                             residual):
    """Under parity (f32 activations, 3 products) the new kernel's
    arithmetic, emulated from its pack, agrees with the plain version and
    with the JAX Pallas chain (interpret mode) within the f32 conv's own
    reordering error: 8 f32 ulps of the magnitude sum at each stage,
    carried through the chain (x depth), plus one of the output for the
    residual's rounding. One TF32 product a MAC is further off."""
    x = rng.randn(*shape).astype(np.float32) * 0.5
    ws, bs = _weights(rng, chans)
    xt = ops.from_nhwc(torch.from_numpy(x))
    wq, bq = conv_chain.pack_chain_wgmma_tf32(ws, bs)
    emu = _emulate(xt, chans, wq, bq, 0.05, residual, 3)
    with config.numerics_mode("parity"):
        plain = conv_chain.fused_conv3x3_chain(xt, ws, bs, slope=0.05, residual=residual)
    ref = np.asarray(pallas_chain(jnp.asarray(x), [jnp.asarray(w.permute(2, 3, 1, 0).numpy())
                                                   for w in ws],
                                  [jnp.asarray(b.numpy()) for b in bs], slope=0.05,
                                  residual=residual))
    bar = (len(ws) * 8 * 2.0 ** -24 * _magnitude(xt, ws, bs, residual)
           + 2.0 ** -24 * plain.abs())
    assert bool(((emu - plain).abs() <= bar).all()), float((emu - plain).abs().max())
    d = np.abs(ops.to_nhwc(emu).numpy() - ref)
    assert (d <= ops.to_nhwc(bar).numpy()).all(), d.max()
    one = _emulate(xt, chans, *conv_chain.pack_chain_wgmma_tf32(
        [conv_chain.round_tf32(w) for w in ws], bs), 0.05, residual, 2)
    assert float((one - plain).abs().max()) > float((emu - plain).abs().max())


@pytest.mark.parametrize("shape,chans", [((2, 24, 20, 46), [(46, 48), (48, 48), (48, 46)]),
                                         ((1, 13, 17, 24), [(24, 56), (56, 24)])])
def test_chain_wgmma_tf32_arithmetic_fasthi(rng, interpret_pallas, shape, chans):
    """Under fasthi (bf16 activations, 2 products) the emulated kernel
    rounds each stage's f32-grade sums to bf16 as the plain version does:
    they differ only where two sums straddle a rounding boundary, and the
    later stages carry a one-ulp flip on: at most 4 bf16 ulps anywhere and
    an eighth of one on average. The JAX Pallas chain (interpret mode,
    fasthi) keeps its stages in f32 and rounds once at the end, so it is
    held to twice those bars."""
    x = np.asarray(jnp.asarray(rng.randn(*shape).astype(np.float32) * 4).astype(jnp.bfloat16))
    ws, bs = _weights(rng, chans)
    xt = ops.from_nhwc(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))
    wq, bq = conv_chain.pack_chain_wgmma_tf32(ws, bs)
    emu = _emulate(xt, chans, wq, bq, 0.05, True, 2)
    with config.numerics_mode("fasthi"):
        plain = conv_chain.fused_conv3x3_chain(xt, ws, bs)
    with jconfig.numerics_mode("fasthi"):
        ref = np.asarray(pallas_chain(jnp.asarray(x), [jnp.asarray(w.permute(2, 3, 1, 0).numpy())
                                                       for w in ws],
                                      [jnp.asarray(b.numpy()) for b in bs])).astype(np.float32)
    assert emu.dtype == plain.dtype == torch.bfloat16
    ulp, e = 2.0 ** -7, ops.to_nhwc(emu).float().numpy()
    for other, k in ((ops.to_nhwc(plain).float().numpy(), 1), (ref, 2)):
        d = np.abs(e - other)
        assert (d <= k * 4 * ulp * np.maximum(np.abs(other), 1.0)).all(), d.max()
        assert d.mean() < k * ulp / 8 * np.abs(other).mean() + 1e-4, d.mean()


def test_chain_wgmma_tf32_pack_has_a_key_of_its_own(rng):
    """The new pack's key, ``wgmma_chain_tf32``, is shared by parity and
    fasthi (the same terms, 3 or 2 products at run time), packs once per
    weight set (int8 weights too, dequantized first), is the stages' per-tap
    operands one after the other, and is no key of any tail layout or of
    the chain's 2-byte layouts: no other layout is ever served to the
    kernel, nor its pack to another."""
    ws, bs = _weights(rng, [(46, 48), (48, 46)])
    keys = {conv_chain.layout(dt, c)[0] for dt, c in (
        (torch.float16, torch.float32), (torch.float16, torch.float16),
        (torch.bfloat16, torch.bfloat16))}
    tkeys = {tail.layout(dt, r, c, cin)[0] for dt, c in (
        (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
        (torch.float16, torch.float32)) for r in (2, 4) for cin in (3, 46)}
    key = conv_chain.layout(torch.float32)[0]
    assert key == conv_chain.layout(torch.bfloat16)[0] == "wgmma_chain_tf32"
    assert key != "mma_tf32" and key not in keys | tkeys
    before = conv_chain.packs
    first = conv_chain.packed_weights(key, ws, bs, conv_chain.layout(torch.float32)[1])
    again = conv_chain.packed_weights(key, ws, bs, conv_chain.layout(torch.bfloat16)[1])
    assert conv_chain.packs == before + 1 and first is again
    assert torch.equal(first[0], torch.cat([conv_chain.tap_operands(w) for w in ws]))
    scales = [torch.full((w.shape[0], w.shape[1], 1, 1), 0.01) for w in ws]
    q = [torch.round(w / s).clamp(-127, 127).to(torch.int8) for w, s in zip(ws, scales)]
    deq = [w.float() * s for w, s in zip(q, scales)]
    got = conv_chain.layout(torch.float32)[1](q, bs, scales)
    assert torch.equal(got[0], conv_chain.pack_chain_wgmma_tf32(deq, bs)[0])


def test_chain_plans_give_every_width_its_kernel():
    """Every split-TF32 tier's launch counts against the new kernel and
    every 2-byte tier's against the 2-byte wgmma kernel. RLFN's widths take
    the 16x16 tile with a ring of 3 units of 18,432 bytes and 7, 6 and 5
    m-blocks (230,144 of the 232,448 bytes a block may have), under f32
    and bf16 activations; every width of chain_check.CHAIN_WIDTHS has a
    plan under both, 160 -> 160 at the smallest tiles; so does every
    uniform width that the m16n8k8 kernel took (up to 144, 112, 96 and 80
    channels at depths 1 to 4), and no plan exceeds a block's limit."""
    for tier in ("parity", "high", "mixed", "fasthi"):
        assert conv_chain.kernel_of(conv_chain.path(config._MODES[tier])) == "wgmma_tf32"
    for tier in ("fasthi16", "fast16", "fast"):
        assert conv_chain.kernel_of(conv_chain.path(config._MODES[tier])) == "wgmma"
    assert set(conv_chain.launches_by_kernel) == {"wgmma", "wgmma_tf32"}
    for vb in (4, 2):
        plan = conv_chain.wgmma_tf32_plan(RLFN, vb)
        assert plan == {"tile": (16, 16), "nbuf": 3, "unit": 18432, "blocks": [7, 6, 5],
                        "bytes": 230144}
        for _, chans, _ in CHAIN_WIDTHS:
            widths = [chans[0][0]] + [co for _, co in chans]
            assert conv_chain.wgmma_tf32_plan(widths, vb) is not None, widths
        for depth, top in ((1, 144), (2, 112), (3, 96), (4, 80)):
            for c in range(1, top + 1):
                plan = conv_chain.wgmma_tf32_plan([c] * (depth + 1), vb)
                assert plan is not None and plan["bytes"] <= build.MAX_SMEM, (depth, c)
    assert conv_chain.wgmma_tf32_plan([160, 160], 4)["tile"] == (4, 4)
    assert conv_chain.wgmma_tf32_plan([160, 160], 2)["tile"] == (8, 8)
