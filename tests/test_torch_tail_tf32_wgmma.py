"""The tail's split-TF32 path on warpgroup MMA (``csrc/tail.cu``
``conv3x3_pixelshuffle_wgmma_tf32_kernel``) on the CPU: its packs read back
by the kernel's own addressing, its arithmetic emulated from them against
the plain version and the JAX package's Pallas tail, and its cache keys.
The kernel itself runs only on the card (``chip_smoke.py`` phase 3)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu.ops.pallas import fused_conv3x3_pixelshuffle as pallas_tail
from ntire2022_esr_tpu_torch import config, ops
from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail

NT = conv_chain._NT_CHUNK  # n-tiles of 8 conv channels a step
STEP_FLOATS = 8 * NT * 8  # one k-step's B operand of one term: 48 columns x 8 values


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    yield


def _case(rng, cin, cout, r, hw=(11, 9), n=2):
    """f32 activations with full mantissas (a_lo != 0), f32 weights and bias."""
    x = (rng.randn(n, cin, *hw) * 4).astype(np.float32)
    x *= 1 + rng.rand(*x.shape).astype(np.float32) * 1e-3
    w = rng.randn(cout * r * r, cin, 3, 3).astype(np.float32) * 0.05
    b = rng.randn(cout * r * r).astype(np.float32)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    return xt, torch.from_numpy(w), torch.from_numpy(b)


def _units(cin):
    """The kernel's units of one step as (k-steps a unit, units, the
    (tap, input channel) of each unit's K position or -1), as csrc/tail.cu
    wg_tail32 and split_a address them: per tap, k-step 2c + s of k-chunk c
    takes channel 16 c + 4 k + 2 s + h at position k of k-half h; folded,
    a unit is one k-step, and K index 8 u + 4 h + k is (tap, channel) =
    divmod(K, cin)."""
    if tail.folded(cin):
        ks, units = 1, -(-9 * cin // 8)
    else:
        ks, units = 2 * -(-cin // 16), 9
    tap = np.full((units, ks, 2, 4), -1)
    chan = np.full((units, ks, 2, 4), -1)
    for u in range(units):
        for s in range(ks):
            for h in range(2):
                for k in range(4):
                    if tail.folded(cin):
                        kk = 8 * u + 4 * h + k
                        if kk < 9 * cin:
                            tap[u, s, h, k], chan[u, s, h, k] = divmod(kk, cin)
                    else:
                        c = 16 * (s // 2) + 4 * k + 2 * (s % 2) + h
                        if c < cin:
                            tap[u, s, h, k], chan[u, s, h, k] = u, c
    return ks, units, tap, chan


def _decode(wq, cin, nch):
    """The TF32 terms (2, nch, cin, 3, 3) that the kernel reads from ``wq``
    ([step][unit][k-step][hi, lo][group of 8 columns][k-half][8 columns]
    [4 k]), and the unit of each weight; asserts every pad is zero and the
    pack has nothing past its last unit."""
    ks, units, tap, chan = _units(cin)
    steps = -(-nch // (8 * NT))
    v = wq.numpy()
    assert v.size == steps * units * ks * 2 * STEP_FLOATS
    # [term, step * 48 + 8 group + column, unit, k-step, k-half, k]
    v = v.reshape(steps, units, ks, 2, NT, 2, 8, 4).transpose(3, 0, 4, 6, 1, 2, 5, 7)
    v = v.reshape(2, steps * 8 * NT, units, ks, 2, 4)
    assert (v[:, nch:] == 0).all() and (v[:, :, tap < 0] == 0).all()
    out = np.zeros((2, nch, cin, 9), np.float32)
    unit_of = np.full((cin, 9), -1)
    for u, s, h, k in zip(*np.nonzero(tap >= 0)):
        t, c = tap[u, s, h, k], chan[u, s, h, k]
        assert unit_of[c, t] == -1  # each (tap, channel) once
        unit_of[c, t] = u
        out[:, :, c, t] = v[:, :nch, u, s, h, k]
    assert (unit_of >= 0).all()
    return torch.from_numpy(out.reshape(2, nch, cin, 3, 3)), unit_of.reshape(cin, 3, 3)


def _emulate(x, terms, unit_of, bias, cout, r, products):
    """The kernel's arithmetic from its packs: per unit (a tap, or a folded
    k-step of 8 (tap, channel) pairs) the products a_hi w_hi, a_hi w_lo (and a_lo w_hi under 3
    products) summed in f32 from zero, the unit sums added in f32 in unit
    order, + bias, rounded to x's dtype; the conv's channels (in shuffled
    order) put where the copy-out puts them."""
    conv = torch.nn.functional.conv2d
    a = x.float()
    a_hi = conv_chain.round_tf32(a)
    a_lo = conv_chain.round_tf32(a - a_hi)
    if x.dtype == torch.bfloat16:
        assert bool((a_lo == 0).all())
    total = 0
    for u in range(int(unit_of.max()) + 1):
        m = torch.from_numpy(unit_of == u).float()
        wh, wl = terms[0] * m, terms[1] * m
        s = conv(a_hi, wh, padding=1) + conv(a_hi, wl, padding=1)
        if products == 3:
            s = s + conv(a_lo, wh, padding=1)
        total = total + s
    y = (total + bias[None, :, None, None]).to(x.dtype)
    n, _, h, w = y.shape
    runs = y.reshape(n, r, r, cout, h, w)  # [n, i, j, c, y, x]
    return runs.permute(0, 3, 4, 1, 5, 2).reshape(n, cout, h * r, w * r)


def _packed(dt, cin, w, b, r):
    nm = config._MODES["parity" if dt == torch.float32 else "fasthi"]
    key, pack = tail.layout(dt, r, nm.compute_dtype, cin)
    return key, pack([w], [b])


# (cin, cout, r): the per-tap form at RLFN's width, the zoo's 64 -> 48 and
# SCET's 64 -> 64 (two steps), an x2 upsampler's 24 -> 96; the folded form
# at the zoo's 3 -> 48 and 3 -> 64 and at 5 -> 12, r = 2 (six k-steps)
PACK_CASES = [(46, 3, 4), (64, 3, 4), (64, 4, 4), (24, 24, 2), (3, 3, 4), (3, 4, 4), (5, 3, 2)]


@pytest.mark.parametrize("cin,cout,r", PACK_CASES)
def test_pack_tail_wgmma_tf32_layout(rng, cin, cout, r):
    """Each new pack, read back by the kernel's addressing, is the OIHW
    weights' TF32 hi and lo terms in the shuffled order
    ``k' = (i r + j) cout + c``, every (tap, channel) once and zero in
    every pad; then the bias in that order, padded to whole n-tiles. The
    layout's key names the form that cin takes."""
    _, w, b = _case(rng, cin, cout, r)
    nch = cout * r * r
    order = tail.shuffled_order(cout, r)
    key, (wq, bq) = _packed(torch.float32, cin, w, b, r)
    form = tail.pack_tail_wgmma_tf32_fold if tail.folded(cin) else tail.pack_tail_wgmma_tf32
    assert key == f"wgmma_tail_tf32{'_fold' if cin <= 16 else ''}_r{r}"
    assert torch.equal(wq, form(w, b, r)[0]) and wq.dtype == torch.float32
    terms, _ = _decode(wq, cin, nch)
    hi, lo = conv_chain.split_tf32(w[order])
    assert torch.equal(terms[0], hi) and torch.equal(terms[1], lo)
    nt8 = -(-nch // 8) * 8
    assert bq.numel() == nt8 and torch.equal(bq[:nch], b[order]) and (bq[nch:] == 0).all()
    assert (form(w, None, r)[1] == 0).all()


# the zoo's widths in both forms, a k-chunk of 16 folded, r = 3 (27 conv
# channels) and r = 2
ARITH_CASES = [(46, 3, 4), (64, 3, 4), (29, 3, 4), (3, 3, 4), (3, 4, 4), (16, 4, 4), (24, 3, 3),
               (5, 3, 2)]


@pytest.mark.parametrize("cin,cout,r", ARITH_CASES)
def test_tail_wgmma_tf32_arithmetic_matches_plain_and_pallas(rng, interpret_pallas, cin, cout,
                                                             r):
    """Under parity the new kernel's arithmetic, emulated from its packs
    (3 products, unit sums added in f32), agrees with the plain version and
    with the JAX Pallas tail (interpret mode) within the f32 conv's own
    reordering error: 8 f32 ulps of the magnitude sum."""
    x, w, b = _case(rng, cin, cout, r)
    _, (wq, bq) = _packed(torch.float32, cin, w, b, r)
    terms, unit_of = _decode(wq, cin, cout * r * r)
    emu = _emulate(x, terms, unit_of, bq[:cout * r * r], cout, r, 3)
    with config.numerics_mode("parity"):
        plain = tail.fused_conv3x3_pixelshuffle(x, w, b, r=r)
    w_hwio = w.permute(2, 3, 1, 0).numpy()
    ref = np.asarray(pallas_tail(jnp.asarray(ops.to_nhwc(x).numpy()), jnp.asarray(w_hwio),
                                 jnp.asarray(b.numpy()), r=r))
    bar = 8 * 2.0 ** -24 * tail.conv3x3_pixelshuffle_plain(x.abs(), w.abs(), b.abs(), r=r)
    assert bool(((emu - plain).abs() <= bar).all()), float((emu - plain).abs().max())
    assert (np.abs(ops.to_nhwc(emu).numpy() - ref) <= ops.to_nhwc(bar).numpy()).all()


@pytest.mark.parametrize("cin", [46, 50, 3])
def test_tail_wgmma_tf32_arithmetic_fasthi(rng, cin):
    """Under fasthi the emulated 2-product kernel (a_lo = 0 on bf16 inputs)
    rounds the same f32-grade sums to bf16 as the plain version and the
    unfused JAX graph: values differ by one bf16 ulp at most, in under 1%
    of them."""
    r, cout = 4, 3
    x = (rng.randn(1, 9, 7, cin) * 4).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).astype(np.float32)
    w = rng.randn(3, 3, cin, cout * r * r).astype(np.float32) * 0.05
    b = rng.randn(cout * r * r).astype(np.float32)
    with jconfig.numerics_mode("fasthi"):
        ref = np.asarray(jops.pixel_shuffle(jops.conv2d(jnp.asarray(x).astype(jnp.bfloat16),
                                                        jnp.asarray(w), jnp.asarray(b)), r))
    xt = ops.from_nhwc(torch.from_numpy(x).to(torch.bfloat16))
    wt, bt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(), torch.from_numpy(b)
    _, (wq, bq) = _packed(torch.bfloat16, cin, wt, bt, r)
    terms, unit_of = _decode(wq, cin, cout * r * r)
    emu = _emulate(xt, terms, unit_of, bq[:cout * r * r], cout, r, 2)
    with config.numerics_mode("fasthi"):
        plain = tail.fused_conv3x3_pixelshuffle(xt, wt, bt, r=r)
    assert emu.dtype == plain.dtype == torch.bfloat16
    e = ops.to_nhwc(emu).float().numpy()
    for other in (ops.to_nhwc(plain).float().numpy(), ref.astype(np.float32)):
        d = np.abs(e - other)
        assert (d <= 2.0 ** -7 * np.abs(other) + 1e-6).all(), d.max()
        assert (d > 0).mean() < 1e-2


def test_tail_wgmma_tf32_packs_have_keys_of_their_own(rng):
    """A split-TF32 wgmma pack (per tap or folded) is never served to the
    2-byte wgmma tail (``wgmma_tail_f16_r<r>``) or to the chain
    (``wgmma_chain_tf32``), nor one of theirs to it: each key packs once,
    its own layout; parity and fasthi share a form's pack (the same terms,
    3 or 2 products at run time); each launch counts against the kernel
    that its path names."""
    _, w, b = _case(rng, 46, 3, 4)
    _, w3, b3 = _case(rng, 3, 3, 4)
    keys = {"tap": tail.layout(torch.float32, 4, cin=46)[0],
            "fold": tail.layout(torch.float32, 4, cin=3)[0],
            "f16": tail.layout(torch.float16, 4, cin=46)[0],
            "chain": conv_chain.layout(torch.float32)[0]}
    assert keys["tap"].startswith("wgmma_tail_tf32") and keys["fold"].startswith("wgmma_tail_tf32")
    assert len(set(keys.values())) == 4
    assert tail.layout(torch.bfloat16, 4, cin=46)[0] == keys["tap"]
    assert tail.layout(torch.bfloat16, 4, cin=3)[0] == keys["fold"]
    before = conv_chain.packs
    got = {k: tail.packed_weights(keys[k], [w], [b], tail.layout(torch.float32, 4, cin=46)[1]
                                  if k == "tap" else tail.layout(torch.float16, 4, cin=46)[1])
           for k in ("tap", "f16")}
    got["fold"] = tail.packed_weights(keys["fold"], [w3], [b3],
                                      tail.layout(torch.float32, 4, cin=3)[1])
    again = tail.packed_weights(keys["tap"], [w], [b], tail.layout(torch.bfloat16, 4, cin=46)[1])
    assert conv_chain.packs == before + 3 and again is got["tap"]
    assert torch.equal(got["tap"][0], tail.pack_tail_wgmma_tf32(w, b, 4)[0])
    assert torch.equal(got["f16"][0], tail.pack_tail_wgmma_f16(w, b, 4)[0])
    assert torch.equal(got["fold"][0], tail.pack_tail_wgmma_tf32_fold(w3, b3, 4)[0])
    assert got["tap"][0].dtype == torch.float32 and got["f16"][0].dtype == torch.float16
    for p in ("tf32x3", "tf32x2"):
        assert tail.kernel_of(p) == "wgmma_tf32"
    assert set(tail.launches_by_kernel) == {"wgmma", "wgmma_tf32"}