"""The tail in one channel group at every shape (``csrc/tail.cu``), on the CPU.

Every tail launch runs one block a tile on warpgroup MMA: 52 -> 208 and
64 -> 256 at r = 2 under every tier and SCET's 64 -> 64 under fasthi16
too, their 2-byte weights streamed a tap of a step at a time through a
ring, and each step's 48 conv channels written out as soon as their
epilogue ends. Here: (a) the plan mirror (``tail.wgmma_plan``) gives every
shape that ``chip_smoke.py``, the zoo and the library run, and every
shape of cin 1-128 and r 2-4, a plan within a block's shared memory;
(b) the per-step write-out (the table of ``fill_table`` and ``StepOut``'s
tensor-store boxes, row boxes and plain pieces) emulated, bit for bit
against ``pixel_shuffle``; (c) the streamed 2-byte packs read back unit by
unit; (d) the kernels' arithmetic emulated from their packs, and the
port's tail, against the JAX package's Pallas tail in interpret mode;
(e) the packs' cache keys. The kernels themselves run only on the card
(``chip_smoke.py`` phase 3).
"""

import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental import pallas as pl

from ntire2022_esr_tpu.ops.pallas import fused_conv3x3_pixelshuffle as pallas_tail
from ntire2022_esr_tpu_torch import config, ops
from ntire2022_esr_tpu_torch.ops.kernels import build, conv_chain, tail

TIERS = ("parity", "high", "mixed", "fasthi", "fasthi16", "fast", "fast16")
STEP = 8 * conv_chain._NT_CHUNK  # conv channels of one step (csrc/tail.cu kStepCh)
# the formerly grouped widths (cin, cout, r): the x2 upsamplers' widest two
# and SCET's 64 -> 64
WIDE = [(52, 52, 2), (64, 64, 2), (64, 4, 4)]


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    yield


def _served():
    """(cin, cout, r) of every tail launch of chip_smoke.py's phases, the
    zoo's upsamplers and the library's."""
    import chip_smoke

    shapes = {(46, 3, 4), (50, 3, 4), (40, 3, 4), (42, 3, 4), (64, 3, 4), (24, 3, 3), (5, 3, 2),
              (16, 4, 4), (64, 64, 2), (64, 3, 4)}  # phase 3's and the library's
    for sites in chip_smoke.ZOO_TAILS.values():
        shapes |= {(cin, nch // 16, 4) for cin, nch in sites}
    for sites in chip_smoke.HR_TAILS.values():
        shapes |= {(cin, nch // 4, 2) for cin, nch in sites}
    shapes |= {(cin, cout, 4) for cin, cout in chip_smoke.ZOO_R4_WIDTHS}
    shapes |= {(cin, cout, 2) for cin, cout in chip_smoke.R2_WIDTHS}
    shapes |= set(chip_smoke.LIB_NARROW)
    return sorted(shapes)


# -- (a) the plan mirror --------------------------------------------------------

@pytest.mark.parametrize("tier", TIERS)
def test_every_shape_has_a_one_group_plan(tier):
    """Every shape the parent took (cin 1-128, r 2-4, the couts of the zoo
    and the library) and every shape chip_smoke.py runs has a plan of the
    kernel of its tier's path, in one block: within a block's 232,448
    bytes, at most 6 m-blocks, a ring of 2-4 buffers or (2-byte only) the
    weights resident (with the whole tile's result), the whole tile's
    result or 1 or 2 step results. The
    formerly grouped widths plan as the kernel's comments reckon them."""
    nm = config._MODES[tier]
    dt, c = nm.activation_dtype, nm.compute_dtype
    kernel = tail.kernel_of(conv_chain.path(nm))
    rings = (0, 2, 3, 4) if kernel == "wgmma" else (2, 3, 4)
    shapes = set(_served()) | {(cin, cout, r) for cin in range(1, 129) for r in (2, 3, 4)
                               for cout in (3, 4, 24, 32, 52, 64)}
    for cin, cout, r in sorted(shapes):
        p = tail.wgmma_plan(cin, cout, r, dt, c)
        assert p["kernel"] == kernel and p["bytes"] <= build.MAX_SMEM, (cin, cout, r, p)
        assert 1 <= p["blocks"] <= 6 and p["nbuf"] in rings and p["nres"] in (0, 1, 2), p
        # resident 2-byte weights come with the whole tile's result (the
        # resident kernel takes no step results)
        assert p["nbuf"] or p["nres"] == 0, p
    p = tail.wgmma_plan(64, 64, 2, dt, c)
    if tier == "fasthi16":
        assert (p["tile"], p["nbuf"], p["nres"], p["bytes"]) == ((16, 22), 4, 1, 199184)
        assert tail.wgmma_plan(46, 3, 4, dt, c)["bytes"] == 199728  # RLFN's, resident
        assert tail.wgmma_plan(46, 3, 4, dt, c)["nbuf"] == 0
        assert tail.wgmma_plan(64, 4, 4, dt, c)["nbuf"] == 4  # SCET's two steps streamed
    elif kernel == "wgmma":
        assert (p["tile"], p["nbuf"]) == ((16, 22), 4)
    elif dt == torch.float32:
        assert (p["tile"], p["nbuf"], p["nres"]) == ((8, 22), 4, 1)
        assert tail.wgmma_plan(52, 52, 2, dt, c)["tile"] == (8, 22)
        assert tail.wgmma_plan(128, 64, 2, dt, c)["tile"] == (8, 8)  # one warpgroup idle
        assert tail.wgmma_plan(46, 3, 4, dt, c)["bytes"] == 225152


# -- (b) the per-step write-out ---------------------------------------------------

TILE_MODES = ("runs", "rows", "tileplain")  # the tile's result in the tile's layout


def _table(nt, nch, runh, th, tw, mode):
    """csrc/tail.cu fill_table: {offset, per pixel} of each conv channel in a
    step's result buffer, -1 past the conv's channels."""
    g = math.gcd(STEP, runh)  # values of a chunk (csrc/tail.cu chunk_values)
    return [(-1, 0) if k >= nch else
            ((k // runh) * tw * runh + k % runh, runh) if mode in TILE_MODES else
            (k % STEP // g * th * tw * g + k % g, g) if mode == "pixels" else (k % STEP, STEP)
            for k in range(8 * nt)]


def _write_out(conv, cout, r, tile, mode):
    """The kernels' epilogue stores into a step's result buffer and StepOut
    on the CPU: ``conv`` (n, r*r*cout, h, w) in shuffled channel order,
    tile by tile and step by step. "runs", "rows" and "tileplain": the
    tile's result in its layout, [tile row][i][x][run], every step into one
    buffer, then its r * th output rows of tw runs by one box (or plain
    copies) clipped to the image; "pixels": each chunk of a step's
    channels (gcd(48, run) values, in one row i's run) one box of (a
    chunk, tw, 1, th, 1) of
    out viewed as (run, wd, r, h, n), clipped to the image; "plain": each
    piece [a, b) of each row copied value by value. Tile pixels past the
    image hold a sentinel, and whatever is not written stays NaN: the
    output shows either. Returns NHWC (n, r*h, r*w, cout)."""
    n, nch, h, wd = conv.shape
    th, tw = tile
    runh, npix = r * cout, th * tw
    nt = -(-nch // 8)
    steps = -(-nt // 6)
    tab = _table(nt, nch, runh, th, tw, mode)
    whole = mode in TILE_MODES
    # the kernels' px: row * r * tw + c in the tile's layout, else row * tw + c
    lay = r if whole else 1
    pix = (torch.arange(th)[:, None] * lay * tw + torch.arange(tw)[None, :]).reshape(-1)
    out = torch.full((n, h, r, wd, runh), float("nan"))  # (image, y, i, x, run)
    pad = F.pad(conv, (0, tw, 0, th), value=-7777.0)  # the tile's pixels past the image
    for img in range(n):
        for ty0 in range(0, h, th):
            for tx0 in range(0, wd, tw):
                nrow, npx = min(th, h - ty0), min(tw, wd - tx0)
                vals = pad[img, :, ty0:ty0 + th, tx0:tx0 + tw].reshape(nch, npix)
                buf = torch.full((npix * max(nch, STEP),), float("nan"))
                for s in range(steps):
                    if not whole:
                        buf = torch.full((npix * STEP,), float("nan"))
                    for k in range(s * STEP, min((s + 1) * STEP, 8 * nt)):
                        off, per = tab[k]
                        if off >= 0:
                            buf[off + per * pix] = vals[k]
                    k0, k1 = s * STEP, min(s * STEP + STEP, nch)
                    if whole:
                        if s + 1 == steps:
                            box = buf[:npix * nch].reshape(th, r, tw, runh)
                            out[img, ty0:ty0 + nrow, :, tx0:tx0 + npx] = box[:nrow, :, :npx]
                    elif mode == "pixels":
                        g = math.gcd(STEP, runh)
                        for k in range(k0, k1, g):
                            i, o = divmod(k, runh)
                            assert o + g <= runh  # a chunk lies in one run
                            box = buf[(k - k0) // g * npix * g:][:npix * g].reshape(th, tw, g)
                            out[img, ty0:ty0 + nrow, i, tx0:tx0 + npx, o:o + g] = (
                                box[:nrow, :npx])
                    else:
                        box = buf.reshape(th, tw, STEP)
                        for i in range(k0 // runh, -(-k1 // runh)):
                            a, b = max(k0, i * runh), min(k1, (i + 1) * runh)
                            out[img, ty0:ty0 + nrow, i, tx0:tx0 + npx,
                                a - i * runh:b - i * runh] = box[:nrow, :npx, a - k0:b - k0]
    return out.reshape(n, h, r, wd, r, cout).reshape(n, h * r, wd * r, cout)


WRITE_CASES = [(52, 2, "pixels"), (52, 2, "plain"), (64, 2, "pixels"), (64, 2, "plain"),
               (24, 2, "pixels"), (4, 4, "pixels"), (4, 4, "plain"), (4, 4, "rows"),
               (4, 4, "tileplain"), (3, 4, "runs"), (3, 4, "rows"), (3, 2, "plain")]


@pytest.mark.parametrize("cout,r,mode", WRITE_CASES)
def test_step_write_out_is_pixel_shuffle(rng, cout, r, mode):
    """The per-step write-out of a conv result in shuffled order (52 -> 208
    and 64 -> 256 at r = 2, whose steps' 48 channels straddle the runs of
    two output rows, in chunks of 16 and 32 bytes; 24 -> 96, a step's 96
    bytes a chunk; SCET's 64 -> 64 at r = 4, three rows a step and a
    second step of 16 real channels, a step at a time or the whole tile's
    result; RLFN's 46 -> 48, one step, its tile by one box of runs or of
    tile rows; 5 -> 12, one step, mostly pad) by the tensor-store boxes and
    the plain pieces, over an image that no tile divides: bit for bit
    PixelShuffle."""
    nch = cout * r * r
    conv = torch.from_numpy(rng.randn(2, nch, 19, 25).astype(np.float32))
    got = _write_out(conv, cout, r, (16, 22) if cout > 4 else (8, 22), mode)
    torch_order = torch.empty_like(conv)
    torch_order[:, tail.shuffled_order(cout, r)] = conv
    want = F.pixel_shuffle(torch_order, r).permute(0, 2, 3, 1)
    assert not bool(torch.isnan(got).any()) and torch.equal(got, want)


# -- (c) the streamed 2-byte packs ------------------------------------------------

def _units_2byte(wq, cin, nch, terms):
    """A 2-byte wgmma tail pack (float32 copy) read unit by unit: unit
    (step, tap) is kc k-steps of an N x 16 B operand (N = 48 terms) at
    (step * 9 + tap) units, its core matrix (term, column group, k-half) 8
    columns x 8 k. Returns [terms, steps * 48, kc * 16, 3, 3]."""
    kc, steps = -(-cin // 16), -(-nch // STEP)
    unit = kc * STEP * terms * 16
    assert wq.size == steps * 9 * unit
    full = np.full((terms, steps * STEP, kc * 16, 9), np.nan, np.float32)
    for step in range(steps):
        for tap in range(9):
            u = wq[(step * 9 + tap) * unit:][:unit].reshape(kc, terms, 6, 2, 8, 8)
            full[:, step * STEP:(step + 1) * STEP, :, tap] = u.transpose(1, 2, 4, 0, 3, 5).reshape(
                terms, STEP, kc * 16)
    return full.reshape(terms, steps * STEP, kc * 16, 3, 3)


@pytest.mark.parametrize("kind", ["split_f16", "float16", "bfloat16"])
@pytest.mark.parametrize("cin,cout,r", WIDE)
def test_streamed_units_are_the_weights(rng, kind, cin, cout, r):
    """The units that the 2-byte kernel streams through its ring at the
    formerly grouped widths, read back to OIHW, are the split f16 terms
    (w * S = w_hi + w_lo * 2^-11 to 2^-22 relative) or the weights rounded
    to the dtype, with the conv's channels in shuffled order; zero in every
    pad; a unit is the plan's bytes (``wgmma_plan``), and the plan streams
    them (a ring of 2-4 buffers) under fasthi16."""
    w = torch.from_numpy(rng.randn(cout * r * r, cin, 3, 3).astype(np.float32) * 0.05)
    b = torch.from_numpy(rng.randn(cout * r * r).astype(np.float32))
    nch = cout * r * r
    ws = w[tail.shuffled_order(cout, r)]
    tier = {"split_f16": "fasthi16", "float16": "fast16", "bfloat16": "fast"}[kind]
    nm = config._MODES[tier]
    wq, _ = tail.layout(nm.activation_dtype, r, nm.compute_dtype)[1]([w], [b])
    terms = 2 if kind == "split_f16" else 1
    plan = tail.wgmma_plan(cin, cout, r, nm.activation_dtype, nm.compute_dtype)
    assert wq.numel() * 2 == -(-nch // STEP) * 9 * plan["unit"]
    assert plan["nbuf"] in (2, 3, 4) or (kind != "split_f16" and cout == 4)
    full = _units_2byte(wq.float().numpy(), cin, nch, terms)
    if kind == "split_f16":
        want = conv_chain.split_f16(ws)
        inv = want[2].numpy()[:, None, None, None]
        back = (full[0, :nch, :cin] + full[1, :nch, :cin] * 2.0 ** -11) * inv
        np.testing.assert_allclose(back, ws.numpy(), rtol=2.0 ** -21, atol=0)
    else:
        want = conv_chain.rounded([ws], [b], getattr(torch, kind))[0]
    for t in range(terms):
        np.testing.assert_array_equal(full[t, :nch, :cin], want[t].float().numpy())
    assert (full[:, nch:] == 0).all() and (full[:, :, cin:] == 0).all()


# -- (d) against the Pallas tail --------------------------------------------------

def _kernel_fasthi16(x, w, b, r):
    """The 2-byte kernel's arithmetic under fasthi16 from its pack: f32 sums
    of x * w_hi and x * w_lo over the whole conv, (hi + lo * 2^-11) / S +
    bias, saturated and rounded to f16 (epilogue_value), the conv's channels
    in shuffled order, then the per-step write-out."""
    cin, nch = int(w.shape[1]), int(w.shape[0])
    cout = nch // (r * r)
    wq, sb = tail.pack_tail_wgmma_f16(w, b, r)
    full = torch.from_numpy(_units_2byte(wq.float().numpy(), cin, nch, 2))[:, :nch, :cin]
    nt8 = sb.numel() // 2
    inv, bias = sb[:nch], sb[nt8:nt8 + nch]
    a = x.float()
    acc = F.conv2d(a, full[0], padding=1) + F.conv2d(a, full[1], padding=1) * 2.0 ** -11
    y = (acc * inv[None, :, None, None] + bias[None, :, None, None]).clamp(-65504.0, 65504.0)
    return _write_out(y.half().float(), cout, r, (16, 22), "pixels").half()


def _kernel_parity(x, w, b, r):
    """The split-TF32 kernel's arithmetic under parity from its pack: per tap
    the products a_hi w_hi, a_hi w_lo and a_lo w_hi summed from zero, the
    taps' sums added in f32, + bias; the conv's channels in shuffled order,
    then the per-step write-out in f32."""
    cin, nch = int(w.shape[1]), int(w.shape[0])
    cout, kc = nch // (r * r), -(-cin // 16)
    wq, bq = tail.pack_tail_wgmma_tf32(w, b, r)
    steps = -(-nch // STEP)
    v = wq.numpy().reshape(steps, 9, kc, 2, 2, 6, 2, 8, 4)
    full = v.transpose(4, 0, 5, 7, 1, 2, 8, 3, 6).reshape(2, steps * STEP, 9, kc * 16)
    wt = torch.from_numpy(np.ascontiguousarray(full[:, :nch, :, :cin].transpose(0, 1, 3, 2)))
    a = x.float()
    a_hi = conv_chain.round_tf32(a)
    a_lo = conv_chain.round_tf32(a - a_hi)
    total = 0
    for tap in range(9):
        m = torch.zeros(9)
        m[tap] = 1.0
        wh, wl = ((t.reshape(nch, cin, 9) * m).reshape(nch, cin, 3, 3) for t in wt)
        total = total + (F.conv2d(a_hi, wh, padding=1) + F.conv2d(a_hi, wl, padding=1)
                         + F.conv2d(a_lo, wh, padding=1))
    y = total + bq[:nch][None, :, None, None]
    return _write_out(y, cout, r, (8, 22), "pixels")


@pytest.mark.parametrize("tier", ["parity", "fasthi16"])
@pytest.mark.parametrize("cin,cout,r", WIDE)
def test_one_group_tail_matches_pallas(rng, interpret_pallas, tier, cin, cout, r):
    """At the formerly grouped widths the kernels' arithmetic emulated from
    their packs (and the per-step write-out), and the port's tail (its plain
    version on the CPU), against the JAX Pallas tail in interpret mode on
    the same numpy-seeded image: under parity within 8 f32 ulps of the sum
    of the products' magnitudes (the f32 conv's own reordering error, as
    the split-TF32 tests hold it); under fasthi16 (Pallas's f32 result
    rounded once to f16) one f16 ulp at most, in under 1% of the values:
    both round the same f32-grade sums, taken in another order."""
    nch = cout * r * r
    x = (rng.randn(1, 19, 25, cin) * 4).astype(np.float32)
    x *= 1 + rng.rand(*x.shape).astype(np.float32) * 1e-3  # full f32 mantissas: a_lo != 0
    w = torch.from_numpy(rng.randn(nch, cin, 3, 3).astype(np.float32) * 0.05)
    b = torch.from_numpy(rng.randn(nch).astype(np.float32))
    nm = config._MODES[tier]
    xt = ops.from_nhwc(torch.from_numpy(x)).to(nm.activation_dtype)
    ref = np.asarray(pallas_tail(jnp.asarray(ops.to_nhwc(xt).float().numpy()),
                                 jnp.asarray(w.permute(2, 3, 1, 0).numpy()),
                                 jnp.asarray(b.numpy()), r=r))
    with config.numerics_mode(tier):
        plain = ops.to_nhwc(tail.fused_conv3x3_pixelshuffle(xt, w, b, r=r))
    if tier == "parity":
        emu = _kernel_parity(xt, w, b, r)
        bar = 8 * 2.0 ** -24 * ops.to_nhwc(tail.conv3x3_pixelshuffle_plain(
            xt.abs(), w.abs(), b.abs(), r=r)).numpy()
        for got in (emu, plain):
            assert (np.abs(got.numpy() - ref) <= bar).all(), float(np.abs(got.numpy() - ref).max())
    else:
        emu = _kernel_fasthi16(xt, w, b, r)
        ref16 = torch.from_numpy(np.clip(ref, -65504.0, 65504.0)).half().float()
        for got in (emu.float(), plain.float()):
            d = (got - ref16).abs()
            assert bool((d <= 2.0 ** -10 * ref16.abs().clamp_min(1.0)).all()), float(d.max())
            assert float((d > 0).float().mean()) < 1e-2


# -- (e) the packs' keys ----------------------------------------------------------

@pytest.mark.parametrize("tier", TIERS)
def test_tail_keys_are_served_to_their_kernel_only(rng, tier):
    """The tail's packed-weight keys (``wgmma_tail_*``) are the tier's
    kernel's alone: the same key for every tier that shares a pack (the
    split-TF32 tiers' per-tap form, parity's and fasthi's alike), another
    for each r, form (folded up to 16 channels), 2-byte dtype and for the
    chain; a key packs once, and the pack it serves is the kernel's own."""
    nm = config._MODES[tier]
    dt, c = nm.activation_dtype, nm.compute_dtype
    w = torch.from_numpy(rng.randn(208, 52, 3, 3).astype(np.float32) * 0.05)
    b = torch.from_numpy(rng.randn(208).astype(np.float32))
    key, pack = tail.layout(dt, 2, c, 52)
    keys = {tail.layout(d, r, cc, cin)[0] for d, cc in (
        (torch.float32, torch.float32), (torch.float16, torch.float32),
        (torch.float16, torch.float16), (torch.bfloat16, torch.bfloat16))
        for r in (2, 4) for cin in (3, 52)}
    assert len(keys) == 10 and key in keys and all(k.startswith("wgmma_tail_") for k in keys)
    assert not keys & {conv_chain.layout(d, cc)[0] for d, cc in (
        (torch.float32, torch.float32), (torch.float16, torch.float32),
        (torch.float16, torch.float16), (torch.bfloat16, torch.bfloat16))}
    before = conv_chain.packs
    got = tail.packed_weights(key, [w], [b], pack)
    assert tail.packed_weights(key, [w], [b], pack) is got and conv_chain.packs == before + 1
    if tail.kernel_of(conv_chain.path(nm)) == "wgmma_tf32":
        assert key == "wgmma_tail_tf32_r2"
        assert torch.equal(got[0], tail.pack_tail_wgmma_tf32(w, b, 2)[0])
    elif c == torch.float32:
        assert key == "wgmma_tail_f16_r2"
        assert torch.equal(got[0], tail.pack_tail_wgmma_f16(w, b, 2)[0])
    else:
        assert torch.equal(got[0], tail.pack_tail_wgmma_2byte(w, b, 2, dt)[0])
    assert set(tail.launches_by_kernel) == {"wgmma", "wgmma_tf32"}
