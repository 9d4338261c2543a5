"""The tiers ``fast``, ``fast16`` and ``mixed`` in the port, on the CPU,
against the JAX package.

- ``conv2d``, ``linear`` and the pools against the JAX ops: at most one
  ulp of the tier's dtype for each rounding;
- the two kernels' plain versions against the unfused JAX graph, and the
  CUDA kernels' 2-byte arithmetic (weights packed once rounded to the
  dtype, one exact ``m16n8k16`` product, the bias added after the sum's
  rounding) emulated in PyTorch from the packs against the plain versions
  and the unfused JAX convs;
- the packed-weight cache, which packs anew when the tier changes;
- ``fast16`` finiteness on FMEN (03) and AALN (11), whose dr=255
  activations overflow f16;
- RLFN under each tier against JAX ``rlfn_apply``, within the scale that
  JAX's own output moves by.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them to these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu.harness import registry as jregistry
from ntire2022_esr_tpu.models import rlfn as jrlfn
from ntire2022_esr_tpu_torch import config, ops, porter
from ntire2022_esr_tpu_torch.harness import registry
from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail

# tier -> (JAX dtype, torch dtype, ulp relative to the value: 2**-mantissa bits)
TIERS = {"fast": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7),
         "fast16": (jnp.float16, torch.float16, 2.0 ** -10),
         "mixed": (jnp.float32, torch.float32, 2.0 ** -23)}


def _t(a, dtype=torch.float32):
    return ops.from_nhwc(torch.from_numpy(np.array(a, dtype=np.float32))).to(dtype)


def _n(t):
    return ops.to_nhwc(t).float().numpy()


def _oihw(w_hwio):
    return porter.to_torch({"c": {"weight": w_hwio}})["c.weight"]


def _ulps(out, ref, tier, *rounded):
    """|out - ref| in ulps of the tier's dtype at the binade of the largest
    of ``|ref|`` and the values it was rounded from (``rounded``: a conv's
    output before its bias is added, which JAX and the port round first;
    values below 1 take the ulp of 1)."""
    ulp = TIERS[tier][2]
    top = np.maximum(np.abs(ref), 1.0)
    for r in rounded:
        top = np.maximum(top, np.abs(r))
    return np.abs(out - ref) / (ulp * 2.0 ** np.floor(np.log2(top)))


def _close(out, ref, tier, *rounded):
    """At most one ulp of a 2-byte tier's dtype (:func:`_ulps`) for each
    rounding: the output's own, and one for each of ``rounded`` (two for a
    sum rounded before its bias is added and rounded again: where the two
    frameworks' f32 sums straddle the first rounding's boundary, the second
    may round the other way too); under mixed, f32 sums in another order:
    within 1e-5 of the largest value."""
    if tier == "mixed":
        return float(np.abs(out - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    return float(_ulps(out, ref, tier, *rounded).max()) <= 1.0 + len(rounded)


class _P(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(w), requires_grad=False)
        self.bias = torch.nn.Parameter(torch.from_numpy(b), requires_grad=False)


def _jax(fn, tier, *args):
    with jconfig.numerics_mode(tier):
        return np.asarray(jax.jit(lambda *a: fn(*a))(*args)).astype(np.float32)


def test_modes_lists_every_tier():
    assert config.modes() == sorted(["parity", "high", "mixed", "fast", "fast16", "fasthi",
                                     "fasthi16"])
    for tier, (_, tdt, _) in TIERS.items():
        nm = config._MODES[tier]
        assert nm.compute_dtype == tdt and nm.storage_dtype is None
        assert nm.activation_dtype == tdt and nm.two_byte_compute == (tier != "mixed")


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_conv_linear_match_jax_ops(rng, tier):
    """One conv (3x3, 1x1 strided, depthwise) and one linear, each with a
    bias: the port adds the bias after the contraction's rounding, as the
    JAX ops do (two roundings under a 2-byte tier). At most one ulp of the
    tier's dtype for each of the two roundings (:func:`_close`; mixed: f32
    sums in another order, 1e-5 of the largest value)."""
    jdt, tdt, _ = TIERS[tier]
    x = (rng.randn(2, 17, 19, 24) * 4).astype(np.float32)
    w3 = (rng.randn(3, 3, 24, 32) * 0.05).astype(np.float32)
    w1 = (rng.randn(1, 1, 24, 16) * 0.2).astype(np.float32)
    wd = (rng.randn(3, 3, 1, 24) * 0.3).astype(np.float32)
    lw = (rng.randn(24, 32) * 0.2).astype(np.float32)
    b32, b16, b24 = (rng.randn(n).astype(np.float32) * 0.5 for n in (32, 16, 24))
    xj = np.asarray(jnp.asarray(x).astype(jdt))
    z32, z16, z24 = (np.zeros(n, np.float32) for n in (32, 16, 24))
    cases = [
        ("conv3x3", lambda v, b: jops.conv2d(v, w3, b),
         lambda t: ops.conv2d(t, _oihw(w3), torch.from_numpy(b32)), b32, z32),
        ("conv1x1/2", lambda v, b: jops.conv2d(v, w1, b, stride=2, padding=0),
         lambda t: ops.conv2d(t, _oihw(w1), torch.from_numpy(b16), stride=2, padding=0),
         b16, z16),
        ("depthwise", lambda v, b: jops.conv2d(v, wd, b, groups=24),
         lambda t: ops.conv2d(t, _oihw(wd), torch.from_numpy(b24), groups=24), b24, z24),
        ("linear", lambda v, b: jops.linear({"weight": lw, "bias": b}, v),
         lambda t: ops.linear(_P(lw, b32), t), b32, z32),
    ]
    for tag, jf, tf, b, z in cases:
        ref, sums = _jax(jf, tier, xj, b), _jax(jf, tier, xj, z)
        with config.numerics_mode(tier), torch.inference_mode():
            out = tf(_t(xj, tdt))
        assert out.dtype == tdt, tag
        assert _close(_n(out), ref, tier, sums), (tag, _ulps(_n(out), ref, tier, sums).max())


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_pools_match_jax_ops(rng, tier):
    """The global pools and the channel ops. Max pooling, channel shuffle
    and mean shift equal the JAX ops exactly. The mean and the unbiased
    standard deviation are within one ulp of them under f16, which sums in
    f32, and within 1e-5 under f32 (sums in another order). Under bf16 the
    JAX ops reduce in bf16, and XLA's CPU backend accumulates such a sum in
    bf16 (1280 values of mean 0.41 sum to 512 against 521.25); the port
    sums in f32, as the TPU does, and is held to an f64 mean and standard
    deviation of the same bf16 input instead."""
    jdt, tdt, _ = TIERS[tier]
    x = np.asarray(jnp.asarray((rng.randn(2, 23, 17, 12) * 3 + 1).astype(np.float32)).astype(jdt))
    xt = _t(x, tdt)
    with config.numerics_mode(tier), torch.inference_mode():
        for tag, jf, tf in (("max", jops.global_max_pool, ops.global_max_pool),
                            ("shuffle", lambda v: jops.channel_shuffle(v, 3),
                             lambda t: ops.channel_shuffle(t, 3)),
                            ("mean_shift", lambda v: jops.mean_shift(v[..., :3], 255.0),
                             lambda t: ops.mean_shift(t[:, :3], 255.0))):
            out = tf(xt)
            assert out.dtype == tdt and np.array_equal(_n(out), _jax(jf, tier, x)), tag
        for tag, jf, tf, ddof in (("mean", jops.global_avg_pool, ops.global_avg_pool, None),
                                  ("std", jops.global_std_pool, ops.global_std_pool, 1)):
            out = _n(tf(xt))
            if tier == "fast":
                x64 = x.astype(np.float64)
                ref = x64.mean(axis=(1, 2), keepdims=True) if ddof is None else \
                    x64.std(axis=(1, 2), keepdims=True, ddof=ddof)
            else:
                ref = _jax(jf, tier, x)
            assert out.shape == ref.shape, tag
            assert _close(out, ref, tier), (tag, _ulps(out, ref, tier).max())


def _rlfn_weights():
    p = jregistry.load_params(jregistry.get_spec(4))
    b = p["B1"]
    convs = [b[f"c{i}_r"] for i in (1, 2, 3)]
    return ([c["weight"] for c in convs], [c["bias"] for c in convs],
            p["upsampler"]["0"]["weight"], p["upsampler"]["0"]["bias"])


def _chain_input(rng, jdt):
    x = (rng.randn(2, 24, 20, 46) * 8).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jdt))


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_kernel_plain_versions_match_unfused_jax(rng, tier):
    """Both kernels' plain versions on RLFN's weights against the unfused
    JAX graph. The chain stage by stage (a one-stage chain, each fed JAX's
    input to that stage; the last with the residual) and the tail (conv +
    PixelShuffle): at most one ulp of the tier's dtype for each of the two
    roundings, at the larger of the output and the sum before the bias
    (mixed: 1e-5 of the largest value). The whole chain, where a flipped
    store is carried on: the share of values that differ at all, at most
    1e-3 under fast and 5e-2 under fast16 (measured 3.6e-4 and 1.7e-2)."""
    jdt, tdt, _ = TIERS[tier]
    ws, bs, wu, bu = _rlfn_weights()
    x = _chain_input(rng, jdt)
    chain = conv_chain.fused_conv3x3_chain
    with config.numerics_mode(tier), torch.inference_mode():
        h = x
        for k, (w, b) in enumerate(zip(ws, bs)):
            last = k == len(ws) - 1
            ref = _jax(lambda v: jops.leaky_relu(jops.conv2d(v, w, b), 0.05)
                       + (jnp.asarray(x) if last else 0), tier, h)
            sums = _jax(lambda v: jops.conv2d(v, w, np.zeros_like(b)), tier, h)
            out = chain(_t(h, tdt), [_oihw(w)], [torch.from_numpy(b)], residual=False)
            if last:
                out = out + _t(x, tdt)
            assert out.dtype == tdt
            assert _close(_n(out), ref, tier, sums), (k, _ulps(_n(out), ref, tier, sums).max())
            h = np.asarray(jnp.asarray(ref).astype(jdt))
        whole = chain(_t(x, tdt), [_oihw(w) for w in ws], [torch.from_numpy(b) for b in bs])
        up = tail.fused_conv3x3_pixelshuffle(_t(x, tdt), _oihw(wu), torch.from_numpy(bu))
    if tier != "mixed":
        assert float((_n(whole) != ref).mean()) <= {"fast": 1e-3, "fast16": 5e-2}[tier]
    uref = _jax(lambda v: jops.pixel_shuffle(jops.conv2d(v, wu, bu), 4), tier, x)
    usums = _jax(lambda v: jops.pixel_shuffle(jops.conv2d(v, wu, np.zeros_like(bu)), 4), tier, x)
    assert up.dtype == tdt
    assert _close(_n(up), uref, tier, usums), _ulps(_n(up), uref, tier, usums).max()


def _unpack_2byte(wq, cin, cout):
    """One stage of a one-term 2-byte pack back to OIHW f32: the fragment
    order [chunk of 6 n-tiles][ky][kx][k-chunk][n-tile][g][t][b0, b1][pair]
    undone, b0 the input channels 2t, 2t+1 of the k-chunk and b1 2t+8,
    2t+9, output channel 8 ntile + g."""
    kc, nt = -(-cin // 16), -(-cout // 8)
    blocks, off = [], 0
    for n0 in range(0, nt, 6):
        ntl = min(6, nt - n0)
        v = wq[off:off + 9 * kc * ntl * 128].float().reshape(3, 3, kc, ntl, 8, 4, 2, 2)
        blocks.append(v.permute(3, 4, 0, 1, 2, 6, 5, 7))  # [n-tile, g, ky, kx, kc, b, t, pair]
        off += 9 * kc * ntl * 128
    assert off == wq.numel()
    full = torch.cat(blocks).reshape(nt * 8, 3, 3, kc * 16).permute(0, 3, 1, 2)
    return full[:cout, :cin]


def _kernel_conv(x, w, b, tier, two_roundings=True):
    """The CUDA kernels' arithmetic for one conv under a 2-byte tier, in
    plain PyTorch, from what the one-product kernel reads
    (``conv_chain.layout`` under the tier: ``pack_chain_2byte``): the
    weights, packed once rounded to the dtype (each its own single term),
    and the bias rounded to it after scales of 1; exact products summed in
    f32 (one ``mma.sync.m16n8k16`` product a fragment), then the epilogue:
    the sum rounded to the dtype, the bias added and rounded again, f16
    saturated after the add. ``two_roundings=False`` is the control with
    the bias inside the rounding, as fasthi's epilogue adds it."""
    dt = x.dtype
    nm = config._MODES[tier]
    _, pack = conv_chain.layout(nm.activation_dtype, nm.compute_dtype)
    wq, sb = pack([w], [b])
    cout, cin = int(w.shape[0]), int(w.shape[1])
    nt8 = -(-cout // 8) * 8
    wk, bias = _unpack_2byte(wq, cin, cout), sb[nt8:nt8 + cout]
    (wr,), (br,) = conv_chain.rounded([w], [b], dt)
    assert wq.dtype == dt and torch.equal(wk, wr) and torch.equal(bias, br)
    assert bool((sb[:nt8] == 1).all())
    s = torch.nn.functional.conv2d(x.float(), wk, padding=1)
    if not two_roundings:
        return ops.nn.saturate_f16((s + bias[None, :, None, None]).to(dt))
    y = s.to(dt).float() + bias[None, :, None, None]
    return ops.nn.saturate_f16(y.to(dt))


@pytest.mark.parametrize("tier", ["fast", "fast16"])
def test_kernel_two_roundings_emulated(rng, tier):
    """The kernels' one-product arithmetic and 2-byte epilogue
    (:func:`_kernel_conv`) against the plain version and JAX's unfused
    conv, per stage of RLFN's chain fed the plain version's input: the
    emulation and the plain version round f32 sums of the same exact
    products, so they agree but for sums that straddle a rounding boundary
    (measured at most 1.5e-4 of the values under fast and 1e-5 under
    fast16; bar 1e-3), and against JAX within one ulp for each of the two
    roundings (:func:`_close`). The single-rounding control differs from
    the plain version in a tenth of the values or more (measured 0.27 and
    0.29): chip_smoke.py's flip bar tells the two apart on the card."""
    jdt, tdt, _ = TIERS[tier]
    ws, bs, _, _ = _rlfn_weights()
    h = _t(_chain_input(rng, jdt), tdt)
    with config.numerics_mode(tier), torch.inference_mode():
        for w, b in zip(ws, bs):
            wt, bt = _oihw(w), torch.from_numpy(b)
            plain = ops.conv2d(h, wt, bt, padding=1)
            emu = _kernel_conv(h, wt, bt, tier)
            one = _kernel_conv(h, wt, bt, tier, two_roundings=False)
            assert float((emu != plain).float().mean()) <= 1e-3
            assert float((one != plain).float().mean()) >= 0.1
            hn = _n(h)
            ref = _jax(lambda v: jops.conv2d(v, w, b), tier, hn)
            sums = _jax(lambda v: jops.conv2d(v, w, np.zeros_like(b)), tier, hn)
            assert _close(_n(emu), ref, tier, sums), _ulps(_n(emu), ref, tier, sums).max()
            h = ops.leaky_relu(plain, 0.05)


@pytest.mark.parametrize("tier", ["fast", "fast16"])
def test_tail_kernel_arithmetic_emulated(rng, tier):
    """The tail's one-product kernel in plain PyTorch, from what it reads
    (``tail.layout`` under the tier: ``pack_tail_2byte``, output channels in
    shuffled order): the packed weights unpacked, exact products summed in
    f32, the two-rounding epilogue, and the result put back in torch's
    channel order before PixelShuffle. On RLFN's upsampler (46 -> 48, r =
    4) and the zoo's 64 -> 48: at most 1e-3 of the values differ from the
    plain version (both round f32 sums of the same exact products), and
    each is within one ulp a rounding of JAX's unfused conv + PixelShuffle."""
    jdt, tdt, _ = TIERS[tier]
    _, _, wu, bu = _rlfn_weights()
    cases = [(wu, bu, _chain_input(rng, jdt))]
    x64 = np.asarray(jnp.asarray((rng.randn(2, 11, 9, 64) * 8).astype(np.float32)).astype(jdt))
    cases.append(((rng.randn(3, 3, 64, 48) * 0.05).astype(np.float32),
                  rng.randn(48).astype(np.float32), x64))
    nm = config._MODES[tier]
    for w, b, x in cases:
        wt, bt, xt = _oihw(w), torch.from_numpy(b), _t(x, tdt)
        nch, cin = int(wt.shape[0]), int(wt.shape[1])
        order = tail.shuffled_order(nch // 16, 4)
        _, pack = tail.layout(nm.activation_dtype, 4, nm.compute_dtype)
        wq, sb = pack([wt], [bt])
        nt8 = -(-nch // 8) * 8
        wk, bias = _unpack_2byte(wq, cin, nch), sb[nt8:nt8 + nch]
        (wr,), (br,) = conv_chain.rounded([wt[order]], [bt[order]], tdt)
        assert torch.equal(wk, wr) and torch.equal(bias, br)
        s = torch.nn.functional.conv2d(xt.float(), wk, padding=1)
        y = ops.nn.saturate_f16((s.to(tdt).float() + bias[None, :, None, None]).to(tdt))
        conv = torch.empty_like(y)
        conv[:, order] = y
        emu = torch.nn.functional.pixel_shuffle(conv, 4)
        with config.numerics_mode(tier), torch.inference_mode():
            plain = tail.fused_conv3x3_pixelshuffle(xt, wt, bt, r=4)
        assert emu.dtype == plain.dtype == tdt and emu.shape == plain.shape
        assert float((emu != plain).float().mean()) <= 1e-3
        ref = _jax(lambda v: jops.pixel_shuffle(jops.conv2d(v, w, b), 4), tier, x)
        sums = _jax(lambda v: jops.pixel_shuffle(jops.conv2d(v, w, np.zeros_like(b)), 4), tier, x)
        assert _close(_n(emu), ref, tier, sums), _ulps(_n(emu), ref, tier, sums).max()


def test_packed_weights_pack_anew_when_the_tier_changes(rng):
    """fast and fast16 pack the same tensors rounded, under keys of their
    own: a parity or fasthi pack is never served to them, and each tier's
    pack is cached once."""
    ws = [torch.from_numpy(rng.randn(8, 8, 3, 3).astype(np.float32))]
    bs = [torch.from_numpy(rng.randn(8).astype(np.float32))]
    keys = {(dt, c): conv_chain.layout(dt, c)[0]
            for dt, c in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                          (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32),
                          (torch.float16, torch.float16))}
    assert len(set(keys.values())) == 4  # fasthi and parity share the TF32 pack
    tkeys = {tail.layout(dt, 4, c)[0] for dt, c in keys}
    assert len(tkeys) == 4 and not tkeys & set(keys.values())
    with pytest.raises(TypeError):  # a 2-byte tier's activations are of its dtype
        conv_chain.layout(torch.float16, torch.bfloat16)
    before = conv_chain.packs
    for _ in range(2):
        for tier in ("parity", "fasthi", "fast", "fasthi16", "fast16"):
            nm = config._MODES[tier]
            key, pack = conv_chain.layout(nm.activation_dtype, nm.compute_dtype)
            got = conv_chain.packed_weights(key, ws, bs, pack)
            if tier in ("fast", "fast16"):
                wq, sb = got
                assert wq.dtype == nm.compute_dtype
                assert torch.equal(wq, conv_chain.pack_chain_2byte(ws, bs, nm.compute_dtype)[0])
                assert torch.equal(sb[8:], bs[0].to(nm.compute_dtype).float())
    assert conv_chain.packs == before + 4
    # the paths name what runs: one m16n8k16 product on f16 or bf16 operands
    assert conv_chain.path(config._MODES["fast"]) == "bf16x1"
    assert conv_chain.path(config._MODES["fast16"]) == "f16x1"
    assert conv_chain.path(config._MODES["fasthi16"]) == "f16"
    assert conv_chain.path(config._MODES["mixed"]) == "tf32x3"
    assert conv_chain.path(config._MODES["fasthi"]) == "tf32x2"
    paths = {conv_chain.path(config._MODES[t]) for t in config.modes()}
    assert paths == set(conv_chain.launches_by_path) == set(tail.launches_by_path)


@pytest.mark.parametrize("mid", [3, 11])
def test_fast16_overflow_models_stay_finite(rng, mid):
    """The port's counterpart of tests/test_numerics_tiers.py: FMEN and
    AALN, dr=255 models with 1e5-scale pre-activations, stay finite under
    fast16 (saturating casts, the f16 clamp after each bias add, f32 sums of
    f16 reductions, AALN's f32 statistics)."""
    model, name, dr, _ = registry.build_model(mid, device="cpu")
    x = torch.from_numpy(rng.rand(1, 48, 48, 3).astype(np.float32) * dr)
    with torch.inference_mode(), config.numerics_mode("fast16"):
        y = model(x)
    assert y.dtype == torch.float16
    assert bool(torch.isfinite(y).all()), f"{name}: fast16 produced non-finite values"


# RLFN under each tier against JAX rlfn_apply, (mean, max) of |port - JAX|
# at data range 255 on numpy seed 0's 40x40 uniform input. Every 2-byte
# rounding that the two frameworks' f32 sums put on different sides of a
# boundary is carried on through the four RLFBs, so the bound is twice what
# JAX's own output moves by when its input moves by 1e-4 (measured: fast
# mean 0.79 / max 8.0, port against JAX 0.84 / 8.0; fast16 0.12 / 1.25,
# port 0.21 / 2.0). mixed is f32 on both sides: port against JAX measured
# 1e-4 / 8e-4.
RLFN_BOUNDS = {"fast": (1.6, 16.0), "fast16": (0.3, 2.5), "mixed": (2e-4, 2e-3)}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_rlfn_matches_jax(tier):
    model = registry.build_model(4, device="cpu")[0]
    params = jregistry.load_params(jregistry.get_spec(4))
    x = np.random.RandomState(0).rand(1, 40, 40, 3).astype(np.float32) * 255.0
    ref = _jax(lambda p, v: jrlfn.rlfn_apply(p, v), tier, params, x)
    with torch.inference_mode(), config.numerics_mode(tier):
        out = model(torch.from_numpy(x))
    assert out.dtype == TIERS[tier][1]
    d = np.abs(out.float().numpy() - ref)
    mean_bound, max_bound = RLFN_BOUNDS[tier]
    assert d.mean() <= mean_bound and d.max() <= max_bound, (d.mean(), d.max())
