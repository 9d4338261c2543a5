"""The HR tails on the CPU: LWFANet (27), NASNetBN (28) and m_RFDN (33),
the settings and ops they read (``config.hr_tail``, ``hr_tail_scope``,
``fuse_upsample_conv``; ``ops.fused``, ``ops.batch_norm``, nearest
``ops.interpolate``) and the tail kernel's plain version at r = 2, against
the JAX package (checks of the zoo in ``tests/test_torch_zoo_cases.py``).

Under ``high`` the three models run their full-resolution tail under the
2-byte tier ``fast`` (JAX's ``hr_tail`` AUTO), its x2 upsamplers through
the tail kernel at r = 2: 64 -> 256 (27), 32 -> 128 (28), 52 -> 208 and
24 -> 96 (33). On a CPU tensor the kernel's wrapper runs its plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import test_torch_zoo_cases as cases
from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu.ops import fused as jfused
from ntire2022_esr_tpu.models import m_rfdn as jmrfdn
from ntire2022_esr_tpu.models import misc_conv as jmisc
from ntire2022_esr_tpu.models import nasnetbn as jnas
from ntire2022_esr_tpu_torch import config, ops, porter
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.ops import fused
from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail

# tier of each model in results/protocol/zoo_sustained_gated.json
GATED = {27: "high", 28: "high", 33: "high"}
IDS = sorted(GATED)
TIERS = ["parity", "high", "mixed", "fast", "fast16", "fasthi", "fasthi16"]
SITES = ["m_rfdn", "lwfanet", "nasnetbn", "mobilesr", "rfdb"]  # the AUTO sites and one other
# the x2 upsamplers of the HR tails: (cin, cout) of the conv before the shuffle
R2_WIDTHS = [(24, 24), (32, 32), (52, 52), (64, 64)]
BF16_ULP = 2.0 ** -7


@pytest.fixture
def auto_settings():
    """Both frameworks' HR-tail settings on AUTO, restored afterwards."""
    saved = (jconfig.hr_tail_override(), jconfig._fuse_upsample_conv,
             config._hr_tail, config._fuse_upsample_conv)
    jconfig.set_hr_tail(None)
    jconfig.set_fuse_upsample_conv(None)
    config.set_hr_tail(None)
    config.set_fuse_upsample_conv(None)
    yield
    jconfig.set_hr_tail(saved[0])
    jconfig.set_fuse_upsample_conv(saved[1])
    config.set_hr_tail(saved[2])
    config.set_fuse_upsample_conv(saved[3])


# -- the zoo checks --------------------------------------------------------------

@pytest.mark.parametrize("stem", cases.goldens(IDS))
def test_matches_golden(stem):
    cases.check_golden(stem)


@pytest.mark.parametrize("mid", IDS)
def test_matches_jax_parity(mid):
    cases.check_jax_parity(mid)


@pytest.mark.parametrize("mid", IDS)
def test_blocks_match_jax_gated_tier(mid):
    cases.check_blocks(mid, GATED[mid])


@pytest.mark.parametrize("mid", IDS)
def test_complexity_matches_jax(mid):
    cases.check_complexity(mid)


@pytest.mark.parametrize("mid", IDS)
def test_weight_carry_consumes_every_key(mid):
    cases.check_weight_carry(mid)


@pytest.mark.parametrize("mid", IDS)
def test_registry_fields_match_jax(mid):
    cases.check_registry_fields(mid)


@pytest.mark.parametrize("mid", IDS)
def test_server_tier(mid):
    cases.check_server_tier(mid, GATED[mid])


# -- the settings ----------------------------------------------------------------

@pytest.mark.parametrize("tier", TIERS)
def test_hr_tail_settings_match_jax(auto_settings, tier):
    with jconfig.numerics_mode(tier), config.numerics_mode(tier):
        assert config.fuse_upsample_conv() == jconfig.fuse_upsample_conv()
        for site in SITES:
            assert config.hr_tail(site) == jconfig.hr_tail(site), site
    # forced, every site takes the forced value under every tier
    for value in ("off", "bf16", "f16"):
        jconfig.set_hr_tail(value)
        config.set_hr_tail(value)
        with jconfig.numerics_mode(tier), config.numerics_mode(tier):
            assert [config.hr_tail(s) for s in SITES] == [jconfig.hr_tail(s) for s in SITES]
    for value in (True, False):
        jconfig.set_fuse_upsample_conv(value)
        config.set_fuse_upsample_conv(value)
        with jconfig.numerics_mode(tier), config.numerics_mode(tier):
            assert config.fuse_upsample_conv() == jconfig.fuse_upsample_conv() == value


def test_hr_tail_scope_sets_and_restores_the_tier(auto_settings):
    with config.numerics_mode("high"):
        with config.hr_tail_scope("m_rfdn") as t:
            assert t == "bf16" and config.mode() == "fast"
        assert config.mode() == "high"
        with config.hr_tail_scope("rfdb") as t:
            assert t == "" and config.mode() == "high"
        with pytest.raises(RuntimeError, match="inside"):
            with config.hr_tail_scope("lwfanet"):
                raise RuntimeError("inside the scope")
        assert config.mode() == "high"
        config.set_hr_tail("f16")
        with config.hr_tail_scope("nasnetbn") as t:
            assert t == "f16" and config.mode() == "fast16"
        assert config.mode() == "high"
    config.set_hr_tail(None)
    with config.numerics_mode("parity"), config.hr_tail_scope("m_rfdn") as t:
        assert t == "" and config.mode() == "parity"
    with pytest.raises(ValueError):
        config.set_hr_tail("f32")


# -- the ops -----------------------------------------------------------------------

def test_nearest2_conv_weights_match_jax(rng):
    """The low-resolution taps equal JAX's to one f32 ulp: the sums of two
    or four coincident weights, in f32, maybe in another order."""
    w = rng.randn(3, 3, 6, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    params = porter.load_params(cases.registry.weights_path(cases.registry.get_spec(33)))
    for w_hwio, b_ in ((w, b), (params["upconv1"]["weight"], params["upconv1"]["bias"])):
        w4j, b4j = jfused.nearest2_conv_weights(jnp.asarray(w_hwio), jnp.asarray(b_))
        w4, b4 = fused.nearest2_conv_weights(porter.to_torch({"c": {"weight": w_hwio}})["c.weight"],
                                             torch.from_numpy(b_))
        ref = porter.to_torch({"c": {"weight": np.asarray(w4j)}})["c.weight"]
        assert w4.shape == ref.shape and w4.dtype == torch.float32
        ulp = torch.finfo(torch.float32).eps * ref.abs().clamp_min(torch.finfo(torch.float32).tiny)
        assert bool(((w4 - ref).abs() <= ulp).all())
        assert torch.equal(b4, torch.from_numpy(np.array(b4j)))


@pytest.mark.parametrize("hw", [(7, 9), (4, 4)])
def test_nearest2_conv_is_conv_of_nearest_upsample(rng, hw):
    """Under f32 the fused form (the tail's plain version at r = 2 on the
    low-resolution taps) equals the conv of the nearest-x2 upsampled input
    up to the f32 reassociation of the summed taps."""
    x = ops.from_nhwc(torch.from_numpy(rng.randn(2, *hw, 6).astype(np.float32)))
    w = torch.from_numpy(rng.randn(5, 6, 3, 3).astype(np.float32) * 0.1)
    b = torch.from_numpy(rng.randn(5).astype(np.float32))
    w4, b4 = fused.nearest2_conv_weights(w, b)
    with config.numerics_mode("parity"):
        out = fused.nearest2_conv(x, w4, b4)
        ref = ops.conv2d(ops.interpolate(x, scale_factor=2, mode="nearest"), w, b)
    assert out.shape == ref.shape == (2, 5, 2 * hw[0], 2 * hw[1])
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_upconv_nearest2_follows_the_setting(auto_settings, rng):
    """``upconv_nearest2`` takes the fused form where the setting is on
    (every tier but parity) and the nearest upsample + conv under parity;
    both equal JAX's under f32."""
    layer = blocks.Nearest2Layer()
    w = rng.randn(3, 3, 4, 6).astype(np.float32) * 0.1
    b = rng.randn(6).astype(np.float32)
    layer.load_state_dict(porter.to_torch({"weight": w, "bias": b}))
    x = rng.randn(1, 5, 7, 4).astype(np.float32)
    for tier in ("parity", "high"):
        with jconfig.numerics_mode(tier):
            q = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
            ref = np.asarray(jfused.upconv_nearest2(q, jnp.asarray(x)))
        calls = []
        with config.numerics_mode(tier), pytest.MonkeyPatch.context() as mp:
            mp.setattr(fused, "nearest2_conv",
                       lambda *a: calls.append(1) or fused.conv_pixelshuffle(*a, 2))
            out = ops.to_nhwc(fused.upconv_nearest2(layer, ops.from_nhwc(torch.from_numpy(x))))
        assert len(calls) == (tier != "parity")
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_nearest2_weights_are_derived_and_packed_once(rng):
    """A Nearest2Layer derives w4 and b4 when its weights are loaded and
    keeps them: two forwards hand the kernel's packing the same tensors,
    so the packed-weight cache packs once; loading a new weight set makes
    new ones, and those are packed anew."""
    model, _, _ = cases.port_model(33)
    layer = model.upconv1
    assert "w4" not in model.state_dict() and layer.w4.shape == (208, 52, 3, 3)
    seen = []
    with config.numerics_mode("high"), torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused, "conv_pixelshuffle", lambda x, w, b, r: seen.append((w, b)) or
                   tail.conv3x3_pixelshuffle_plain(x.to(torch.bfloat16), w, b, r=r))
        x = torch.from_numpy(rng.rand(1, 24, 20, 3).astype(np.float32))
        model(x)
        model(x)
    assert len(seen) == 4 and seen[0][0] is seen[2][0] is layer.w4 and seen[0][1] is layer.b4
    key, pack = tail.layout(torch.bfloat16, 2, torch.bfloat16, 4)
    before = conv_chain.packs
    first = tail.packed_weights(key, [layer.w4], [layer.b4], pack)
    again = tail.packed_weights(key, [layer.w4], [layer.b4], pack)
    assert conv_chain.packs == before + 1 and again[0] is first[0]
    old = layer.w4
    fresh = blocks.Nearest2Layer()
    sd = {k: v.clone() * 2 for k, v in layer.state_dict().items()}
    fresh.load_state_dict(sd)
    assert fresh.w4 is not old and torch.equal(fresh.w4, old * 2)
    tail.packed_weights(key, [fresh.w4], [fresh.b4], pack)
    assert conv_chain.packs == before + 2


@pytest.mark.parametrize("tier,dtype", [("parity", np.float32), ("fasthi", jnp.bfloat16)])
def test_batch_norm_matches_jax(rng, tier, dtype):
    """Inference BatchNorm: under f32 within 4 f32 ulps of the largest
    value of JAX's (measured 1.7: the terms cancel where the result is
    small); on bf16 activations the port rounds once from f32 and JAX each
    op in bf16: at most one bf16 ulp of the largest value apart, a quarter
    of one on average."""
    c = 7
    p = {"weight": rng.rand(c).astype(np.float32) + 0.5, "bias": rng.randn(c).astype(np.float32),
         "running_mean": rng.randn(c).astype(np.float32),
         "running_var": rng.rand(c).astype(np.float32) + 0.1}
    x = np.asarray(jnp.asarray(rng.randn(2, 5, 6, c).astype(np.float32) * 3).astype(dtype))
    with jconfig.numerics_mode(tier):
        ref = np.asarray(jops.batch_norm({k: jnp.asarray(v) for k, v in p.items()},
                                         jnp.asarray(x))).astype(np.float32)
    layer = blocks.Layer(("weight", "bias", "running_mean", "running_var"))
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    xt = ops.from_nhwc(torch.from_numpy(x.astype(np.float32))).to(
        torch.float32 if dtype == np.float32 else torch.bfloat16)
    with config.numerics_mode(tier):
        out = ops.to_nhwc(ops.batch_norm(layer, xt)).float().numpy()
    top = np.abs(ref).max()
    d = np.abs(out - ref)
    if dtype == np.float32:
        assert d.max() <= 4 * np.finfo(np.float32).eps * top, d.max() / top
    else:
        assert d.max() <= BF16_ULP * top and d.mean() <= BF16_ULP / 4 * top, (d.max(), d.mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("size", [(10, 14), (7, 5), (12, 21)])
def test_nearest_interpolate_matches_jax(rng, dtype, size):
    """Nearest resize moves values without changing them: equal to JAX's
    at integer factors (a repeat) and at others (one-hot matrices)."""
    x = rng.randn(1, 5, 7, 3).astype(np.float32)
    xt = ops.from_nhwc(torch.from_numpy(x)).to(dtype)
    ref = np.asarray(jops.interpolate(jnp.asarray(xt.float().numpy().transpose(0, 2, 3, 1)),
                                      size=size, mode="nearest"))
    out = ops.to_nhwc(ops.interpolate(xt, size=size, mode="nearest")).float().numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("cin,cout", R2_WIDTHS)
def test_tail_plain_matches_pallas_r2(rng, cin, cout, monkeypatch):
    """The tail's plain version at r = 2 and the HR tails' widths against
    the Pallas tail in interpret mode, f32 (the bar of
    tests/test_pallas_kernels.py)."""
    from ntire2022_esr_tpu.ops.pallas import fused_conv3x3_pixelshuffle as pallas_tail

    monkeypatch.setattr(pl, "pallas_call", __import__("functools").partial(pl.pallas_call,
                                                                          interpret=True))
    x = rng.randn(2, 9, 11, cin).astype(np.float32) * 0.5
    w = rng.randn(3, 3, cin, 4 * cout).astype(np.float32) * 0.05
    b = rng.randn(4 * cout).astype(np.float32) * 0.1
    ref = np.asarray(pallas_tail(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), r=2))
    out = tail.fused_conv3x3_pixelshuffle(ops.from_nhwc(torch.from_numpy(x)),
                                          porter.to_torch({"c": {"weight": w}})["c.weight"],
                                          torch.from_numpy(b), r=2)
    assert out.shape == (2, cout, 18, 22)
    np.testing.assert_allclose(ops.to_nhwc(out).numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cin,cout", R2_WIDTHS)
@pytest.mark.parametrize("groups", [4, 8])
def test_pack_tail_groups_are_stages(rng, cin, cout, groups):
    """With channel groups the packs hold one stage a group: the shuffled
    channels split into equal runs, each packed as the one-group packing
    of that run would pack it, one after the other."""
    w = torch.from_numpy(rng.randn(4 * cout, cin, 3, 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(4 * cout).astype(np.float32))
    ws, bs = tail.channel_groups(w, b, 2, groups)
    order = tail.shuffled_order(cout, 2)
    assert torch.equal(torch.cat(ws), w[order]) and torch.equal(torch.cat(bs), b[order])
    for packing, one in ((lambda g: tail.pack_tail_tf32(w, b, 2, g), conv_chain.pack_chain_tf32),
                         (lambda g: tail.pack_tail_f16(w, b, 2, g), conv_chain.pack_chain_f16),
                         (lambda g: tail.pack_tail_2byte(w, b, 2, torch.bfloat16, g),
                          lambda a, c: conv_chain.pack_chain_2byte(a, c, torch.bfloat16))):
        wq, sb = packing(groups)
        parts = [one([wg], [bg]) for wg, bg in zip(ws, bs)]
        assert torch.equal(wq, torch.cat([p[0] for p in parts]))
        assert torch.equal(sb, torch.cat([p[1] for p in parts]))


# -- the HR tails under high against JAX's ------------------------------------------

def _pa_port(m, v):
    return v * ops.sigmoid(ops.conv(m.conv, v, padding=0))


def _pa_jax(q, v):
    return v * jops.sigmoid(jops.conv(q["conv"], v, padding=0))


def _tail_modules(mid, m, p):
    """(site, JAX body, [(name, port module fn, JAX fn)]) of the model's HR
    tail, each module taking the previous one's output."""
    if mid == 33:
        steps = []
        for k in ("1", "2"):
            up, att, hr = (getattr(m, n + k) for n in ("upconv", "att", "HRconv"))
            steps += [
                (f"upconv{k}", lambda v, up=up: fused.upconv_nearest2(up, v),
                 lambda v, k=k: jfused.upconv_nearest2(p["upconv" + k], v)),
                (f"att{k}", lambda v, att=att: ops.leaky_relu(_pa_port(att, v), 0.2),
                 lambda v, k=k: jops.leaky_relu(_pa_jax(p["att" + k], v), 0.2)),
                (f"HRconv{k}", lambda v, hr=hr: ops.leaky_relu(ops.conv(hr, v), 0.2),
                 lambda v, k=k: jops.leaky_relu(jops.conv(p["HRconv" + k], v), 0.2))]
        return "m_rfdn", jmrfdn.m_rfdn_body, steps
    if mid == 27:
        steps = [(n, lambda v, n=n: ops.leaky_relu(fused.upconv_nearest2(getattr(m, n), v), 0.2),
                  lambda v, n=n: jops.leaky_relu(jfused.upconv_nearest2(p[n], v), 0.2))
                 for n in ("conv_up1", "conv_up2")]
        steps.append(("conv_hr", lambda v: ops.leaky_relu(ops.conv(m.conv_hr, v), 0.2),
                      lambda v: jops.leaky_relu(jops.conv(p["conv_hr"], v), 0.2)))
        return "lwfanet", jmisc.lwfanet_body, steps
    steps = [(n, lambda v, n=n: ops.leaky_relu(
        fused.conv_pixelshuffle(v, getattr(m, n).weight, getattr(m, n).bias, 2), 0.1),
        lambda v, n=n: jops.leaky_relu(jops.pixel_shuffle(jops.conv(p[n], v), 2), 0.1))
        for n in ("upconv1", "upconv2")]
    steps.append(("HRconv", lambda v: ops.leaky_relu(ops.conv(m.HRconv, v), 0.1),
                  lambda v: jops.leaky_relu(jops.conv(p["HRconv"], v), 0.1)))
    return "nasnetbn", jnas.nasnetbn_body, steps


@pytest.mark.parametrize("mid", IDS)
def test_hr_tail_modules_match_jax_high(auto_settings, mid):
    """Under ``high`` each module of the HR tail (the scope's ``fast``: bf16
    activations and weights, the x2 upsamplers through the tail's plain
    version) fed JAX's own input to it, against JAX's, compiled without
    excess precision (``cases.jax_run``): within ``cases.BLOCK_BOUNDS["fast"]``,
    4 bf16 ulps of the largest value and an eighth of one on average. The
    upsamplers and convs read at most 0.45 ulps apart (flip rates 8e-6 to
    1.3e-4); m_RFDN's pixel-attention gates 1.07 ulps and 0.032 on average
    (a quarter of their values one ulp apart), where XLA's CPU sigmoid on
    bf16 is not correctly rounded and the port's is (measured on the CPU;
    the port rounds each op once from f32)."""
    model, _, _ = cases.port_model(mid)
    _, p = cases.jax_model(mid)
    site, body, steps = _tail_modules(mid, model, p)
    v = cases.jax_run(lambda q, a: body(q, a), "high", p, cases.image_crop(mid))
    top_bound, mean_bound = cases.BLOCK_BOUNDS["fast"]
    for name, port_fn, jax_fn in steps:
        def in_scope(a, jax_fn=jax_fn):
            with jconfig.hr_tail_scope(site):
                return jax_fn(a)

        with jconfig.numerics_mode("high"):
            ref = np.asarray(jax.jit(in_scope).lower(v).compile(
                compiler_options={"xla_allow_excess_precision": False})(v))
        assert ref.dtype == jnp.bfloat16, name
        with torch.inference_mode(), config.numerics_mode("high"), config.hr_tail_scope(site):
            vt = ops.from_nhwc(torch.from_numpy(np.asarray(v, np.float32)))
            vt = vt.to(torch.bfloat16) if v.dtype == jnp.bfloat16 else vt
            out = port_fn(vt)
        assert out.dtype == torch.bfloat16, name
        refn = ref.astype(np.float32)
        d, top = np.abs(ops.to_nhwc(out).float().numpy() - refn), np.abs(refn).max()
        assert d.max() <= top_bound * top, (name, d.max() / top)
        assert d.mean() <= mean_bound * top, (name, d.mean() / top)
        v = ref


@pytest.mark.parametrize("mid", IDS)
def test_model_matches_jax_high(auto_settings, mid):
    """The whole model under ``high``, its HR tail under bf16, against JAX's
    apply under ``high``. The tail's bf16 roundings are chaotic: where two
    correct implementations round one value the other way, the later layers
    carry it on. On this real image JAX's own output moves by max 3.1e-3,
    8.1e-4 and 5.9e-3 of the data range (means 1.9e-4, 1.0e-4 and 4.8e-4)
    for 27, 28 and 33 when its input moves by 1e-4 of it, and the port
    differs from JAX by max 1.0e-3, 3.1e-4 and 6.3e-3 (means 1.1e-5, 6.1e-6
    and 7.5e-4; measured on the CPU). Held, as ROADMAP §3 item 5 holds
    fasthi16, to twice JAX's own move on this input, computed here. Under
    ``high`` the tail keeps the output off the parity one by means of
    5.8e-4, 6.9e-5 and 1.0e-3 of the data range."""
    model, _, dr = cases.port_model(mid)
    apply, params = cases.jax_model(mid)
    x = cases.image_crop(mid)
    ref = cases.jax_run(apply, "high", params, x)
    moved = cases.jax_run(apply, "high", params, x + np.float32(1e-4 * dr))
    with torch.inference_mode(), config.numerics_mode("high"):
        out = model(torch.from_numpy(x))
        assert out.dtype == torch.float32 and config.mode() == "high"
    d, own = np.abs(out.numpy() - ref), np.abs(moved - ref)
    assert d.max() <= 2 * own.max() and d.mean() <= 2 * own.mean(), (
        d.max() / dr, d.mean() / dr, own.max() / dr, own.mean() / dr)
