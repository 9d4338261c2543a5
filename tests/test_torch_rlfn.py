"""The port's RLFN slice (model 04) on the CPU: against the torch-reference
goldens, against the JAX ``rlfn_apply`` under parity and fasthi16, the
weight carry, and the uint8 server against the JAX server."""

import os

import numpy as np
import pytest
import torch

import jax

from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu.harness import registry as jregistry
from ntire2022_esr_tpu.models import blocks as jblocks
from ntire2022_esr_tpu.models import rlfn as jrlfn
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu_torch import config, ops, porter
from ntire2022_esr_tpu_torch.harness import envelope, registry, serving

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def model():
    return registry.build_model(4, device="cpu")[0]


@pytest.fixture(scope="module")
def jparams():
    return jregistry.load_params(jregistry.get_spec(4))


def _x40():
    return np.random.RandomState(0).rand(1, 40, 40, 3).astype(np.float32) * 255.0


def _jax_rlfn(jparams, x, tier):
    # a fresh function per tier: jax.jit caches on the function object and
    # would silently reuse a trace made under another tier
    with jconfig.numerics_mode(tier):
        return np.asarray(jax.jit(lambda p, v: jrlfn.rlfn_apply(p, v))(jparams, x)).astype(np.float32)


@pytest.mark.parametrize("stem", ["model_04", "model_04_63x41"])
def test_rlfn_matches_golden(model, stem):
    g = np.load(os.path.join(GOLDEN_DIR, f"{stem}.npz"))
    img, data_range, ref = g["input_u8"], float(g["data_range"]), g["output"]
    x = torch.from_numpy((img.astype(np.float32) / (255.0 / data_range))[None])
    with torch.inference_mode():
        out = model(x).numpy()[0]
    assert out.shape == ref.shape
    # the bar of tests/test_model_parity.py
    err = np.abs(out - ref).max()
    assert err < 2e-4 * data_range, err


def test_rlfn_matches_jax_parity(model, jparams):
    x = _x40()
    ref = _jax_rlfn(jparams, x, "parity")
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 160, 160, 3)
    # f32 both, sums in another order; outputs span 0..255
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


def test_rlfn_matches_jax_fasthi16(model, jparams):
    """Whole model under fasthi16. Every conv output is rounded to f16, and
    where the two frameworks' f32 sums differ in the last bits an f16 store
    rounds the other way; the network amplifies such one-ulp flips. JAX's
    own fasthi16 output moves by mean 0.12 / max 1.0 when its f32 input
    moves by 1e-4 (parity: 1e-4 / 8e-4), and the tier deviates from parity
    by mean 0.18 / max 1.95. So the bound here is that scale, mean 0.3 /
    max 2.5; the per-module test below holds each module tightly."""
    x = _x40()
    ref = _jax_rlfn(jparams, x, "fasthi16")
    with torch.inference_mode(), config.numerics_mode("fasthi16"):
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float16
    d = np.abs(out.float().numpy() - ref)
    assert d.mean() <= 0.3 and d.max() <= 2.5, (d.mean(), d.max())


def test_rlfn_modules_match_jax_fasthi16(model, jparams):
    """Each module of the fasthi16 graph fed the same (JAX's) input: equal
    up to f16 stores that round the other way, a few ulps."""
    p = jparams
    x = _x40()
    to_t = lambda a: ops.from_nhwc(torch.from_numpy(np.array(a)))  # noqa: E731
    to_n = lambda t: ops.to_nhwc(t).float().numpy()  # noqa: E731

    def check(tag, ref, out):
        ref = np.asarray(ref).astype(np.float32)
        d = np.abs(out - ref)
        # at most 8 f16 ulps of the largest value, an eighth of one on average
        top = np.abs(ref).max()
        assert d.max() <= 2.0 ** -7 * top, (tag, d.max())
        assert d.mean() <= 2.0 ** -13 * top, (tag, d.mean())

    with jconfig.numerics_mode("fasthi16"), config.numerics_mode("fasthi16"), \
            torch.inference_mode():
        fea = np.asarray(jax.jit(lambda q, v: jops.conv(q["fea_conv"], v))(p, x))
        check("fea_conv", fea, to_n(ops.conv(model.fea_conv, to_t(x))))
        h = fea
        for i in range(1, 5):
            nxt = np.asarray(jax.jit(lambda q, v: jrlfn.rlfb(q, v))(p[f"B{i}"], h))
            check(f"B{i}", nxt, to_n(getattr(model, f"B{i}")(to_t(h))))
            h = nxt
        lr = np.asarray(jax.jit(lambda q, v, f: jops.conv(q["LR_conv"], v) + f)(p, h, fea))
        check("LR_conv", lr, to_n(ops.conv(model.LR_conv, to_t(h)) + to_t(fea)))
        up = np.asarray(jax.jit(lambda q, v: jops.pixel_shuffle(
            jops.conv(jblocks.seq(q["upsampler"], 0), v), 4))(p, lr))
        from ntire2022_esr_tpu_torch.ops.kernels import fused_conv3x3_pixelshuffle

        u = model.upsampler[0]
        check("upsampler", up, to_n(fused_conv3x3_pixelshuffle(to_t(lr), u.weight, u.bias)))


def test_weight_carry_consumes_every_key(model, jparams):
    flat = porter.to_torch(jparams)
    state = model.state_dict()
    assert set(flat) == set(state) and len(flat) == 78
    for k, v in flat.items():
        assert v.shape == state[k].shape, k
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    # HWIO -> OIHW
    np.testing.assert_array_equal(flat["B1.c1_r.weight"].numpy(),
                                  jparams["B1"]["c1_r"]["weight"].transpose(3, 2, 0, 1))


def test_registry_ports_model_4_only():
    """The exact set of ported ids, the whole zoo: RLFN (04), the RFDN
    skeleton and IMDN family, the rest of the conv zoo (the third slice's
    ten models and the fourth's twelve), the attention family (09, 12, 20,
    30) and NLFFC (02); an id the zoo withholds (7) is refused as not in
    the registry."""
    spec = registry.get_spec(4)
    assert (spec.name, spec.data_range, spec.tile) == ("04_RLFN", 255.0, None)
    assert sorted(registry._REGISTRY) == [-1, 0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15,
                                          16, 17, 18, 19, 20, 22, 23, 24, 25, 26, 27, 28, 29,
                                          30, 31, 33, 34, 35, 36, 37, 38, 39, 40, 42, 43, 44]
    with pytest.raises(KeyError, match="not in the registry .withheld submissions: 7"):
        registry.get_spec(7)


def test_server_default_tier_is_gated():
    """JAX's envelope gates RLFN at fasthi16; the server takes the card's."""
    assert serving.gated_tier("04_RLFN", envelope.TPU_PATH) == "fasthi16"
    assert serving.SRServer(model_id=4, device="cpu").tier == envelope.plan_for(4).tier


@pytest.mark.parametrize("tier", ["parity", "fasthi16"])
def test_server_matches_jax_server(tier):
    from ntire2022_esr_tpu.harness.serving import SRServer as JaxServer

    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 256, (24, 20, 3), dtype=np.uint8) for _ in range(5)]
    frames.append(rs.randint(0, 256, (19, 17, 3), dtype=np.uint8))  # a shape change flushes
    with jconfig.numerics_mode(tier):
        jsrv = JaxServer(model_id=4, max_batch=4)
        ref = list(jsrv.process_stream(frames))
        ref_one = jsrv.process_one(frames[-1])
    srv = serving.SRServer(model_id=4, max_batch=4, depth=2, device="cpu", tier=tier)
    out = list(srv.process_stream(frames))
    out_one = srv.process_one(frames[-1])
    assert [o.shape for o in out] == [r.shape for r in ref]
    assert all(o.dtype == np.uint8 for o in out) and out_one.dtype == np.uint8
    d = np.concatenate([np.abs(o.astype(int) - r.astype(int)).ravel()
                        for o, r in zip(out + [out_one], ref + [ref_one])])
    if tier == "parity":
        assert d.max() <= 1
    else:
        # fasthi16's one-ulp f16 flips (see test_rlfn_matches_jax_fasthi16)
        # move some outputs across a rounding boundary: measured 12% of
        # pixels 1 level apart, 0.02% 2 levels apart
        assert d.max() <= 2 and (d > 1).mean() < 1e-3 and d.mean() < 0.2, (d.max(), d.mean())


def test_bucketed_throughput_counts_frames():
    srv = serving.SRServer(model_id=4, max_batch=2, device="cpu", tier="parity")
    frames = [np.zeros((24, 24, 3), np.uint8)] * 3
    stats = serving.bucketed_throughput(srv, frames)
    assert stats["images"] == 3 and stats["images_per_sec"] > 0
