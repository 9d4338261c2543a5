"""The port's ops (ntire2022_esr_tpu_torch.ops) against the JAX ops on the
same seeded numpy inputs, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu_torch import config, ops, porter

# One f16 ulp is at most 2**-10 of the value; 2**-9 also covers a rounding
# flip at a binade edge. The two frameworks sum the f32 contraction in
# different orders, so an f16 store may round either way.
F16_RTOL = 2.0 ** -9


def _t(a):
    """NHWC numpy -> the port's channels_last NCHW tensor."""
    return ops.from_nhwc(torch.from_numpy(np.ascontiguousarray(a)))


def _n(t):
    return ops.to_nhwc(t).float().numpy()


@pytest.mark.parametrize("tier", ["parity", "fasthi16"])
@pytest.mark.parametrize("k,stride,padding", [(3, 1, None), (3, 2, 0), (1, 1, 0)])
def test_conv2d_matches_jax(rng, tier, k, stride, padding):
    x = rng.randn(2, 13, 11, 6).astype(np.float32) * 3
    w = rng.randn(k, k, 6, 8).astype(np.float32) * 0.2  # HWIO
    b = rng.randn(8).astype(np.float32)
    act = np.float16 if tier == "fasthi16" else np.float32
    x = x.astype(act)
    with jconfig.numerics_mode(tier):
        ref = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     stride=stride, padding=padding))
    flat = porter.to_torch({"c": {"weight": w, "bias": b}})
    with config.numerics_mode(tier):
        out = ops.conv2d(_t(x), flat["c.weight"], flat["c.bias"], stride=stride, padding=padding)
    assert out.dtype == (torch.float16 if tier == "fasthi16" else torch.float32)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert ref.dtype == act
    # parity: both f32, only the summation order differs
    rtol, atol = (F16_RTOL, 1e-6) if tier == "fasthi16" else (1e-5, 1e-5)
    np.testing.assert_allclose(_n(out), ref.astype(np.float32), rtol=rtol, atol=atol)


def test_store_out_saturates_like_jax():
    v = np.array([-1e5, -70000.0, -65504.0, -1.5, 0.0, 2.25, 65519.0, 1e5], np.float32)
    with jconfig.numerics_mode("fasthi16"):
        ref = np.asarray(jops.nn.store_out(jnp.asarray(v), jconfig.numerics()))
    with config.numerics_mode("fasthi16"):
        out = ops.store_out(torch.from_numpy(v), config.numerics())
    assert out.dtype == torch.float16
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.numpy()[0] == -65504.0 and out.numpy()[-1] == 65504.0
    assert np.isfinite(out.numpy()).all()


def test_conv2d_saturates_at_f16_max(rng):
    """A conv whose f32 sums pass the f16 range stores +-65504, not inf."""
    x = (rng.rand(1, 5, 5, 4).astype(np.float32) * 6e4).astype(np.float16)
    w = np.ones((3, 3, 4, 2), np.float32)
    w[..., 1] *= -1
    with jconfig.numerics_mode("fasthi16"):
        ref = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w)))
    with config.numerics_mode("fasthi16"):
        out = _n(ops.conv2d(_t(x), porter.to_torch({"c": {"weight": w}})["c.weight"]))
    np.testing.assert_array_equal(out, ref.astype(np.float32))
    assert out.max() == 65504.0 and out.min() == -65504.0


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_leaky_relu_matches_jax(rng, dtype):
    x = (rng.randn(3, 7, 5, 4) * 100).astype(dtype)
    ref = np.asarray(jops.leaky_relu(jnp.asarray(x), 0.05))
    out = _n(ops.leaky_relu(_t(x), 0.05))
    # elementwise, one rounding each: identical
    np.testing.assert_array_equal(out, ref.astype(np.float32))


@pytest.mark.parametrize("hw", [(19, 19), (30, 19)])
def test_max_pool2d_floor_mode(rng, hw):
    x = rng.randn(2, hw[0], hw[1], 5).astype(np.float32)
    ref = np.asarray(jops.max_pool2d(jnp.asarray(x), 7, 3))
    out = _n(ops.max_pool2d(_t(x), 7, 3))
    assert out.shape == ref.shape == (2, (hw[0] - 7) // 3 + 1, (hw[1] - 7) // 3 + 1, 5)
    np.testing.assert_array_equal(out, ref)


def test_pixel_shuffle_torch_order(rng):
    x = rng.randn(2, 3, 5, 48).astype(np.float32)
    ref = np.asarray(jops.pixel_shuffle(jnp.asarray(x), 4))
    out = _n(ops.pixel_shuffle(_t(x), 4))
    np.testing.assert_array_equal(out, ref)
    # out[n, 4h+i, 4w+j, c] == x[n, h, w, 16c + 4i + j]
    assert out[1, 4 * 2 + 3, 4 * 4 + 1, 2] == x[1, 2, 4, 16 * 2 + 4 * 3 + 1]


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("src,dst", [((5, 7), (19, 13)), ((9, 4), (40, 23)), ((3, 3), (63, 41))])
def test_bilinear_interpolate_matches_jax(rng, dtype, src, dst):
    x = (rng.randn(2, src[0], src[1], 3) * 10).astype(dtype)
    ref = np.asarray(jops.interpolate(jnp.asarray(x), size=dst, mode="bilinear"))
    out = ops.interpolate(_t(x), size=dst, mode="bilinear")
    assert out.dtype == _t(x).dtype and out.is_contiguous(memory_format=torch.channels_last)
    # f32: the same matrices, sums in another order; f16: the matrices and
    # the row pass are rounded to f16 in both, so one ulp at most
    rtol, atol = (F16_RTOL, 1e-3) if dtype == np.float16 else (1e-5, 1e-5)
    np.testing.assert_allclose(_n(out), ref.astype(np.float32), rtol=rtol, atol=atol)


def test_int8_weights_raise():
    """A w8 tree converts (int8 OIHW beside its scale, tests/test_torch_w8.py
    holds the values), but an int8 weight that reaches conv2d raw, or
    comes without its scale, raises: nothing casts it silently."""
    sd = porter.to_torch({"c": {"weight": np.zeros((3, 3, 2, 5), np.int8),
                                "weight_scale": np.ones((1, 1, 2, 5), np.float32)}})
    assert sd["c.weight"].dtype == torch.int8 and tuple(sd["c.weight"].shape) == (5, 2, 3, 3)
    assert tuple(sd["c.weight_scale"].shape) == (5, 2, 1, 1)
    with pytest.raises(TypeError, match="int8"):
        ops.conv2d(torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 3, 3, dtype=torch.int8))
    with pytest.raises(TypeError, match="weight_scale"):
        ops.nn.dequant(torch.zeros(2, 2, 3, 3, dtype=torch.int8), None)


def test_tiers_turn_tf32_off():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    with config.numerics_mode("fasthi16"):
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert config.numerics().activation_dtype == torch.float16
    assert config.mode() == "parity"
    torch.backends.cudnn.allow_tf32 = True
    with config.numerics_mode("fast16"):  # a 2-byte tier turns it off too
        assert not torch.backends.cudnn.allow_tf32
        assert config.numerics().compute_dtype == torch.float16
    assert config.mode() == "parity"
    with pytest.raises(ValueError, match="unknown numerics mode"):
        config.set_mode("w8")


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("per_channel", [True, False])
def test_relu_prelu_match_jax(rng, dtype, per_channel):
    x = rng.randn(2, 7, 5, 6).astype(np.float32) * 3
    w = rng.rand(6 if per_channel else 1).astype(np.float32) * 0.5
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    jx = jnp.asarray(x).astype(jnp.float32 if dtype == np.float32 else jnp.bfloat16)
    xt = _t(x).to(tdt)
    np.testing.assert_array_equal(_n(ops.prelu(xt, torch.from_numpy(w))),
                                  np.asarray(jops.prelu(jx, jnp.asarray(w))).astype(np.float32))
    np.testing.assert_array_equal(_n(ops.relu(xt)), np.asarray(jops.relu(jx)).astype(np.float32))


def test_pixel_unshuffle_and_cat_match_jax(rng):
    x = rng.randn(2, 8, 6, 5).astype(np.float32)
    y = ops.pixel_unshuffle(_t(x), 2)
    np.testing.assert_array_equal(_n(y), np.asarray(jops.pixel_unshuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(_n(ops.pixel_shuffle(y, 2)), x)
    z = rng.randn(2, 4, 3, 7).astype(np.float32)
    c = ops.cat([y, _t(z)])
    assert c.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_n(c), np.concatenate([_n(y), z], axis=-1))
