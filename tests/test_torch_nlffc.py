"""NLFFC (02) and what it needs, on the CPU against the JAX package: the
spectral ops (``ops/spectral.py``), ``block_diag_weights`` and
``concat_biases``, the FFCU block's merged 3x3 pair (JAX's
``fuse_parallel_branches("nlffc")``), the f16 softmax of a flat map, and
the model against its goldens, JAX's ``nlffc_apply`` under three tiers and
JAX's complexity count. Inputs are made from numpy seeds."""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_zoo_cases as cases
from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu.harness import summary as jsummary
from ntire2022_esr_tpu.models import nlffc as jnlffc
from ntire2022_esr_tpu.ops import spectral as jspectral
from ntire2022_esr_tpu_torch import config, ops
from ntire2022_esr_tpu_torch.harness import registry, summary
from ntire2022_esr_tpu_torch.ops import spectral

TIERS = ["parity", "high", "mixed", "fast", "fast16", "fasthi", "fasthi16"]


def _nhwc(rs, shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


# -- the spectral ops -----------------------------------------------------------

@pytest.mark.parametrize("h", [16, 64, 256])
def test_rfft_h_matches_jax_and_numpy(h):
    """f32 products on both sides, sums in another order: measured at most
    5.7e-7 of the largest coefficient apart (h 256); the bound is 2e-5.
    Against numpy's f64 FFT the f32 matrices and sums leave at most 5.6e-7
    (h 256); the bound is 2e-5 of the largest value."""
    x = _nhwc(np.random.RandomState(h), (2, h, 5, 3))
    re, im = spectral.rfft_h(torch.from_numpy(x))
    jre, jim = (np.asarray(a) for a in jax.jit(jspectral.rfft_h)(x))
    ref = np.fft.rfft(x.astype(np.float64), axis=1, norm="ortho")
    top = np.abs(ref).max()
    assert re.shape == im.shape == (2, h // 2 + 1, 5, 3) and re.dtype == torch.float32
    for got, want in ((re.numpy(), jre), (im.numpy(), jim)):
        assert np.abs(got - want).max() <= 2e-5 * top
    assert np.abs(re.numpy() - ref.real).max() <= 2e-5 * top
    assert np.abs(im.numpy() - ref.imag).max() <= 2e-5 * top


@pytest.mark.parametrize("tier", ["parity", "fast16"])
@pytest.mark.parametrize("h", [16, 64, 256])
def test_irfft_h_matches_jax_and_round_trips(h, tier):
    """Parity's two products and an add, and every other tier's one
    product ``[Br | Bi] @ [re; im]``: against JAX's same form within 2e-5
    of the largest value (measured at most 6.9e-7); the round trip
    ``irfft_h(rfft_h(x))`` returns ``x`` within 2e-5 of it (measured at
    most 6.3e-7)."""
    x = _nhwc(np.random.RandomState(h + 1), (1, h, 4, 2))
    with config.numerics_mode(tier):
        re, im = spectral.rfft_h(torch.from_numpy(x))
        back = spectral.irfft_h(re, im, h).numpy()
    with jconfig.numerics_mode(tier):
        jback = np.asarray(jax.jit(lambda a, b: jspectral.irfft_h(a, b, h))(re.numpy(), im.numpy()))
    top = np.abs(x).max()
    assert back.shape == x.shape
    assert np.abs(back - jback).max() <= 2e-5 * top
    assert np.abs(back - x).max() <= 2e-5 * top


def test_spectral_tx_refuses_odd_height():
    model, _, _ = cases.port_model(2)
    x = ops.from_nhwc(torch.zeros((1, 15, 8, 32)))
    with pytest.raises(NotImplementedError, match="even H"):
        spectral.spectral_tx(model.b1.SpT, x)


@pytest.mark.parametrize("tier", ["parity", "fast16"])
def test_spectral_tx_matches_jax(tier):
    """The first block's SpectralTx on a seeded (1, 32, 24, 32) input in the
    tier's activation dtype: the channel order of the stacked spectrum
    (``2*ci`` real, ``2*ci + 1`` imaginary) must be JAX's. Under parity f32
    on both sides: at most 1e-5 of the largest value apart (measured
    1.6e-7). Under fast16 the spectrum's conv runs in f16 and the result is
    rounded to f16: within 4 f16 ulps (2**-8) of the largest value, and
    1/8 ulp on average (measured 0.09 ulp and 2.5e-5 of one)."""
    model, _, _ = cases.port_model(2)
    _, params = cases.jax_model(2)
    x = _nhwc(np.random.RandomState(5), (1, 32, 24, 32))
    with config.numerics_mode(tier):
        act = config.numerics().activation_dtype
        xt = ops.from_nhwc(torch.from_numpy(x).to(act))
        out = ops.to_nhwc(spectral.spectral_tx(model.b1.SpT, xt))
        assert out.dtype == act
    ref = cases.jax_run(lambda p, v: jspectral.spectral_tx(p, v), tier, params["b1"]["SpT"],
                        xt.permute(0, 2, 3, 1).float().numpy().astype(
                            np.float16 if tier == "fast16" else np.float32))
    d, top = np.abs(out.float().numpy() - ref), np.abs(ref).max()
    bound, mean = (1e-5, 1e-5) if tier == "parity" else (2.0 ** -8, 2.0 ** -10 / 8)
    assert d.max() <= bound * top and d.mean() <= mean * top, (d.max() / top, d.mean() / top)


# -- merged convs ------------------------------------------------------------------

def test_block_diag_weights_and_concat_biases_match_jax():
    rs = np.random.RandomState(3)
    hwio = [_nhwc(rs, (3, 3, 4, 5)), _nhwc(rs, (3, 3, 2, 3))]
    ref = np.asarray(jops.block_diag_weights([jnp.asarray(w) for w in hwio]))
    got = ops.block_diag_weights([torch.from_numpy(w).permute(3, 2, 0, 1) for w in hwio])
    assert tuple(got.shape) == (8, 6, 3, 3)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), ref)
    assert (got[:5, 4:] == 0).all() and (got[5:, :4] == 0).all()  # exactly zero off the blocks
    b = torch.arange(5, dtype=torch.float32)
    got_b = ops.concat_biases([(b, 5), (None, 3)], torch.float32)
    ref_b = np.asarray(jops.concat_biases([(jnp.arange(5, dtype=jnp.float32), 5), (None, 3)],
                                          jnp.float32))
    np.testing.assert_array_equal(got_b.numpy(), ref_b)
    assert ops.concat_biases([(None, 5), (None, 3)], torch.float32) is None


@pytest.mark.parametrize("tier", TIERS)
def test_nlffc_merges_where_jax_does(tier):
    """The FFCU block runs its 3x3 pair as the one block-diagonal conv in
    exactly the tiers where JAX's ``fuse_parallel_branches("nlffc")`` is
    on under AUTO: every tier but parity."""
    model, _, _ = cases.port_model(2)
    merged = []
    conv2d = ops.conv2d

    def spy(x, w, *args, **kw):
        merged.append(w is model.b1.w_pair)
        return conv2d(x, w, *args, **kw)

    x = ops.from_nhwc(torch.zeros((1, 8, 8, 64)))
    with mock.patch.object(ops, "conv2d", spy), config.numerics_mode(tier), \
            torch.inference_mode():
        model.b1(x.to(config.numerics().activation_dtype))
    assert jconfig._fuse_parallel_branches is None  # JAX on AUTO
    with jconfig.numerics_mode(tier):
        assert any(merged) == jconfig.fuse_parallel_branches("nlffc") == (tier != "parity")


def test_merged_pair_is_derived_once_at_load():
    """``w_pair``/``b_pair`` are the block-diagonal weight and the biases of
    the block's 3x3 pair, made when the weights are loaded and kept outside
    the state dict; a forward reuses them, and loading other weights makes
    new ones."""
    model, _, _, _ = registry.build_model(2, device="cpu")  # its own: the test reloads it
    blk = model.b1
    np.testing.assert_array_equal(
        blk.w_pair.numpy(), ops.block_diag_weights([blk.conv1.weight, blk.conv2.weight]).numpy())
    np.testing.assert_array_equal(blk.b_pair.numpy(),
                                  torch.cat([blk.conv1.bias, blk.conv2.bias]).numpy())
    assert not any("pair" in k for k in model.state_dict())
    w = blk.w_pair
    with config.numerics_mode("fast16"), torch.inference_mode():
        blk(ops.from_nhwc(torch.zeros((1, 8, 8, 64), dtype=torch.float16)))
    assert blk.w_pair is w
    sd = {k: v.clone() for k, v in blk.state_dict().items()}
    sd["conv2.weight"] += 1.0
    blk.load_state_dict(sd)
    assert blk.w_pair is not w
    np.testing.assert_array_equal(blk.w_pair[32:, 32:].numpy(), sd["conv2.weight"].numpy())


@pytest.mark.parametrize("tier", ["parity", "fast16"])
def test_nlffc_block_matches_jax(tier):
    """The first FFCU block against JAX's ``_ffcu`` on AUTO, on a seeded
    (1, 16, 20, 64) input: two 32->32 convs under parity, the merged conv
    under fast16, in both frameworks. The merged conv adds zeros off the
    blocks, so under parity only the order of the f32 sums differs: within
    1e-5 of the largest value (measured at most 5.8e-7). Under fast16 the
    conv outputs are rounded to f16: within 4 f16 ulps of the largest value
    and 1/4 of one on average (``test_torch_zoo_cases.BLOCK_BOUNDS``)."""
    model, _, _ = cases.port_model(2)
    _, p = cases.jax_model(2)
    x = _nhwc(np.random.RandomState(7), (1, 16, 20, 64))
    with config.numerics_mode(tier), torch.inference_mode():
        xt = ops.from_nhwc(torch.from_numpy(x)).to(config.numerics().activation_dtype)
        out = ops.to_nhwc(model.b1(xt)).float().numpy()
    ref = cases.jax_run(jnlffc._ffcu, tier, p["b1"], xt.permute(0, 2, 3, 1).float().numpy().astype(
        np.float16 if tier == "fast16" else np.float32))
    top = np.abs(ref).max()
    bound, mean = (1e-5, 1e-5) if tier == "parity" else cases.BLOCK_BOUNDS["fast16"]
    d = np.abs(out - ref)
    assert d.max() <= bound * top and d.mean() <= mean * top, (d.max() / top, d.mean() / top)


def test_flat_f16_softmax_is_zero_in_both():
    """A flat f16 map of 256x256 values: the f32 sum of exp(0) is 65536,
    which rounds to inf in f16, so both frameworks' softmax is 0 there
    (NLFFC's global-context softmax meets this on real weights at bodies of
    256x256 and more). At 255x255 the sum, 65025, is finite and both give
    the same 1/65024 (an f16 subnormal)."""
    for side, want in ((256, 0.0), (255, float(np.float16(1.0) / np.float16(65024.0)))):
        x = np.zeros((1, side, side, 1), np.float16)
        got = ops.softmax(ops.from_nhwc(torch.from_numpy(x)), dim=(2, 3)).numpy()
        ref = np.asarray(jax.jit(lambda v: jax.nn.softmax(v, axis=(1, 2)))(x))
        assert got.dtype == np.float16 and ref.dtype == np.float16
        np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), ref)
        assert np.all(got == np.float16(want)), (side, got.flat[0])


# -- the model ---------------------------------------------------------------------

@pytest.mark.parametrize("stem", cases.goldens([2]))
def test_matches_golden(stem):
    cases.check_golden(stem)


def _golden_input(stem: str) -> np.ndarray:
    """A golden's input; ``<stem>_crop``: its top-left 32x40."""
    crop = stem.endswith("_crop")
    g = np.load(os.path.join(cases.GOLDEN_DIR, f"{stem[:-5] if crop else stem}.npz"))
    x = (g["input_u8"].astype(np.float32) / (255.0 / float(g["data_range"])))[None]
    return np.ascontiguousarray(x[:, :32, :40]) if crop else x


def _jax_head(p, x):
    """JAX's upsample, ``c0`` and first stage: ``(h0, h1)``."""
    h0 = jops.conv(p["c0"], jops.interpolate(x, scale_factor=4, mode="bicubic"), padding=0)
    return h0, jops.conv(p["c1"], jnlffc._ffcu(p["b1"], h0), padding=0)


def _jax_from_stage1(p, h1):
    """JAX's stages 2-9 and the final ReLU on a given first-stage output
    (``nlffc_apply`` from ``h1`` on)."""
    hs = [None, h1]
    for i in range(2, 10):
        h = jops.conv(p[f"c{i}"], jnlffc._ffcu(p[f"b{i}"], hs[-1]), padding=0)
        hs.append(h + hs[i - 2] if i in (4, 8) else h)
    return jops.relu(hs[-1])


@pytest.mark.parametrize("tier", ["parity", "fast16", "fasthi"])
@pytest.mark.parametrize("stem", ["model_02", "model_02_63x41", "model_02_63x41_crop"])
def test_matches_jax_nlffc_apply(stem, tier):
    """The whole model against ``nlffc_apply`` on a golden input and on a
    32x40 crop of the 63x41 one (whole image: the inputs are smaller than
    the tile). Under parity f32 on both sides: within the goldens' bar,
    2e-4 * dr (measured at most 6.8e-5 * dr).

    Under fast16 and fasthi each conv output is rounded to f16 or bf16, and
    where the two frameworks' f32 sums differ in their last bits a store
    rounds the other way, which the network carries on. The first stage
    (upsample, ``c0``, block 1, ``c1``) is held to JAX's on JAX's own input
    within ``BLOCK_BOUNDS``. The whole model is held to twice the larger of
    two moves of JAX itself, in max and in mean: when its input moves by
    1e-4 * dr, and when its first stage's output is the port's (JAX's
    stages 2-9 on it), a difference the block check bounds to rounding.

    The crop needs the second: under fast16 one pixel pair, (47, 158) and
    (48, 158) of the output, is 3 levels (1.2e-2 * dr) from JAX, against
    5.4e-3 for JAX's input shift. The cause is block 9's global-context
    gate. Its second softmax is nearly one-hot there, with logits of 45 to
    88 over a 128x160 map (channel 18: 0.89 of its mass at (48, 158)). The
    first stage's 1-ulp store differences reach those logits as moves of
    up to 1.4, and the gate at that pixel drops from 0.89 to 0.62. JAX's
    own stages 2-9, fed the port's first stage, give the port's output
    within 9.8e-4 * dr everywhere and 1.1e-2 from JAX's own; the port's
    first stage is within 7.6e-4 of JAX's largest value (3 f16 ulps' bound
    1/5). Measured, port against JAX (input-shift, first-stage witness) in
    units of dr: 64x64 fast16 9.8e-4 (3.9e-3, 9.8e-4), fasthi 7.8e-3
    (1.6e-2, 1.6e-2); 63x41 fast16 9.8e-4 (1.1e-2, 1.1e-2), fasthi 2.4e-2
    (7.1e-2, 6.7e-2); the crop fast16 1.2e-2 (5.4e-3, 1.1e-2), fasthi
    4.3e-2 (3.1e-2, 4.3e-2)."""
    model, _, dr = cases.port_model(2)
    apply, params = cases.jax_model(2)
    x = _golden_input(stem)
    ref = cases.jax_run(apply, tier, params, x)
    with torch.inference_mode(), config.numerics_mode(tier):
        out = model(torch.from_numpy(x)).float().numpy()
        if tier != "parity":
            h0 = ops.conv(model.c0, ops.interpolate(ops.from_nhwc(torch.from_numpy(x)),
                                                    scale_factor=4, mode="bicubic"), padding=0)
            h1 = ops.to_nhwc(model._stage(1, h0)).float().numpy()
            with jconfig.numerics_mode(tier):  # a fresh jit: a trace is made under one tier
                jh0, jh1 = (np.asarray(a).astype(np.float32)
                            for a in jax.jit(lambda p, v: _jax_head(p, v))(params, x))
            jdt = np.float16 if tier == "fast16" else jnp.bfloat16
            s1 = ops.to_nhwc(model._stage(1, ops.from_nhwc(torch.from_numpy(jh0)).to(
                h0.dtype))).float().numpy()
    assert out.shape == ref.shape == (1, 4 * x.shape[1], 4 * x.shape[2], 3)
    d = np.abs(out - ref)
    if tier == "parity":
        assert d.max() <= 2e-4 * dr, d.max() / dr
        return
    top, (bound, mean) = np.abs(jh1).max(), cases.BLOCK_BOUNDS[tier]
    d1 = np.abs(s1 - jh1)
    assert d1.max() <= bound * top and d1.mean() <= mean * top, (d1.max() / top, d1.mean() / top)
    shift = np.abs(cases.jax_run(apply, tier, params, x + np.float32(1e-4 * dr)) - ref)
    stage1 = np.abs(cases.jax_run(_jax_from_stage1, tier, params, h1.astype(jdt)) - ref)
    own_max, own_mean = max(shift.max(), stage1.max()), max(shift.mean(), stage1.mean())
    assert d.max() <= 2 * own_max and d.mean() <= 2 * own_mean, (
        d.max() / dr, d.mean() / dr, shift.max() / dr, stage1.max() / dr)


def test_complexity_matches_jax():
    """JAX's count of the lowered program and the port's of the plain path
    agree exactly at LR 16x16 (a 64x64 body): the convs, the bicubic
    resize's products and the DFT products (``mm``/``bmm`` against JAX's
    ``dot_general``)."""
    model, name, _ = cases.port_model(2)
    apply, params = cases.jax_model(2)
    ref = jsummary.model_complexity(apply, params, (16, 16))
    assert summary.model_complexity(model, (16, 16)) == ref
    assert ref["num_parameters"] * 1e6 == summary.count_params(model) == 423404


def test_weight_carry_consumes_every_key():
    cases.check_weight_carry(2)


def test_registry_fields_match_jax():
    cases.check_registry_fields(2)
    spec = registry.get_spec(2)
    assert (spec.name, spec.data_range, spec.tile, spec.max_tiles_per_call) == (
        "02_NLFFC", 255.0, 256, 2)
