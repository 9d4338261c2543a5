"""The port's attention primitives (``ops/attention.py``), ``layer_norm``,
the token linear, the Swin block and ``config.attn_bf16`` on the CPU
against the JAX package, on numpy-seeded inputs in each tier's activation
dtype, under parity, high, fast16 and fast and under each ``attn_bf16``
value. The JAX side is compiled without XLA's excess precision
(``jax_run(..., exact_rounding=True)``), so it rounds where its code does.

Bounds, as (max, mean) of |port - JAX| over the largest reference value:

- f32 all the way: sums in another order, 1e-5;
- else 4 ulps at most and a quarter of one on average, of the coarsest
  dtype that the values are rounded to on the way: the activations' or
  the scores' (``attn_bf16``). Where the two frameworks' sums differ in
  their last bits, a value rounds to the neighbouring one of that dtype; a
  logit that does moves its probability by up to one ulp times the logit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_zoo_cases as cases
from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu.models import swin as jswin
from ntire2022_esr_tpu.ops import attention as jattn
from ntire2022_esr_tpu_torch import config, ops, porter
from ntire2022_esr_tpu_torch.models import swin
from ntire2022_esr_tpu_torch.models.scet import MDTA
from ntire2022_esr_tpu_torch.ops import attention as attn

TIERS = ("parity", "high", "fast16", "fast")
ATTN_VALUES = ("off", "probs", "scores", "scores_f16")
ULP = {torch.float32: 2.0 ** -23, torch.float16: 2.0 ** -10, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def forced_attn():
    """Force ``attn_bf16`` in both packages; restores both after the test."""
    prev_port, prev_jax = config.attn_bf16_override(), jconfig.attn_bf16_override()

    def force(value):
        config.set_attn_bf16(value)
        jconfig.set_attn_bf16(value)

    yield force
    config.set_attn_bf16(prev_port)
    jconfig.set_attn_bf16(prev_jax)


def act_dtype(tier: str) -> torch.dtype:
    return config._MODES[tier].activation_dtype


def bounds(dtype: torch.dtype):
    """(max, mean) bound when ``dtype`` is the coarsest rounding on the path."""
    if dtype == torch.float32:
        return 1e-5, 1e-5
    return 4 * ULP[dtype], ULP[dtype] / 4


def check(out: torch.Tensor, ref: np.ndarray, bound, share: float = 1.0) -> None:
    """Within ``bound``, and at most ``share`` of the values more than
    1e-5 of the largest apart."""
    out = out.float().numpy()
    assert out.shape == ref.shape
    d, top = np.abs(out - ref), np.abs(ref).max()
    assert d.max() <= bound[0] * top and d.mean() <= bound[1] * top, (d.max() / top,
                                                                       d.mean() / top)
    assert (d > 1e-5 * top).mean() <= share, (d > 1e-5 * top).mean()


def to_jax(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """``a`` rounded to ``dtype``, as the numpy array JAX takes."""
    if dtype == torch.bfloat16:
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
    return torch.from_numpy(a).to(dtype).numpy()


def test_attn_bf16_matches_jax(forced_attn):
    """The AUTO table (on outside parity only), the forced values and the
    setter's check."""
    for value in (None,) + ATTN_VALUES:
        forced_attn(value)
        assert config.attn_bf16_override() == value
        for tier in config.modes():
            with config.numerics_mode(tier), jconfig.numerics_mode(tier):
                for site in ("mobilesr", "hnct", "imdtn", "swin", "mha"):
                    assert config.attn_bf16(site) == jconfig.attn_bf16(site), (value, tier, site)
    with pytest.raises(ValueError):
        config.set_attn_bf16("bf16")


def test_cublas_reduced_precision_reductions_off():
    """cuBLAS may not sum 2-byte products in 2-byte precision: the JAX
    package sums them in f32. Off from the import on, and after a tier is
    set."""
    m = torch.backends.cuda.matmul
    assert not m.allow_fp16_reduced_precision_reduction
    assert not m.allow_bf16_reduced_precision_reduction
    m.allow_fp16_reduced_precision_reduction = True
    with config.numerics_mode("fast16"):
        assert not m.allow_fp16_reduced_precision_reduction
    assert not m.allow_bf16_reduced_precision_reduction and not m.allow_tf32


def _mha_inputs(variant: str, seed: int = 0):
    """q, k, v (8 windows of 16 tokens, 2 heads of 8), and for the Swin
    variant the f32 relative-position bias and a shift mask (4 windows of
    an 8x8 image, window 4, shift 2)."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.standard_normal((8, 16, 16)).astype(np.float32) * 1.5 for _ in range(3))
    if variant == "swin":
        rel = rs.standard_normal((2, 16, 16)).astype(np.float32)
        return (q, k, v), dict(rel_bias=rel, mask=attn.swin_shift_mask(8, 8, 4, 2))
    return (q, k, v), dict(scale=5 ** -0.5)


@pytest.mark.parametrize("variant", ("swin", "plain"))
@pytest.mark.parametrize("value", ATTN_VALUES)
@pytest.mark.parametrize("tier", TIERS)
def test_multi_head_attention_matches_jax(tier, value, variant, forced_attn):
    """The dtypes follow JAX's promotion: the f32 bias makes 2-byte scores
    f32, which ``scores`` then rounds through bf16 (or f16). Both sides
    round the same values, so at most 1% of the outputs differ (measured
    none, and 0.4% under ``scores_f16`` on f32 scores); without a rounding
    of the scores, the probabilities or v, or with the scale unrounded, 8%
    to 97% do. Where f16 scores reach the softmax (the plain variant under
    fast16) 59% do: XLA's CPU ``exp`` on f16 is not rounded once from f32,
    as the port's is (measured on the exp alone: 21% of values differ)."""
    forced_attn(value)
    dt = act_dtype(tier)
    (q, k, v), extra = _mha_inputs(variant)
    scale = extra.get("scale")
    rel, mask = extra.get("rel_bias"), extra.get("mask")
    jq, jk, jv = (to_jax(a, dt) for a in (q, k, v))

    def jfn(a, b, c, r, m):
        return jattn.multi_head_attention(a, b, c, 2, scale=scale, rel_bias=r, mask=m)

    ref = cases.jax_run(jfn, tier, jq, jk, jv, rel, mask, exact_rounding=True)
    with config.numerics_mode(tier):
        tq, tk, tv = (torch.from_numpy(a).to(dt) for a in (q, k, v))
        out = attn.multi_head_attention(
            tq, tk, tv, 2, scale=scale,
            rel_bias=None if rel is None else torch.from_numpy(rel),
            mask=None if mask is None else torch.from_numpy(mask))
    # the scores are f32 where the f32 bias meets them; then attn_bf16 picks
    # the dtype they are stored in, else they keep the activations'
    scores = torch.float32 if variant == "swin" else dt
    assert out.dtype == scores
    store = dt
    if scores == torch.float32:
        store = {"off": dt, "probs": torch.bfloat16, "scores": torch.bfloat16,
                 "scores_f16": torch.float16}[value]
    f16_softmax = scores == torch.float16
    check(out, ref, bounds(max(dt, store, key=ULP.get)), share=1.0 if f16_softmax else 0.01)


def test_window_partition_reverse_and_pad_match_jax():
    """Exact: the same values moved to the same places."""
    x = np.random.RandomState(1).standard_normal((2, 13, 10, 3)).astype(np.float32)
    xp, pb, pr = attn.pad_to_multiple(torch.from_numpy(x), 4)
    jp, jb, jr = jattn.pad_to_multiple(x, 4)
    assert (pb, pr) == (jb, jr) == (3, 2)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jp))
    windows = attn.window_partition(xp, 4)
    np.testing.assert_array_equal(windows.numpy(), np.asarray(jattn.window_partition(jp, 4)))
    back = attn.window_reverse(windows, 4, 16, 12)
    np.testing.assert_array_equal(back.numpy(), xp.numpy())
    same, pb, pr = attn.pad_to_multiple(xp, 4)
    assert same is xp and pb == pr == 0


def test_masks_and_index_match_jax():
    """The host tables equal JAX's; the device copy of a mask is made once
    per shape and device."""
    for h, w, ws, shift in ((8, 8, 4, 2), (16, 24, 8, 4), (12, 18, 6, 3)):
        np.testing.assert_array_equal(attn.swin_shift_mask(h, w, ws, shift),
                                      jattn.swin_shift_mask(h, w, ws, shift))
        m = attn.shift_mask(h, w, ws, shift, torch.device("cpu"))
        assert attn.shift_mask(h, w, ws, shift, torch.device("cpu")) is m
        np.testing.assert_array_equal(m.numpy(), jattn.swin_shift_mask(h, w, ws, shift))
    for ws in (4, 6, 8):
        np.testing.assert_array_equal(attn.relative_position_index(ws),
                                      jattn.relative_position_index(ws))
        wa = swin.WindowAttention(2, ws)
        assert wa.relative_position_index.tolist() == jattn.relative_position_index(ws).reshape(
            -1).tolist()
        assert "relative_position_index" not in wa.state_dict()


@pytest.mark.parametrize("tier", TIERS)
def test_layer_norm_matches_jax(tier):
    """``eps`` rounded to the dtype (1e-5 is subnormal in f16), the sums in
    f32."""
    dt = act_dtype(tier)
    rs = np.random.RandomState(2)
    x = rs.standard_normal((2, 5, 7, 24)).astype(np.float32) * 3 + 1
    p = {"weight": rs.standard_normal(24).astype(np.float32),
         "bias": rs.standard_normal(24).astype(np.float32)}
    layer = _layer(p)
    for eps in (1e-5, 1e-6):
        ref = cases.jax_run(lambda q, v: jops.layer_norm(q, v, eps=eps), tier, p, to_jax(x, dt),
                            exact_rounding=True)
        with config.numerics_mode(tier):
            out = ops.layer_norm(layer, torch.from_numpy(x).to(dt), eps=eps)
        assert out.dtype == dt
        check(out, ref, bounds(dt))


def _layer(p):
    """A ``blocks.Layer`` holding the JAX-layout arrays of ``p``."""
    from ntire2022_esr_tpu_torch.models.blocks import Layer

    layer = Layer(tuple(p))
    layer.load_state_dict(porter.to_torch(p))
    return layer


@pytest.mark.parametrize("tier", TIERS)
def test_linear_tokens_matches_jax(tier):
    """The contraction in the compute dtype, then the bias, then the
    store; on tokens and, through ``linear``, on NCHW channels-last."""
    dt = act_dtype(tier)
    rs = np.random.RandomState(3)
    x = rs.standard_normal((3, 20, 24)).astype(np.float32)
    p = {"weight": rs.standard_normal((24, 40)).astype(np.float32) * 0.2,
         "bias": rs.standard_normal(40).astype(np.float32)}
    layer = _layer(p)
    ref = cases.jax_run(jops.linear, tier, p, to_jax(x, dt), exact_rounding=True)
    with config.numerics_mode(tier):
        out = ops.linear_tokens(layer, torch.from_numpy(x).to(dt))
        nchw = ops.linear(layer, ops.from_nhwc(torch.from_numpy(x).to(dt)[None]))
    assert out.dtype == dt
    check(out, ref, bounds(dt))
    torch.testing.assert_close(ops.to_nhwc(nchw)[0], out, rtol=0, atol=0)


@pytest.mark.parametrize("tier", TIERS)
def test_mdta_channel_attention_matches_jax(tier):
    """SCET's MDTA: L2-normalised q and k (the norm's ``1e-12`` rounded to
    the dtype), the f32 ``temperature`` that makes 2-byte scores f32."""
    dt = act_dtype(tier)
    rs = np.random.RandomState(4)
    c, heads = 16, 4
    p = {"qkv": {"weight": rs.standard_normal((1, 1, c, 3 * c)).astype(np.float32) * 0.3},
         "qkv_dwconv": {"weight": rs.standard_normal((3, 3, 1, 3 * c)).astype(np.float32) * 0.3},
         "project_out": {"weight": rs.standard_normal((1, 1, c, c)).astype(np.float32) * 0.3},
         "temperature": (rs.rand(heads, 1, 1) + 0.5).astype(np.float32)}
    x = rs.standard_normal((2, 6, 5, c)).astype(np.float32)
    mdta = MDTA(heads)
    mdta.load_state_dict(porter.to_torch(p))
    ref = cases.jax_run(
        lambda q, v: jattn.mdta_channel_attention(q, v, heads, q["temperature"]), tier, p,
        to_jax(x, dt), exact_rounding=True)
    with config.numerics_mode(tier):
        out = ops.to_nhwc(mdta(ops.from_nhwc(torch.from_numpy(x).to(dt))))
    assert out.dtype == dt
    # the f32 softmax and product, then the 1x1's output in the dtype
    check(out, ref, bounds(dt))


@pytest.mark.parametrize("pre_norm", (False, True))
@pytest.mark.parametrize("tier", ("parity", "fast16"))
def test_swin_block_matches_jax(tier, pre_norm, forced_attn):
    """One shifted Swin block (window 4, shift 2, 2 heads) on a 8x12
    image, HNCT's variant and SwinIR's pre-norm one, with the scores in
    f32."""
    forced_attn("off")
    dt = act_dtype(tier)
    rs = np.random.RandomState(5)
    c = 16

    def lin(i, o):
        return {"weight": rs.standard_normal((i, o)).astype(np.float32) * i ** -0.5,
                "bias": rs.standard_normal(o).astype(np.float32) * 0.1}

    p = {"attn": {"qkv": lin(c, 3 * c), "proj": lin(c, c),
                  "relative_position_bias_table": rs.standard_normal((49, 2)).astype(np.float32)},
         "mlp": {"fc1": lin(c, 2 * c), "fc2": lin(2 * c, c)}}
    if pre_norm:
        for n in ("norm1", "norm2"):
            p[n] = {"weight": rs.rand(c).astype(np.float32) + 0.5,
                    "bias": rs.standard_normal(c).astype(np.float32) * 0.1}
    x = rs.standard_normal((2, 8, 12, c)).astype(np.float32)
    blk = swin.SwinBlock(2, 4, 2, pre_norm=pre_norm)
    blk.load_state_dict(porter.to_torch(p))
    ref = cases.jax_run(
        lambda q, v: jswin.swin_block(q, v.reshape(2, 96, c), (8, 12), 2, 4, 2,
                                      pre_norm=pre_norm).reshape(2, 8, 12, c),
        tier, p, to_jax(x, dt), exact_rounding=True)
    with config.numerics_mode(tier):
        out = blk(torch.from_numpy(x).to(dt))
    assert out.dtype == dt
    check(out, ref, bounds(dt))
