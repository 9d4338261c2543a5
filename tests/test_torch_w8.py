"""The w8 int8-weight tier in the port, on the CPU, against the JAX package.

- (a) ``porter.quantize_array_int8`` / ``quantize_params_int8`` /
  ``dequantize_params`` equal to JAX's bit for bit, on a seeded tree and
  on RLFN's and AALN's caches;
- (b) ``porter.to_torch`` of a quantized tree (int8 OIHW, scales
  (O, I, 1, 1), linear weights (in, out) with (1, out) scales);
- (c) the ops under w8 against JAX's: ``dequant`` bit for bit, then
  ``conv``, ``linear``, ``linear_tokens``, ``upconv_nearest2`` (fused and
  unfused) and NLFFC's merged 3x3 pair, under parity, fast, fast16 and
  fasthi16;
- (d) both kernels' plain versions on (int8, scale) against JAX's unfused
  RLFB body and conv + PixelShuffle under w8, and their refusal of an
  int8 weight without its scale;
- (e) the packs from (int8, scale) equal to the packs of the dequantized
  weights, and the packed-weight cache hit on a second call;
- (f) RLFN under w8 against JAX's w8 ``rlfn_apply`` under parity and
  fasthi16, and at least 44 dB from the f32 forward;
- (g) NASNetBN (HR tail under ``high``), AALN (MeanShift convs kept f32),
  IMDTN (token linears and grouped convs, against JAX's stock params) and
  NLFFC's first block (the merged pair under fast16) against JAX;
- (h) every registry id: the w8 model holds JAX's int8 weights and scales,
  and its forward under parity equals, bit for bit, the forward of the
  same model loaded with the dequantized f32 weights;
- (i) ``count_params`` and ``model_complexity`` under w8 equal to JAX's.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` phase
11 holds them to these plain versions there under w8.
"""

import contextlib
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
from ntire2022_esr_tpu.harness import registry as jregistry
from ntire2022_esr_tpu.harness import summary as jsummary
from ntire2022_esr_tpu.models import nlffc as jnlffc
from ntire2022_esr_tpu.models import rlfn as jrlfn
from ntire2022_esr_tpu.ops import fused as jfused
from ntire2022_esr_tpu.porter import quant as jquant
from ntire2022_esr_tpu_torch import config, ops, porter
from ntire2022_esr_tpu_torch.harness import registry, summary
from ntire2022_esr_tpu_torch.models.blocks import Layer, Nearest2Layer
from ntire2022_esr_tpu_torch.ops.fused import upconv_nearest2
from ntire2022_esr_tpu_torch.ops.kernels import conv_chain, tail

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights")
TIERS = ["parity", "fast", "fast16", "fasthi16"]
# the ulp of each 2-byte tier's stored values, relative to their binade
ULP = {"fast": 2.0 ** -7, "fast16": 2.0 ** -10, "fasthi16": 2.0 ** -10}
JDT = {"parity": jnp.float32, "fast": jnp.bfloat16, "fast16": jnp.float16,
       "fasthi16": jnp.float16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU forwards: the suite
    runs six workers on the machine's cores, and each worker's default
    thread pool would oversubscribe them (the file took 20x its one-worker
    time). Restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def weights_int8():
    """The port's w8 tier on, restored afterwards."""
    prev = config.weights_int8()
    config.set_weights_int8(True)
    try:
        yield
    finally:
        config.set_weights_int8(prev)


@contextlib.contextmanager
def fuse_upsample(value):
    """Both frameworks' fused nearest-x2 setting forced, restored afterwards."""
    saved = (jconfig._fuse_upsample_conv, config._fuse_upsample_conv)
    jconfig.set_fuse_upsample_conv(value)
    config.set_fuse_upsample_conv(value)
    try:
        yield
    finally:
        jconfig.set_fuse_upsample_conv(saved[0])
        config.set_fuse_upsample_conv(saved[1])


def _jax(fn, tier, *args):
    """``fn(*args)`` jitted under ``tier`` without XLA's excess precision
    (``test_torch_zoo_cases.jax_run``): by default XLA's CPU backend keeps
    a 2-byte value in f32 where it feeds a conv it runs in f32, so the
    product of a bf16 dequant, or the fused weights' sum, would reach the
    conv unrounded, which the JAX code does not write (measured: up to 10
    bf16 ulps on the fused upconv under fast, none with the rounding)."""
    return cases.jax_run(fn, tier, *args, exact_rounding=True)


def _t(a, dtype=torch.float32):
    return ops.from_nhwc(torch.from_numpy(np.array(a, dtype=np.float32))).to(dtype)


def _n(t):
    return ops.to_nhwc(t).float().numpy()


def _in(x, tier):
    """``x`` in the tier's activation dtype (numpy, bf16 through JAX's)."""
    return np.asarray(jnp.asarray(x).astype(JDT[tier]))


def _close(out, ref, tier, *rounded):
    """parity: f32 sums in another order, within 1e-5 of the largest value.
    A 2-byte tier: at most one ulp of its dtype for each rounding, at the
    binade of the largest of ``|ref|``, the values it was rounded from
    (``rounded``: a conv's output before the bias that fast and fast16 add
    after a first rounding) and 1."""
    if tier == "parity":
        return float(np.abs(out - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    top = np.maximum(np.abs(ref), 1.0)
    for r in rounded:
        top = np.maximum(top, np.abs(r))
    ulps = np.abs(out - ref) / (ULP[tier] * 2.0 ** np.floor(np.log2(top)))
    return float(ulps.max()) <= 1.0 + len(rounded)


def _flat_equal(a, b):
    fa, fb = porter.flatten(a), porter.flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        va, vb = np.asarray(fa[k]), np.asarray(fb[k])
        assert va.dtype == vb.dtype and va.shape == vb.shape, k
        assert np.array_equal(va, vb), k


def _seeded_tree(rs):
    w = (rs.randn(3, 3, 6, 8) * np.exp(rs.randn(1, 1, 6, 8) * 3)).astype(np.float32)
    w[:, :, 2, 5] = 0.0  # a (cin, cout) pair of zeros
    return {
        "conv": {"weight": w, "bias": rs.randn(8).astype(np.float32)},
        "lin": {"weight": (rs.randn(8, 5) * 0.3).astype(np.float32)},
        "dead": {"weight": np.zeros((1, 1, 4, 2), np.float32)},
        "head": {"sub_mean": {"weight": rs.randn(1, 1, 3, 3).astype(np.float32),
                              "bias": rs.randn(3).astype(np.float32)},
                 "add_mean": {"weight": rs.randn(1, 1, 3, 3).astype(np.float32)}},
        "act": {"weight": rs.randn(8).astype(np.float32)},  # a PReLU: 1-D
        "norm": {"weight": rs.randn(8).astype(np.float32), "bias": rs.randn(8).astype(np.float32)},
        "f64": {"weight": rs.randn(3, 3, 2, 2)},  # not float32: left as it is
    }


# -- (a) the quantization, bit for bit -------------------------------------------

@pytest.mark.parametrize("source", ["seeded", "team04_rlfn", "team11_aaln"])
def test_quantize_params_equal_jax(source):
    """The int8 values and scales, the skip rule and the inverse walk are
    the JAX package's, bit for bit."""
    if source == "seeded":
        tree = _seeded_tree(np.random.RandomState(0))
    else:
        tree = porter.load_params(os.path.join(WEIGHTS, f"{source}.npz"))
    q, jq = porter.quantize_params_int8(tree), jquant.quantize_params_int8(tree)
    _flat_equal(q, jq)
    _flat_equal(porter.dequantize_params(q), jquant.dequantize_params(jq))
    flat = porter.flatten(q)
    assert any(v.dtype == np.int8 for v in flat.values())
    for k, v in flat.items():
        if "sub_mean" in k or "add_mean" in k or v.ndim == 1 or k.endswith("bias"):
            assert v.dtype != np.int8, k
    if source == "seeded":
        assert flat["conv.weight"].dtype == np.int8 and flat["conv.weight_scale"].shape == (1, 1, 6, 8)
        assert flat["conv.weight_scale"][0, 0, 2, 5] == 0 and not flat["conv.weight"][:, :, 2, 5].any()
        assert flat["lin.weight_scale"].shape == (1, 5)
        assert flat["f64.weight"].dtype == np.float64 and "f64.weight_scale" not in flat


@pytest.mark.parametrize("shape", [(3, 3, 16, 24), (1, 1, 4, 2), (3, 3, 1, 7), (24, 32), (5, 1)])
def test_quantize_array_equal_jax(shape):
    rs = np.random.RandomState(1)
    w = (rs.randn(*shape) * np.exp(rs.randn(*shape) * 2)).astype(np.float32)
    for got, ref in zip(porter.quantize_array_int8(w), jquant.quantize_array_int8(w)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    q, s = porter.quantize_array_int8(w)
    # symmetric: |w - q * s| at most half a step, the step 1/127 of the largest |w|
    assert np.all(np.abs(q.astype(np.float32) * s - w) <= s / 2 * (1 + 1e-6))


# -- (b) to_torch ----------------------------------------------------------------

def test_to_torch_of_quantized_tree():
    tree = porter.quantize_params_int8(_seeded_tree(np.random.RandomState(2)))
    sd = porter.to_torch(tree)
    w, s = tree["conv"]["weight"], tree["conv"]["weight_scale"]
    assert sd["conv.weight"].dtype == torch.int8 and sd["conv.weight_scale"].dtype == torch.float32
    np.testing.assert_array_equal(sd["conv.weight"].numpy(), w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["conv.weight_scale"].numpy(), s.transpose(3, 2, 0, 1))
    assert tuple(sd["conv.weight_scale"].shape) == (8, 6, 1, 1)
    np.testing.assert_array_equal(sd["lin.weight"].numpy(), tree["lin"]["weight"])
    assert tuple(sd["lin.weight_scale"].shape) == (1, 5)
    assert sd["head.sub_mean.weight"].dtype == torch.float32
    # the OIHW product is the transposed HWIO one
    deq = ops.nn.dequant(sd["conv.weight"], sd["conv.weight_scale"], torch.float32)
    np.testing.assert_array_equal(deq.numpy(), (w.astype(np.float32) * s).transpose(3, 2, 0, 1))


# -- (c) the ops --------------------------------------------------------------

class _Holder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for name in ("c3", "c1", "dw", "lin"):
            self.add_module(name, Layer())
        self.up = Nearest2Layer()


def _op_params(rs):
    """A quantized HWIO tree (JAX's form) and the torch module holding it,
    made by ``registry.hold_w8`` as the registry makes its models."""
    tree = {"c3": {"weight": (rs.randn(3, 3, 24, 32) * 0.05).astype(np.float32),
                   "bias": (rs.randn(32) * 0.5).astype(np.float32)},
            "c1": {"weight": (rs.randn(1, 1, 24, 16) * 0.2).astype(np.float32),
                   "bias": (rs.randn(16) * 0.5).astype(np.float32)},
            "dw": {"weight": (rs.randn(3, 3, 1, 24) * 0.3).astype(np.float32),
                   "bias": (rs.randn(24) * 0.5).astype(np.float32)},
            "lin": {"weight": (rs.randn(24, 32) * 0.2).astype(np.float32),
                    "bias": (rs.randn(32) * 0.5).astype(np.float32)},
            "up": {"weight": (rs.randn(3, 3, 24, 12) * 0.1).astype(np.float32),
                   "bias": (rs.randn(12) * 0.5).astype(np.float32)}}
    q = jquant.quantize_params_int8(tree)
    m = _Holder()
    state = porter.to_torch(q)
    registry.hold_w8(m, state)
    m.load_state_dict(state, strict=True)
    return q, m


@pytest.mark.parametrize("tier", TIERS)
def test_dequant_equals_jax(tier):
    """``q.to(dt) * scale.to(dt)`` in the compute dtype, one rounding of
    the exact product, bit for bit with JAX's ``dequant_weight``, f16
    scales that go subnormal or to 0 included."""
    rs = np.random.RandomState(3)
    w = (rs.randn(3, 3, 40, 48) * np.exp(rs.randn(1, 1, 40, 48) * 3)).astype(np.float32)
    q, s = jquant.quantize_array_int8(w)
    ref = _jax(lambda p: jops.nn.dequant_weight(p), tier, {"weight": q, "weight_scale": s})
    sd = porter.to_torch({"c": {"weight": q, "weight_scale": s}})
    with config.numerics_mode(tier):
        out = ops.nn.dequant(sd["c.weight"], sd["c.weight_scale"])
    assert out.dtype == config._MODES[tier].compute_dtype
    np.testing.assert_array_equal(out.float().numpy(), ref.transpose(3, 2, 0, 1))
    if tier == "fast16":
        assert (s < 2.0 ** -14).any()  # some scales are f16 subnormals or 0 there
    w32 = torch.from_numpy(w)
    assert ops.nn.dequant(w32, None) is w32  # a float weight passes through


@pytest.mark.parametrize("tier", TIERS)
def test_ops_match_jax_under_w8(tier):
    """conv (3x3, 1x1 strided, depthwise), linear on NCHW and on tokens,
    and the nearest-x2 upconv fused (the fused weights of the tier's
    compute dtype) and unfused, on int8 weights, against the JAX ops on
    JAX's quantized params: :func:`_close` (one ulp of a 2-byte tier for
    each rounding; fast and fast16 round the sum and then the sum plus the
    bias; the fused upconv's weights are f32 sums rounded at use, in
    another order than JAX's einsum: one more ulp)."""
    rs = np.random.RandomState(4)
    q, m = _op_params(rs)
    x = _in((rs.randn(2, 13, 11, 24) * 4).astype(np.float32), tier)
    zero = lambda p: {**p, "bias": np.zeros_like(p["bias"])}  # noqa: E731
    two = config._MODES[tier].two_byte_compute
    cases_ = [
        ("conv3x3", lambda p, v: jops.conv(p["c3"], v), lambda t: ops.conv(m.c3, t), "c3", {}),
        ("conv1x1/2", lambda p, v: jops.conv(p["c1"], v, stride=2, padding=0),
         lambda t: ops.conv(m.c1, t, stride=2, padding=0), "c1", {}),
        ("depthwise", lambda p, v: jops.conv(p["dw"], v, groups=24),
         lambda t: ops.conv(m.dw, t, groups=24), "dw", {}),
        ("linear", lambda p, v: jops.linear(p["lin"], v), lambda t: ops.linear(m.lin, t), "lin", {}),
    ]
    dt = config._MODES[tier].activation_dtype
    with config.numerics_mode(tier), torch.inference_mode():
        for tag, jf, tf, key, _ in cases_:
            ref = _jax(jf, tier, q, x)
            out = tf(_t(x, dt))
            assert out.dtype == dt, tag
            sums = (_jax(jf, tier, {**q, key: zero(q[key])}, x),) if two else ()
            assert _close(_n(out), ref, tier, *sums), tag
        tok = x.reshape(2, 13 * 11, 24)
        ref = _jax(lambda p, v: jops.linear(p["lin"], v), tier, q, tok)
        out = ops.linear_tokens(m.lin, torch.from_numpy(tok.astype(np.float32)).to(dt)).float().numpy()
        sums = (_jax(lambda p, v: jops.linear(p, v), tier, zero(q["lin"]), tok),) if two else ()
        assert _close(out, ref, tier, *sums), "linear_tokens"
        for fuse in (True, False):
            with fuse_upsample(fuse):
                ref = _jax(lambda p, v: jfused.upconv_nearest2(p["up"], v), tier, q, x)
                sums = ((_jax(lambda p, v: jfused.upconv_nearest2(p, v), tier, zero(q["up"]), x),)
                        if two else ())
                out = upconv_nearest2(m.up, _t(x, dt))
                extra = (ref,) if fuse and tier != "parity" else ()
                assert _close(_n(out), ref, tier, *sums, *extra), ("upconv", fuse)


def test_nearest2_fused_weights_per_compute_dtype():
    """Under w8 each compute dtype has its fused weights, derived once at
    load from the weight dequantized in it and summed in f32 (JAX's
    ``nearest2_conv_weights`` of ``dequant_weight``, bit for bit at f32
    sums of at most four taps); forwards take the same tensors every
    time. An f32 layer has one set, rounded at use."""
    q, m = _op_params(np.random.RandomState(5))
    for tier in TIERS:
        cdt = config._MODES[tier].compute_dtype
        w4 = m.up.fused_weight(cdt)
        assert w4.dtype == torch.float32 and w4 is m.up.fused_weight(cdt)
        with jconfig.numerics_mode(tier):
            ref = np.asarray(jfused.nearest2_conv_weights(jops.nn.dequant_weight(q["up"]))[0])
        np.testing.assert_array_equal(w4.numpy(), ref.transpose(3, 2, 0, 1))
    assert m.up.fused_weight(torch.bfloat16) is not m.up.fused_weight(torch.float32)
    f32 = Nearest2Layer()
    f32.load_state_dict(porter.to_torch({"weight": np.ones((3, 3, 2, 3), np.float32),
                                         "bias": np.zeros(3, np.float32)}))
    assert f32.fused_weight(torch.bfloat16) is f32.w4 and f32.w4_bf16 is None


def test_nlffc_merged_pair_under_w8():
    """NLFFC's merged 3x3 pair holds the int8 weights and scales merged
    block-diagonally (0 off the blocks, so 0 * 0 = 0 in every dtype) and
    f32 biases; dequantized in each tier it is JAX's merge of the
    dequantized weights, bit for bit."""
    with weights_int8():
        model = registry.build_model(2, device="cpu")[0]
    q = jquant.quantize_params_int8(jregistry.load_params(jregistry.get_spec(2)))
    blk, p = model.b1, q["b1"]
    assert blk.w_pair.dtype == torch.int8 and blk.b_pair.dtype == torch.float32
    assert blk.w_pair_scale.shape == (blk.w_pair.shape[0], blk.w_pair.shape[1], 1, 1)
    for tier in TIERS:
        with config.numerics_mode(tier):
            out = ops.nn.dequant(blk.w_pair, blk.w_pair_scale)
        ref = _jax(lambda a, b: jops.block_diag_weights(
            [jops.nn.dequant_weight(a), jops.nn.dequant_weight(b)]), tier, p["conv1"], p["conv2"])
        np.testing.assert_array_equal(out.float().numpy(), ref.transpose(3, 2, 0, 1))
    refb = np.concatenate([p["conv1"]["bias"], p["conv2"]["bias"]])
    np.testing.assert_array_equal(blk.b_pair.numpy(), refb)


# -- (d) the kernels' plain versions ---------------------------------------------------

def _rlfn_q():
    p = jquant.quantize_params_int8(jregistry.load_params(jregistry.get_spec(4)))
    return [p["B1"][f"c{i}_r"] for i in (1, 2, 3)], p["upsampler"]["0"]


def _qt(layer):
    sd = porter.to_torch({"l": layer})
    return sd["l.weight"], sd["l.bias"], sd["l.weight_scale"]


@pytest.mark.parametrize("tier", TIERS)
def test_kernel_plain_versions_match_unfused_jax_w8(tier):
    """Both kernels' plain versions on RLFN's int8 weights and scales
    against JAX's unfused graph under w8. The chain stage by stage, each
    fed JAX's input to that stage: :func:`_close` at the binade of the
    conv's output before the LeakyReLU (whose f16 or bf16 product with
    the slope rounds again), and of the sum before the bias under fast and
    fast16 (measured at most 1, 1 and 2 ulps under fasthi16, fast and
    fast16). The tail (conv + PixelShuffle): :func:`_close`. The whole
    chain, where a store that rounds the other way is carried on: within
    ``BLOCK_BOUNDS`` of the largest value (fasthi16 stores f16 as fast16
    does; measured at most 0.30, 0.15 and 0.59 ulps of it), under parity
    1e-5 of it."""
    convs, up = _rlfn_q()
    x = _in((np.random.RandomState(6).randn(2, 24, 20, 46) * 8).astype(np.float32), tier)
    dt = config._MODES[tier].activation_dtype
    two = config._MODES[tier].two_byte_compute
    chain = conv_chain.fused_conv3x3_chain
    with config.numerics_mode(tier), torch.inference_mode():
        h = x
        for k, c in enumerate(convs):
            ref = _jax(lambda p, v: jops.leaky_relu(jops.conv(p, v), 0.05), tier, c, h)
            pre = _jax(lambda p, v: jops.conv(p, v), tier, c, h)
            sums = (_jax(lambda p, v: jops.conv(p, v), tier, {**c, "bias": 0 * c["bias"]}, h),
                    ) if two else ()
            w, b, s = _qt(c)
            out = chain(_t(h, dt), [w], [b], residual=False, scales=[s])
            assert out.dtype == dt
            assert _close(_n(out), ref, tier, pre, *sums), k
            h = _in(ref, tier)
        wbs = [_qt(c) for c in convs]
        whole = chain(_t(x, dt), [w for w, _, _ in wbs], [b for _, b, _ in wbs],
                      scales=[s for _, _, s in wbs])
        w, b, s = _qt(up)
        out = tail.fused_conv3x3_pixelshuffle(_t(x, dt), w, b, scale=s)
    jwhole = _jax(_jax_chain, tier, convs, x)
    d, top = np.abs(_n(whole) - jwhole), float(np.abs(jwhole).max())
    bound, mean = ((1e-5, 1e-5) if tier == "parity"
                   else cases.BLOCK_BOUNDS["fast16" if tier == "fasthi16" else tier])
    assert d.max() <= bound * top and d.mean() <= mean * top, (d.max() / top, d.mean() / top)
    ref = _jax(lambda p, v: jops.pixel_shuffle(jops.conv(p, v), 4), tier, up, x)
    sums = (_jax(lambda p, v: jops.pixel_shuffle(jops.conv(p, v), 4), tier,
                 {**up, "bias": 0 * up["bias"]}, x),) if two else ()
    assert out.dtype == dt and _close(_n(out), ref, tier, *sums)


def _jax_chain(ps, v):
    h = v
    for p in ps:
        h = jops.leaky_relu(jops.conv(p, h), 0.05)
    return h + v


def test_kernels_refuse_int8_without_scales():
    """No w8 weight reaches a kernel, or its plain version, without its
    scale; a float weight takes none; the scale must fit the weight."""
    convs, up = _rlfn_q()
    w, b, s = _qt(convs[0])
    x = torch.zeros(1, 46, 8, 8).contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError, match="int8"):
        conv_chain.fused_conv3x3_chain(x, [w], [b], residual=False)
    with pytest.raises(TypeError, match="int8"):
        conv_chain.fused_conv3x3_chain(x, [w.float()], [b], residual=False, scales=[s])
    with pytest.raises(ValueError, match="does not fit"):
        conv_chain.fused_conv3x3_chain(x, [w], [b], residual=False, scales=[s[:, :3]])
    wu, bu, su = _qt(up)
    with pytest.raises(TypeError, match="int8"):
        tail.fused_conv3x3_pixelshuffle(x, wu, bu)
    with pytest.raises(TypeError, match="int8"):
        conv_chain.conv3x3_chain_plain(x, [w], [b], residual=False)


# -- (e) the packs -------------------------------------------------------------

@pytest.mark.parametrize("tier", ["fasthi16", "parity", "fast", "fast16"])
def test_packs_from_int8_equal_packs_of_dequantized(tier):
    """``layout``'s packing of (int8, scale), for the chain (pack_chain_f16
    under fasthi16, _tf32 under parity, _2byte under fast and fast16) and
    the tail (pack_tail_wgmma_* at r = 4 and at r = 2, 52 -> 208),
    equals bit for bit the pack of the weights dequantized in the tier's
    compute dtype; the cache packs once per weight set, keyed on the int8
    and scale tensors."""
    nm = config._MODES[tier]
    convs, up = _rlfn_q()
    wbs = [_qt(c) for c in convs]
    ws, bs, ss = [w for w, _, _ in wbs], [b for _, b, _ in wbs], [s for _, _, s in wbs]
    deq = [ops.nn.dequant(w, s, nm.compute_dtype).float() for w, s in zip(ws, ss)]
    key, pack = conv_chain.layout(nm.activation_dtype, nm.compute_dtype)
    for got, ref in zip(pack(ws, bs, ss), pack(deq, bs)):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    before = conv_chain.packs
    first = conv_chain.packed_weights(key, ws, bs, pack, ss)
    again = conv_chain.packed_weights(key, ws, bs, pack, ss)
    assert conv_chain.packs == before + 1 and first is again
    # another scale tensor is another weight set
    conv_chain.packed_weights(key, ws, bs, pack, [s.clone() for s in ss])
    assert conv_chain.packs == before + 2
    wu, bu, su = _qt(up)
    for r, (w, b, s) in ((4, (wu, bu, su)), (2, _qt(jquant.quantize_params_int8(
            {"l": {"weight": (np.random.RandomState(8).randn(3, 3, 52, 208) * 0.05).astype(
                np.float32), "bias": np.ones(208, np.float32)}})["l"]))):
        key, pack = tail.layout(nm.activation_dtype, r, nm.compute_dtype)
        d = ops.nn.dequant(w, s, nm.compute_dtype).float()
        for got, ref in zip(pack([w], [b], [s]), pack([d], [b])):
            assert torch.equal(got, ref)
        before = conv_chain.packs
        tail.packed_weights(key, [w], [b], pack, [s])
        tail.packed_weights(key, [w], [b], pack, [s])
        assert conv_chain.packs == before + 1


# -- (f) RLFN ------------------------------------------------------------------

@pytest.fixture(scope="module")
def rlfn_w8():
    with weights_int8():
        return registry.build_model(4, device="cpu")[0]


def _x32():
    return np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32) * 255.0


@pytest.mark.parametrize("tier", ["parity", "fasthi16"])
def test_rlfn_w8_matches_jax(rlfn_w8, tier):
    """RLFN under w8 against JAX's ``rlfn_apply`` on JAX's quantized params:
    under parity f32 on both sides (atol 1e-3 of outputs spanning 0..255,
    the bound of tests/test_torch_rlfn.py); under fasthi16 the scale that
    JAX's own output moves by on a 1e-4 input shift (mean 0.3 / max 2.5,
    tests/test_torch_rlfn.py and ROADMAP §3 item 5)."""
    q = jquant.quantize_params_int8(jregistry.load_params(jregistry.get_spec(4)))
    x = _x32()
    ref = _jax(lambda p, v: jrlfn.rlfn_apply(p, v), tier, q, x)
    with torch.inference_mode(), config.numerics_mode(tier):
        out = rlfn_w8(torch.from_numpy(x)).float().numpy()
    assert out.shape == ref.shape == (1, 128, 128, 3)
    d = np.abs(out - ref)
    if tier == "parity":
        assert d.max() <= 1e-3, d.max()
    else:
        assert d.mean() <= 0.3 and d.max() <= 2.5, (d.mean(), d.max())


def test_rlfn_w8_quality_floor(rlfn_w8):
    """At least 44 dB against the f32 forward on uniform noise, the JAX
    package's floor (tests/test_quant.py), under parity."""
    f32 = registry.build_model(4, device="cpu")[0]
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32) * 255.0)
    with torch.inference_mode(), config.numerics_mode("parity"):
        ref, got = f32(x).clamp(0, 255), rlfn_w8(x).clamp(0, 255)
    mse = float(((ref - got) ** 2).mean()) / 255.0 ** 2
    db = 10 * np.log10(1 / max(mse, 1e-12))
    assert db > 44, db
    assert rlfn_w8.B1.c1_r.weight.dtype == torch.int8


# -- (g) the zoo's other w8 sites ----------------------------------------------------------

def _jax_w8(mid):
    apply, params = cases.jax_model(mid, stock=True)
    return apply, jquant.quantize_params_int8(params)


def _port_w8(mid):
    with weights_int8():
        return registry.build_model(mid, device="cpu")[:3:2]


def test_nasnetbn_w8_matches_jax_high():
    """NASNetBN under ``high``, its HR tail under the bf16 scope (the x2
    upsamplers through the tail kernel's plain version on (int8, scale),
    dequantized in bf16), against JAX's w8 apply: held, as
    tests/test_torch_hr_tail.py holds the f32 model, to twice JAX's own
    move on this real image when its input moves by 1e-4 of the range."""
    saved = (jconfig.hr_tail_override(), config.hr_tail_override())
    jconfig.set_hr_tail(None)
    config.set_hr_tail(None)
    try:
        model, dr = _port_w8(28)
        apply, q = _jax_w8(28)
        x = cases.image_crop(28)
        ref = cases.jax_run(apply, "high", q, x)
        moved = cases.jax_run(apply, "high", q, x + np.float32(1e-4 * dr))
        with torch.inference_mode(), config.numerics_mode("high"):
            out = model(torch.from_numpy(x)).numpy()
    finally:
        jconfig.set_hr_tail(saved[0])
        config.set_hr_tail(saved[1])
    assert model.upconv1.weight.dtype == torch.int8
    d, own = np.abs(out - ref), np.abs(moved - ref)
    assert d.max() <= 2 * own.max() and d.mean() <= 2 * own.mean(), (d.max() / dr, own.max() / dr)


@pytest.mark.parametrize("mid", [11, 9])
def test_w8_matches_jax_parity(mid):
    """AALN (its MeanShift convs kept f32 by the skip rule, in both
    frameworks) and IMDTN (token linears and grouped convs, against JAX's
    stock params) under w8 and parity: within 1e-4 * dr of JAX, the bar of
    ``test_torch_zoo_cases.check_jax_parity``."""
    model, dr = _port_w8(mid)
    apply, q = _jax_w8(mid)
    if mid == 11:
        for name in ("sub_mean", "add_mean"):
            layer = getattr(model, name)
            assert layer.weight.dtype == torch.float32 and not hasattr(layer, "weight_scale")
            assert q[name]["weight"].dtype == np.float32
    x = np.random.RandomState(0).rand(1, 24, 20, 3).astype(np.float32) * dr
    ref = cases.jax_run(apply, "parity", q, x)
    with torch.inference_mode(), config.numerics_mode("parity"):
        out = model(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * dr, np.abs(out - ref).max() / dr


def test_nlffc_block_w8_matches_jax_fast16():
    """NLFFC's first FFCU block under w8 and fast16, where both frameworks
    merge the 3x3 pair (the port's int8 merge, JAX's merge of the
    dequantized weights), against JAX's ``_ffcu`` on JAX's quantized
    params: within ``BLOCK_BOUNDS["fast16"]`` (4 f16 ulps of the largest
    value, 1/4 of one on average), as tests/test_torch_nlffc.py holds the
    f32 block."""
    model, _ = _port_w8(2)
    _, q = _jax_w8(2)
    x = np.random.RandomState(7).randn(1, 16, 20, 64).astype(np.float32)
    with config.numerics_mode("fast16"), torch.inference_mode():
        xt = ops.from_nhwc(torch.from_numpy(x)).to(torch.float16)
        out = ops.to_nhwc(model.b1(xt)).float().numpy()
    ref = cases.jax_run(jnlffc._ffcu, "fast16", q["b1"], x.astype(np.float16))
    top = np.abs(ref).max()
    bound, mean = cases.BLOCK_BOUNDS["fast16"]
    d = np.abs(out - ref)
    assert d.max() <= bound * top and d.mean() <= mean * top, (d.max() / top, d.mean() / top)


# -- (h) every model ---------------------------------------------------------------

@pytest.mark.parametrize("mid", sorted(registry._REGISTRY))
def test_w8_forward_equals_dequantized_f32(mid):
    """The w8 model holds JAX's int8 weights and f32 scales (MeanShift convs
    and 1-D weights f32), and its forward under parity equals, bit for
    bit, the same model loaded with ``dequantize_params`` of them: under
    f32 the dequant is the product numpy takes, so any site that bypasses
    it shows."""
    spec = registry.get_spec(mid)
    q = jquant.quantize_params_int8(jregistry.load_params(jregistry.get_spec(mid)))
    model, dr = _port_w8(mid)
    ref_state, state = porter.to_torch(q), model.state_dict()
    assert set(state) == set(ref_state)
    for k, v in ref_state.items():
        assert state[k].dtype == v.dtype and torch.equal(state[k], v), k
    assert any(v.dtype == torch.int8 for v in state.values())
    with mock.patch.object(registry, "load_params",
                           lambda s, *dirs: porter.dequantize_params(q)):
        f32 = registry.build_model(mid, device="cpu")[0]
    assert not any(v.dtype == torch.int8 for v in f32.state_dict().values())
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 24, 20, 3).astype(np.float32) * dr)
    with torch.inference_mode(), config.numerics_mode("parity"):
        out, ref = model(x), f32(x)
    assert spec.name and torch.equal(out, ref)


# -- (i) the complexity report ----------------------------------------------------------------

@pytest.mark.parametrize("mid", [4, 0])
def test_complexity_w8_matches_jax(mid):
    """count_params and model_complexity under w8 equal JAX's on its w8
    params: the scales count as deploy params (one per (cin, cout) pair of
    a conv), and the dequant multiplies add no conv or FLOP."""
    model, _ = _port_w8(mid)
    apply, q = _jax_w8(mid)
    ref = jsummary.model_complexity(apply, q, cases.COMPLEXITY_HW)
    assert summary.model_complexity(model, cases.COMPLEXITY_HW) == ref
    assert summary.count_params(model) == jsummary.count_params(q) == ref["num_parameters"] * 1e6
    assert summary.count_params(model) > summary.count_params(registry.build_model(
        mid, device="cpu")[0])


@pytest.mark.parametrize("mid", [4, 33, 2])
def test_replica_copy_keeps_w8(mid):
    """``parallel.eval.Replicas`` copies a model to each other device by
    ``copy.deepcopy(model).to(d)``: the copy keeps the int8 weights, their
    scales and the derived w8 tensors (m_RFDN's fused weights per compute
    dtype, NLFFC's merged pair), as tensors of its own, so the packed-weight
    cache packs each copy once (on the CPU the wrappers take the plain
    versions, so the cache is called here directly)."""
    import copy

    model, _ = _port_w8(mid)
    twin = copy.deepcopy(model).to("cpu")
    tensors = dict(model.named_parameters()) | dict(model.named_buffers())
    copies = dict(twin.named_parameters()) | dict(twin.named_buffers())
    assert set(tensors) == set(copies)
    for k, t in tensors.items():
        assert copies[k].dtype == t.dtype and torch.equal(copies[k], t), k
        assert copies[k].data_ptr() != t.data_ptr(), k
    if mid == 33:
        assert twin.upconv1.w4_bf16 is not None and twin.upconv1.w4_bf16.dtype == torch.float32
    if mid == 2:
        assert twin.b1.w_pair.dtype == torch.int8 and twin.b1.w_pair_scale is not None
    if mid == 4:
        key, pack = conv_chain.layout(torch.float16)
        before = conv_chain.packs
        for m in (model, twin, model, twin):
            convs = (m.B1.c1_r, m.B1.c2_r, m.B1.c3_r)
            conv_chain.packed_weights(key, [c.weight for c in convs], [c.bias for c in convs],
                                      pack, [c.weight_scale for c in convs])
        assert conv_chain.packs == before + 2
