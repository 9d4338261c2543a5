"""The port's reference block library (``models/blocks.py``: ``mode_conv``
and the KAIR blocks) and its ops on the CPU, against the torch goldens
``tests/goldens/blocks.npz`` (``tests/test_blocks_library.py``'s cases)
and against the JAX package's ``blocks.*`` and ``ops.*`` on the same
numpy-seeded inputs; the conv-transpose weight carry of
``porter.to_torch``; and the library's route of ``C`` + ``2``/``4`` to the
tail kernel (its plain version on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_zoo_cases as cases
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu import porter as jporter
from ntire2022_esr_tpu.models import blocks as jblocks
from ntire2022_esr_tpu_torch import config, ops, porter
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.ops.kernels import tail

CASES = {}
with np.load(cases.os.path.join(cases.GOLDEN_DIR, "blocks.npz")) as _z:
    for _key in _z.files:
        _case, _, _rest = _key.partition("/")
        _c = CASES.setdefault(_case, {"params": {}})
        if _rest.startswith("p/"):
            _c["params"][_rest[2:]] = _z[_key]
        else:
            _c[_rest] = _z[_key]

CT_KEYS = (r"^0\.weight$",)  # the conv-transpose weight of up_convtranspose_2R
CT_CASE = "up_convtranspose_2R"

# case -> (the port's module, the JAX function): tests/test_blocks_library.py's 21
BLOCKS = {
    "mode_CBR": (lambda: blocks.ModeConv("CBR"), lambda p, x: jblocks.mode_conv(p, x, "CBR")),
    "mode_CIL": (lambda: blocks.ModeConv("CIL", negative_slope=0.1),
                 lambda p, x: jblocks.mode_conv(p, x, "CIL", negative_slope=0.1)),
    "mode_C2R": (lambda: blocks.ModeConv("C2R"), lambda p, x: jblocks.mode_conv(p, x, "C2R")),
    "mode_MC": (lambda: blocks.ModeConv("M", pool_kernel=2, pool_stride=2),
                lambda p, x: jblocks.mode_conv(p, x, "M", pool_kernel=2, pool_stride=2)),
    "mode_AC": (lambda: blocks.ModeConv("A", pool_kernel=2, pool_stride=2),
                lambda p, x: jblocks.mode_conv(p, x, "A", pool_kernel=2, pool_stride=2)),
    "resblock_CRC": (lambda: blocks.ResBlock("CRC"), lambda p, x: jblocks.res_block(p, x, "CRC")),
    "shortcut": (lambda: blocks.ShortcutBlock(blocks.ModeConv("C")),
                 lambda p, x: jblocks.shortcut_block(jops.conv, p["sub"], x)),
    "concat": (lambda: blocks.ConcatBlock(blocks.ModeConv("C")),
               lambda p, x: jblocks.concat_block(jops.conv, p["sub"], x)),
    "cfrb": (blocks.CFRB, jblocks.cfrb),
    "rcab": (lambda: blocks.RCABlock("CRC"), lambda p, x: jblocks.rcab(p, x, "CRC")),
    "rcagroup": (lambda: blocks.RCAGroup(nb=3), lambda p, x: jblocks.rca_group(p, x, nb=3)),
    "rdb5c": (blocks.ResidualDenseBlock_5C, jblocks.residual_dense_block_5c),
    "rrdb": (blocks.RRDB, jblocks.rrdb),
    "up_pixelshuffle_2R": (lambda: blocks.Resampler("pixelshuffle", "2R"),
                           lambda p, x: jblocks.upsample_pixelshuffle(p, x, "2R")),
    "up_upconv_3R": (lambda: blocks.Resampler("upconv", "3R"),
                     lambda p, x: jblocks.upsample_upconv(p, x, "3R")),
    "up_convtranspose_2R": (lambda: blocks.Resampler("convtranspose", "2R"),
                            lambda p, x: jblocks.upsample_convtranspose(p, x, "2R")),
    "down_strideconv_2R": (lambda: blocks.Resampler("strideconv", "2R"),
                           lambda p, x: jblocks.downsample_strideconv(p, x, "2R")),
    "down_maxpool_2R": (lambda: blocks.Resampler("maxpool", "2R"),
                        lambda p, x: jblocks.downsample_maxpool(p, x, "2R")),
    "down_avgpool_2R": (lambda: blocks.Resampler("avgpool", "2R"),
                        lambda p, x: jblocks.downsample_avgpool(p, x, "2R")),
    "nonlocal": (lambda: blocks.NonLocalBlock2D("B"),
                 lambda p, x: jblocks.non_local_block_2d(p, x, act_mode="B")),
    "nonlocal_ds": (lambda: blocks.NonLocalBlock2D("B", downsample=True),
                    lambda p, x: jblocks.non_local_block_2d(p, x, act_mode="B",
                                                            downsample=True)),
}


def _module(case: str, flat: dict) -> torch.nn.Module:
    """The port's block of ``case`` with the flat HWIO params loaded (strict)."""
    m = BLOCKS[case][0]()
    keys = CT_KEYS if case == CT_CASE else ()
    m.load_state_dict(porter.to_torch(porter.nest(flat), conv_transpose_keys=keys), strict=True)
    return m.eval()


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).contiguous(memory_format=ops.nn.CL)


@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_golden(case):
    c = CASES[case]
    with torch.no_grad(), config.numerics_mode("parity"):
        y = _module(case, c["params"])(_nchw(c["x"]))
    assert tuple(y.shape) == c["y"].shape
    np.testing.assert_allclose(y.numpy(), c["y"], atol=2e-5, rtol=0, err_msg=case)


def test_cbn_golden():
    c = CASES["cbn"]
    m = blocks.ConditionalBatchNorm2d()
    m.load_state_dict(porter.to_torch(porter.nest(c["params"])), strict=True)
    ids = torch.from_numpy(c["extra0"])
    assert ids.dtype == torch.int64
    with torch.no_grad(), config.numerics_mode("parity"):
        y = m(_nchw(c["x"]), ids)
    np.testing.assert_allclose(y.numpy(), c["y"], atol=2e-5, rtol=0)


def test_mode_conv_rejects_unknown_char():
    with pytest.raises(NotImplementedError, match="mode char: 'Z'"):
        blocks.mode_conv(torch.nn.Module(), torch.zeros((1, 3, 4, 4)), "Z")
    with pytest.raises(NotImplementedError, match="mode char: 'Z'"):
        blocks.ModeConv("CZ")


def _seeded_params(case: str, seed: int) -> dict:
    """Params of the golden's shapes from numpy ``seed``: weights scaled by
    their fan-in, biases and BN shifts about 0.1, variances in [0.5, 1.5]."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in CASES[case]["params"].items():
        if k.endswith("running_var"):
            out[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif v.ndim == 4:
            out[k] = (rs.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:3]))).astype(
                np.float32)
        elif k.endswith("weight") and v.ndim == 1:
            out[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = (rs.standard_normal(v.shape) * 0.1).astype(np.float32)
    return out


def _jax_params(flat: dict) -> dict:
    """JAX's params: the same flat tree, nested (up_convtranspose's weight
    is in the JAX porter's flipped HWIO, which ``to_torch`` carries back
    under ``CT_KEYS``)."""
    return jporter.nest({k: jnp.asarray(v) for k, v in flat.items()})


# tier -> (max, mean) bound in units of the largest reference value: parity
# an absolute 2e-5 (f32 on both sides, sums in another order); fast16 and
# fasthi16 store f16, held to tests/test_torch_zoo_cases.py's f16 block
# bounds (a store may round the other way where the f32 sums differ)
LIB_TIERS = ("parity", "fast16", "fasthi16")


@pytest.mark.parametrize("tier", LIB_TIERS)
@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_matches_jax(case, tier):
    flat = _seeded_params(case, 3)
    x = np.random.RandomState(4).rand(*CASES[case]["x"].shape).astype(np.float32)
    with config.numerics_mode(tier):
        act = config.numerics().activation_dtype
    # an input both frameworks hold in the tier's activation dtype
    xa = x.astype(np.float16) if act == torch.float16 else x
    with cases.f32_means():
        ref = cases.jax_run(BLOCKS[case][1], tier, _jax_params(flat),
                            np.transpose(xa, (0, 2, 3, 1)), exact_rounding=True)
    with torch.no_grad(), config.numerics_mode(tier):
        out = _module(case, flat)(_nchw(xa))
    out = np.transpose(out.float().numpy(), (0, 2, 3, 1))
    assert out.shape == ref.shape
    d, top = np.abs(out - ref), np.abs(ref).max()
    if tier == "parity":
        assert d.max() <= 2e-5, d.max()
    else:
        top_bound, mean_bound = cases.BLOCK_BOUNDS["fast16"]
        assert d.max() <= top_bound * top and d.mean() <= mean_bound * top, (
            d.max() / top, d.mean() / top)


@pytest.mark.parametrize("tier", LIB_TIERS)
def test_cbn_matches_jax(tier):
    flat = _seeded_params("cbn", 5)
    x = np.random.RandomState(6).rand(2, 8, 12, 10).astype(np.float16).astype(np.float32)
    ids = np.array([3, 1], np.int64)
    ref = cases.jax_run(lambda p, v, y: jblocks.conditional_batch_norm(p, v, y), tier,
                        jporter.nest(flat), np.transpose(x, (0, 2, 3, 1)), ids)
    m = blocks.ConditionalBatchNorm2d()
    m.load_state_dict(porter.to_torch(porter.nest(flat)), strict=True)
    with torch.no_grad(), config.numerics_mode(tier):
        act = config.numerics().activation_dtype
        out = m(_nchw(x).to(act), torch.from_numpy(ids))
    out = np.transpose(out.float().numpy(), (0, 2, 3, 1))
    d, top = np.abs(out - ref), np.abs(ref).max()
    bound = 2e-5 if tier == "parity" else cases.BLOCK_BOUNDS["fast16"][0] * top
    assert d.max() <= bound, d.max()


@pytest.mark.parametrize("tier", LIB_TIERS)
@pytest.mark.parametrize("kind", ["ca", "cca"])
def test_channel_attention_matches_jax(kind, tier):
    """CALayer (``conv_fc.0``/``.2``) and IMDN's contrast-aware CCALayer
    (``conv_du``), which no golden holds, against JAX's ``ca_layer`` and
    ``cca_layer``; JAX's means summed in f32 (``f32_means``)."""
    rs = np.random.RandomState(16)
    seq = "conv_fc" if kind == "ca" else "conv_du"
    flat = {f"{seq}.0.weight": (rs.standard_normal((1, 1, 16, 4)) / 4).astype(np.float32),
            f"{seq}.0.bias": (rs.standard_normal(4) * 0.1).astype(np.float32),
            f"{seq}.2.weight": (rs.standard_normal((1, 1, 4, 16)) / 2).astype(np.float32),
            f"{seq}.2.bias": (rs.standard_normal(16) * 0.1).astype(np.float32)}
    x = rs.rand(2, 16, 9, 7).astype(np.float16).astype(np.float32)
    fn = jblocks.ca_layer if kind == "ca" else jblocks.cca_layer
    with cases.f32_means():
        ref = cases.jax_run(fn, tier, _jax_params(flat), np.transpose(x, (0, 2, 3, 1)),
                            exact_rounding=True)
    m = blocks.CALayer() if kind == "ca" else blocks.CCALayer()
    m.load_state_dict(porter.to_torch(porter.nest(flat)), strict=True)
    with torch.no_grad(), config.numerics_mode(tier):
        out = m(_nchw(x).to(config.numerics().activation_dtype))
    out = np.transpose(out.float().numpy(), (0, 2, 3, 1))
    d, top = np.abs(out - ref), np.abs(ref).max()
    bound = 2e-5 if tier == "parity" else cases.BLOCK_BOUNDS["fast16"][0] * top
    assert d.max() <= bound, d.max()


# -- the six ops, under every dtype they take ------------------------------

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}
# one ulp of each dtype, relative
ULP = {"f32": 2.0 ** -23, "bf16": 2.0 ** -7, "f16": 2.0 ** -10}


def _pair_inputs(dt: str, shape=(2, 5, 9, 7), seed=0, scale=4.0):
    """(port NCHW tensor, JAX NHWC array) of the same values in ``dt``."""
    x = (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)
    t = _nchw(x).to(DTYPES[dt][0])
    return t, jnp.asarray(np.transpose(t.float().numpy(), (0, 2, 3, 1)), DTYPES[dt][1])


def _as_nchw(a) -> np.ndarray:
    return np.transpose(np.asarray(jnp.asarray(a, jnp.float32)), (0, 3, 1, 2))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["zero_pad2d", "reflect_pad2d", "replicate_pad2d"])
def test_pads_match_jax(name, dt):
    t, j = _pair_inputs(dt)
    pad = (1, 2, 3, 0)  # torch's (left, right, top, bottom)
    out = getattr(ops, name)(t, pad)
    assert out.dtype == t.dtype and out.is_contiguous(memory_format=ops.nn.CL)
    np.testing.assert_array_equal(out.float().numpy(), _as_nchw(getattr(jops.nn, name)(j, pad)))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kernel,stride,padding,include", [
    (2, None, 0, True), (3, 2, 1, True), (3, 2, 1, False), ((3, 2), (1, 2), (1, 0), False)])
def test_avg_pool2d_matches_jax(dt, kernel, stride, padding, include):
    """f32: a few ulps (sums in another order). 2-byte: the port sums in
    f32 and rounds once; JAX sums f16 in f32 too, and XLA's CPU backend
    sums bf16 windows in bf16, so bf16 is held to 2 ulps of the output."""
    t, j = _pair_inputs(dt, seed=1)
    out = ops.avg_pool2d(t, kernel, stride, padding, count_include_pad=include)
    ref = _as_nchw(jops.nn.avg_pool2d(j, kernel, stride, padding, count_include_pad=include))
    assert out.dtype == t.dtype and out.shape == ref.shape
    ulps = {"f32": 8, "f16": 1, "bf16": 2}[dt]
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=ulps * ULP[dt],
                               atol=ulps * ULP[dt] * np.abs(ref).max())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_matches_jax(dt, affine):
    """The mean and variance summed in f32 by the port; JAX's f16 and f32
    the same, its bf16 mean in bf16 on XLA's CPU backend (summed there in
    bf16, :func:`test_torch_zoo_cases.f32_means`), so the bf16 case holds
    JAX to an f32 mean."""
    t, j = _pair_inputs(dt, seed=2)
    rs = np.random.RandomState(3)
    p = {"weight": rs.uniform(0.5, 1.5, 5).astype(np.float32),
         "bias": rs.standard_normal(5).astype(np.float32)} if affine else None
    layer = None
    if affine:
        layer = blocks.Layer()
        layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    out = ops.instance_norm(layer, t)
    if dt == "bf16":
        mean = jnp.mean

        def jmean(a, axis, keepdims, dtype=None):
            return mean(a.astype(jnp.float32), axis=axis, keepdims=keepdims).astype(a.dtype)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jops.nn.jnp, "mean", jmean)
            ref = _as_nchw(jops.nn.instance_norm(p, j))
    else:
        ref = _as_nchw(jops.nn.instance_norm(p, j))
    assert out.dtype == t.dtype
    ulps = {"f32": 16, "f16": 2, "bf16": 2}[dt]
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=ulps * ULP[dt] * np.abs(ref).max())


def _convtranspose_weights(cin=6, cout=4, k=3, seed=7):
    """(torch (I, O, kh, kw) weight, bias) and the JAX porter's flipped HWIO."""
    rs = np.random.RandomState(seed)
    w = (rs.standard_normal((cin, cout, k, k)) / np.sqrt(cin * k * k)).astype(np.float32)
    b = (rs.standard_normal(cout) * 0.1).astype(np.float32)
    hwio = jporter.port_state_dict({"t.weight": w}, conv_transpose_keys=(r"^t\.",))["t.weight"]
    return w, b, hwio


@pytest.mark.parametrize("tier", ["parity", "fasthi16", "fast", "fast16"])
@pytest.mark.parametrize("stride,padding,outpad", [(2, 0, 0), (2, 1, 1), (3, 1, 0)])
def test_conv_transpose2d_matches_jax(tier, stride, padding, outpad):
    w, b, hwio = _convtranspose_weights()
    x = np.random.RandomState(8).rand(2, 6, 7, 5).astype(np.float32)
    with config.numerics_mode(tier):
        act = config.numerics().activation_dtype
    xa = x.astype(np.float16) if act == torch.float16 else x
    ref = cases.jax_run(lambda v: jops.nn.conv_transpose2d(
        v, jnp.asarray(hwio), jnp.asarray(b), stride=stride, padding=padding,
        output_padding=outpad), tier, np.transpose(xa, (0, 2, 3, 1)), exact_rounding=True)
    with config.numerics_mode(tier):
        out = ops.conv_transpose2d(_nchw(xa).to(act), torch.from_numpy(w), torch.from_numpy(b),
                                   stride=stride, padding=padding, output_padding=outpad)
        assert out.dtype == config.numerics().activation_dtype
    out = np.transpose(out.float().numpy(), (0, 2, 3, 1))
    assert out.shape == ref.shape
    top = np.abs(ref).max()
    ulp = {"parity": 2.0 ** -23 * 16, "fasthi16": 2.0 ** -10, "fast": 2.0 ** -7,
           "fast16": 2.0 ** -10}[tier]
    np.testing.assert_allclose(out, ref, rtol=0, atol=ulp * top)


def test_conv_transpose2d_refuses_groups_and_raw_int8():
    w = torch.zeros((4, 2, 2, 2))
    with pytest.raises(NotImplementedError, match="groups=1"):
        ops.conv_transpose2d(torch.zeros((1, 4, 3, 3)), w, groups=2)
    with pytest.raises(TypeError, match="scale"):
        ops.conv_transpose2d(torch.zeros((1, 4, 3, 3)), w.to(torch.int8))


# -- the conv-transpose carry ------------------------------------------------

def test_to_torch_carries_conv_transpose_weights():
    """The JAX porter's flipped HWIO (kh, kw, I, O) comes back as torch's
    (I, O, kh, kw) exactly, and ``nn.ConvTranspose2d`` with it computes
    what ``ops.conv_transpose2d`` computes; without the pattern the same
    key would be read as an ordinary conv's weight (the fault this
    carries past)."""
    w, b, hwio = _convtranspose_weights()
    tree = porter.nest({"up.weight": hwio, "up.bias": b})
    state = porter.to_torch(tree, conv_transpose_keys=(r"^up\.",))
    torch.testing.assert_close(state["up.weight"], torch.from_numpy(w), rtol=0, atol=0)
    assert tuple(porter.to_torch(tree)["up.weight"].shape) == (4, 6, 3, 3)
    ref = torch.nn.ConvTranspose2d(6, 4, 3, stride=2, padding=1, output_padding=1)
    ref.load_state_dict({"weight": state["up.weight"], "bias": state["up.bias"]})
    x = torch.from_numpy(np.random.RandomState(9).rand(1, 6, 5, 4).astype(np.float32))
    with torch.no_grad(), config.numerics_mode("parity"):
        got = ops.conv_transpose2d(x, state["up.weight"], state["up.bias"], stride=2, padding=1,
                                   output_padding=1)
        torch.testing.assert_close(got, ref(x), rtol=0, atol=1e-6)


def test_to_torch_carries_w8_conv_transpose_scales():
    """A w8 tree: the int8 weight un-flipped and transposed like the f32
    one, its (1, 1, I, O) scale to (I, O, 1, 1), so the dequant is the
    carried dequantized weight bit for bit."""
    w, b, hwio = _convtranspose_weights()
    tree = porter.quantize_params_int8(porter.nest({"up.weight": hwio, "up.bias": b}))
    state = porter.to_torch(tree, conv_transpose_keys=(r"^up\.",))
    q, s = state["up.weight"], state["up.weight_scale"]
    assert q.dtype == torch.int8 and tuple(q.shape) == (6, 4, 3, 3)
    assert tuple(s.shape) == (6, 4, 1, 1)
    want = porter.to_torch(porter.dequantize_params(tree), conv_transpose_keys=(r"^up\.",))
    torch.testing.assert_close(q.float() * s, want["up.weight"], rtol=0, atol=0)


def test_library_w8_upsamplers_match_dequantized():
    """Under w8 the tail route and the conv-transpose route dequantize the
    int8 weights in the compute dtype: equal to the f32 block on the
    dequantized weights."""
    for case, keys in (("up_pixelshuffle_2R", ()), (CT_CASE, CT_KEYS)):
        flat = _seeded_params(case, 11)
        tree = porter.quantize_params_int8(porter.nest(flat))
        q = BLOCKS[case][0]()
        state = porter.to_torch(tree, conv_transpose_keys=keys)
        for k, v in state.items():
            if k.endswith("weight_scale"):
                layer = q.get_submodule(k[:-len(".weight_scale")])
                layer.weight = torch.nn.Parameter(torch.empty_like(state[k[:-6]]),
                                                  requires_grad=False)
                layer.weight_scale = torch.nn.Parameter(torch.empty_like(v), requires_grad=False)
        q.load_state_dict(state, strict=True)
        f = _module(case, porter.flatten(porter.dequantize_params(tree)))
        x = _nchw(np.random.RandomState(12).rand(*CASES[case]["x"].shape).astype(np.float32))
        with torch.no_grad(), config.numerics_mode("parity"):
            torch.testing.assert_close(q(x), f(x), rtol=0, atol=0)


# -- the tail-kernel route ---------------------------------------------------

@pytest.fixture
def plain_tail_calls(monkeypatch):
    """Counts the tail kernel's plain-version calls (what its wrapper runs
    on a CPU tensor)."""
    calls = []
    plain = tail.conv3x3_pixelshuffle_plain

    def counted(x, w, b, *, r=4, scale=None):
        calls.append((int(x.shape[1]), int(w.shape[0]), r))
        return plain(x, w, b, r=r, scale=scale)

    monkeypatch.setattr(tail, "conv3x3_pixelshuffle_plain", counted)
    return calls


def _conv_layer(cin, cout, k, seed=13):
    rs = np.random.RandomState(seed)
    layer = blocks.Layer()
    layer.load_state_dict({
        "weight": torch.from_numpy((rs.standard_normal((cout, cin, k, k)) * 0.2).astype(
            np.float32)),
        "bias": torch.from_numpy(rs.standard_normal(cout).astype(np.float32))})
    return layer


@pytest.mark.parametrize("mode,r,k,kw,want", [
    ("C2R", 2, 3, {}, [(8, 12, 2)]),
    ("C4", 4, 3, {}, [(8, 48, 4)]),
    ("C2", 2, 3, {"stride": 2}, []),
    ("C2", 2, 1, {"padding": 0}, []),
    ("C2", 2, 3, {"padding": 0}, []),
    ("C3", 3, 3, {}, []),
])
def test_mode_conv_tail_route(plain_tail_calls, mode, r, k, kw, want):
    """``C`` then ``2`` or ``4`` at a same-padded 3x3 conv of stride 1 goes
    through ``fused_conv3x3_pixelshuffle`` (its plain version here);
    stride 2, a 1x1 conv, padding 0 and r = 3 stay on ``ops.conv``. Either
    way the result is ``pixel_shuffle(conv(x))``."""
    cout = {2: 12, 3: 27, 4: 48}[r]
    layer = _conv_layer(8, cout, k)
    p = torch.nn.Module()
    p.add_module("0", layer)
    x = _nchw(np.random.RandomState(14).rand(2, 8, 10, 12).astype(np.float32))
    with torch.no_grad(), config.numerics_mode("parity"):
        out = blocks.mode_conv(p, x, mode, **kw)
        ref = ops.pixel_shuffle(ops.conv(layer, x, stride=kw.get("stride", 1),
                                         padding=kw.get("padding", 1)), r)
        if mode.endswith("R"):
            ref = ops.relu(ref)
    assert plain_tail_calls == want
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_upsamplers_reach_the_tail(plain_tail_calls):
    """The library's pixel-shuffle upsamplers at KAIR's default widths
    (64 -> 256 at r = 2, 64 -> 48 at r = 4, at a small size here) and
    ``pixelshuffle_tail`` each call the tail once per forward."""
    x = _nchw(np.random.RandomState(15).rand(1, 64, 6, 5).astype(np.float32))
    up2 = blocks.Resampler("pixelshuffle", "2R")
    up2.load_state_dict({"0.weight": _conv_layer(64, 256, 3).weight,
                         "0.bias": torch.zeros(256)})
    up4 = blocks.Resampler("pixelshuffle", "4")
    up4.load_state_dict({"0.weight": _conv_layer(64, 48, 3).weight, "0.bias": torch.zeros(48)})
    with torch.no_grad(), config.numerics_mode("parity"):
        assert tuple(up2(x).shape) == (1, 64, 12, 10)
        assert tuple(up4(x).shape) == (1, 3, 24, 20)
        assert tuple(blocks.pixelshuffle_tail(_conv_layer(64, 48, 3), x, 4).shape) == (
            1, 3, 24, 20)
    assert plain_tail_calls == [(64, 256, 2), (64, 48, 4), (64, 48, 4)]

