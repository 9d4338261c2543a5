"""Shared checks (no tests of their own) of the port's conv zoo against the
JAX package, used by ``tests/test_torch_rfdn.py``,
``tests/test_torch_imdn_efdn.py``, ``tests/test_torch_conv_zoo_*.py``,
``tests/test_torch_hr_tail.py`` and ``tests/test_torch_attention_zoo.py``.

Every model is held, on the CPU, to:

- its torch-reference goldens under ``parity`` (the bar of
  ``tests/test_model_parity.py``, 2e-4 * data_range);
- the JAX apply under ``parity`` on the same numpy-seeded input;
- under its gated tier, one block and its attention gate fed the same
  input as the JAX ones, and under ``fasthi`` the whole model on a real
  image;
- the JAX ``model_complexity`` exactly, and a weight carry that consumes
  every cached key.
"""

from __future__ import annotations

import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu.harness import registry as jregistry
from ntire2022_esr_tpu.harness import summary as jsummary
from ntire2022_esr_tpu.models import aaln as jaaln
from ntire2022_esr_tpu.models import afdn as jafdn
from ntire2022_esr_tpu.models import arfdn as jarfdn
from ntire2022_esr_tpu.models import blocks as jblocks
from ntire2022_esr_tpu.models import bsrn as jbsrn
from ntire2022_esr_tpu.models import clrfdn as jclrfdn
from ntire2022_esr_tpu.models import efdn as jefdn
from ntire2022_esr_tpu.models import fden as jfden
from ntire2022_esr_tpu.models import fmen as jfmen
from ntire2022_esr_tpu.models import hnct as jhnct
from ntire2022_esr_tpu.models import imdeception as jimdec
from ntire2022_esr_tpu.models import imdtn as jimdtn
from ntire2022_esr_tpu.models import m_rfdn as jmrfdn
from ntire2022_esr_tpu.models import mdan as jmdan
from ntire2022_esr_tpu.models import misc_conv as jmisc
from ntire2022_esr_tpu.models import mobilesr as jmsr
from ntire2022_esr_tpu.models import msdn as jmsdn
from ntire2022_esr_tpu.models import nasnetbn as jnas
from ntire2022_esr_tpu.models import plainrfdn as jplain
from ntire2022_esr_tpu.models import prrn as jprrn
from ntire2022_esr_tpu.models import repafdn as jrepafdn
from ntire2022_esr_tpu.models import resdn as jresdn
from ntire2022_esr_tpu.models import rfesr as jrfesr
from ntire2022_esr_tpu.models import rfdn_variants as jvar
from ntire2022_esr_tpu.models import rlcsr as jrlcsr
from ntire2022_esr_tpu.models import scet as jscet
from ntire2022_esr_tpu_torch import config, ops, porter
from ntire2022_esr_tpu_torch.harness import registry, serving, summary

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
COMPLEXITY_HW = (48, 40)  # large enough for every ESA's strided conv and pools


def goldens(ids):
    return [os.path.splitext(f)[0] for f in sorted(os.listdir(GOLDEN_DIR))
            for i in ids if f.startswith(f"model_{i:02d}.") or f.startswith(f"model_{i:02d}_")]


_models: dict = {}


def port_model(mid: int):
    """(model, name, data_range), built once per process on the CPU."""
    if mid not in _models:
        model, name, dr, _ = registry.build_model(mid, device="cpu")
        _models[mid] = (model, name, dr)
    return _models[mid]


def jax_model(mid: int, stock: bool = False):
    """The JAX apply and params; ``stock`` skips the load-time transform
    (IMDTN's densified grouped convs), leaving the cache's own layout."""
    apply, params, *_ = jregistry.build_model(mid, apply_load_transform=not stock)
    return apply, params


def jax_run(fn, tier, *args, exact_rounding: bool = False):
    """``fn(*args)`` jitted under ``tier``, as f32 numpy. ``exact_rounding``
    compiles it without XLA's excess precision: by default XLA's CPU
    backend may keep a 2-byte elementwise result in f32 where a convert to
    f32 consumes it (a bf16 sum that feeds a conv is then never rounded to
    bf16), which the JAX code does not write and the port does not do."""
    # a fresh function per call: jax.jit caches on the function object and
    # would silently reuse a trace made under another tier
    with jconfig.numerics_mode(tier):
        f = jax.jit(lambda *a: fn(*a))
        if exact_rounding:
            f = f.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})
        return np.asarray(f(*args)).astype(np.float32)


def check_golden(stem: str) -> None:
    model, _, _ = port_model(int(stem.split("_")[1]))
    g = np.load(os.path.join(GOLDEN_DIR, f"{stem}.npz"))
    img, data_range, ref = g["input_u8"], float(g["data_range"]), g["output"]
    x = torch.from_numpy((img.astype(np.float32) / (255.0 / data_range))[None])
    with torch.inference_mode(), config.numerics_mode("parity"):
        out = model(x).numpy()[0]
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err < 2e-4 * data_range, err


def check_jax_parity(mid: int) -> None:
    """The JAX apply and the port under parity on one seeded input. f32 on
    both sides, sums in another order: measured at most 2.5e-5 * dr apart
    for 13 of the models and 8.2e-4 * dr for model 13, whose dilated
    convs carry this uniform-noise input to outputs of +-20 (the image
    range is 0..1); the bound is 1e-4 * dr, and 2e-3 * dr for model 13.

    PRRN (16) is chaotic on that input: its outputs reach 162 (the image
    range is 0..1), and JAX's own output moves by up to 40 when the input
    moves by 1e-7 (measured). It is held to JAX on the real image crop of
    :func:`image_crop` instead, where it stays in range (measured 9.5e-7
    apart)."""
    model, _, dr = port_model(mid)
    apply, params = jax_model(mid)
    if mid == 16:
        x = image_crop(mid)
    else:
        x = np.random.RandomState(0).rand(1, 24, 20, 3).astype(np.float32) * dr
    ref = jax_run(apply, "parity", params, x)
    with torch.inference_mode(), config.numerics_mode("parity"):
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 4 * x.shape[1], 4 * x.shape[2], 3)
    bound = (2e-3 if mid == 13 else 1e-4) * dr
    assert np.abs(out - ref).max() <= bound, np.abs(out - ref).max()


def image_crop(mid: int) -> np.ndarray:
    """A 40x32 crop of the model's 63x41 golden input: a real image."""
    _, _, dr = port_model(mid)
    g = np.load(os.path.join(GOLDEN_DIR, f"model_{mid:02d}_63x41.npz"))
    return np.ascontiguousarray((g["input_u8"][:40, :32].astype(np.float32) / (255.0 / dr))[None])


def check_fasthi_model(mid: int) -> None:
    """The whole model under ``fasthi``: every conv output is rounded to
    bf16, and where the two frameworks' f32 sums differ in their last bits
    a store rounds the other way; the network carries such flips on. On
    this input JAX's own fasthi output moves by up to 1.2e-2 * dr (mean
    3.1e-4 * dr) when its input moves by 1e-4 * dr, and the port differs
    from JAX by at most 1.2e-2 * dr (mean 4.8e-4 * dr) over the six fasthi
    models (measured on the CPU). The bound is that scale: max 2e-2 * dr,
    mean 1e-3 * dr."""
    model, _, dr = port_model(mid)
    apply, params = jax_model(mid)
    x = image_crop(mid)
    ref = jax_run(apply, "fasthi", params, x)
    with torch.inference_mode(), config.numerics_mode("fasthi"):
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    d = np.abs(out.float().numpy() - ref)
    assert d.max() <= 2e-2 * dr and d.mean() <= 1e-3 * dr, (d.max() / dr, d.mean() / dr)


def _conv(q, v):
    return jops.conv(q, v)


def _block_cases(mid: int):
    """(head fn, its params, [(tag, port module, JAX fn, its params)]) for
    one block of the model and an attention gate, each fed the head's
    output (the first conv, or the layers before the first block)."""
    model, _, _ = port_model(mid)
    _, p = jax_model(mid)
    if mid in (-1, 26):
        sub = p["model"]["1"]["sub"]["0"]
        return _conv, p["model"]["0"], [
            ("IMDBlock", model.model[1].sub[0], lambda q, v: jblocks.imd_block(q, v, 16), sub)]
    if mid == 1:
        cell = p["cells"]["0"]
        return _conv, p["head"], [("Cell", model.cells[0], jefdn._cell, cell),
                                  ("ESA", model.cells[0].att, jblocks.esa, cell["att"])]
    if mid == 3:
        return _conv, p["head"], [
            ("BasicBlock", model.basic_blocks[0], jfmen._basic_block, p["basic_blocks"]["0"]),
            ("HFAB", model.hfabs[0], lambda q, v: jfmen._hfab(q, v, 1), p["hfabs"]["0"])]
    if mid == 11:
        b = p["B1"]
        return _conv, p["input"]["0"], [
            ("AttBlock", model.B1, jaaln._att_block, b),
            ("DSAB1", model.B1.conv_block0, jaaln._dsab1, b["conv_block0"]),
            ("LightSAAtt", model.B1.att, jaaln._lightsaatt, b["att"])]
    if mid == 16:
        b = p["scpa_v1"]
        return _conv, p["conv_first"], [("PRRB", model.scpa_v1, jprrn._prrb, b),
                                        ("CA", model.scpa_v1.sca, jprrn._ca_tf, b["sca"])]
    if mid == 17:
        b = p["IMDB1"]
        return _conv, p["fea_conv"], [("FDEB", model.IMDB1, jfden._fdeb, b),
                                      ("LapSA", model.IMDB1.sa, jfden._lap_sa, b["sa"])]
    if mid == 18:
        b = p["B1"]
        return (lambda q, v: jbsrn._bsconv(q, jax.numpy.concatenate([v] * 4, axis=-1)),
                p["fea_conv"], [("RFDB18", model.B1, jbsrn._rfdb18, b),
                                ("ESA18", model.B1.esa, jbsrn._esa18, b["esa"])])
    if mid == 19:
        return _conv, p["feat_conv0"], [
            ("GIDB", model.block1, lambda q, v: jimdec._gidb(q, v, 16, 48), p["block1"]),
            ("BlockSelfAttention", lambda t: model.self_attention1(t[:, 16:]),
             lambda q, v: jimdec._block_self_attention(q, v[..., 16:]), p["self_attention1"])]
    if mid == 23:
        return _conv, p["conv_first"], [
            ("MIRB", model.BS1.bs2, lambda q, v: jmdan._mirb(q, v, 2), p["BS1"]["bs2"]),
            ("MDAB", model.upb1, jmdan._mdab, p["upb1"])]
    if mid in _LAST_SLICE_CASES:
        return _LAST_SLICE_CASES[mid](model, p)
    if mid in ATTENTION_CASES:
        return ATTENTION_CASES[mid](model, p)
    b = p["B1"]
    block = {
        5: jplain._rfdb_plain, 25: jvar._frfdb, 35: jvar._rfdb35, 37: jvar._bmdb,
        38: jvar._rfdnext_block, 10: lambda q, v: jrepafdn._fdb(q, v, 2), 14: jarfdn._arfdb,
        15: jafdn._afdb,
        8: lambda q, v: jblocks.rfdb(q, v, residual=False, esa_fn=jblocks.esa_no_f),
        13: lambda q, v: jblocks.rfdb(q, v, dilations=(1, 2, 5)),
        40: lambda q, v: jblocks.rfdb(q, v, residual=False),
    }.get(mid, jblocks.rfdb)
    gate, gate_name = {5: (jplain.esa_plain, "esa"), 8: (jblocks.esa_no_f, "esa"),
                       35: (jvar._esa_unshuffle, "esa"), 38: (jvar._cx, "esa"),
                       14: (jblocks.esa, "mpa"), 15: (jafdn._atb, "ATB")}.get(
                           mid, (jblocks.esa, "esa"))
    return _conv, p["fea_conv"], [("block", model.B1, block, b),
                                  ("gate", getattr(model.B1, gate_name), gate, b[gate_name])]


def _wrapped_conv(key: str):
    return lambda q, v: jops.conv(q[key], v)


# the models of the last conv-zoo slice: model, JAX params -> _block_cases' triple
_LAST_SLICE_CASES = {
    24: lambda m, p: (_conv, p["fea_conv"], [("MDSA", m.B[0], jmisc._mdsa, p["B"]["0"])]),
    27: lambda m, p: (_conv, p["conv_first"], [("LWFA", m.body[0], jmisc._lwfa, p["body"]["0"])]),
    28: lambda m, p: (
        lambda q, v: jops.leaky_relu(jops.conv(q, v), 0.1), p["conv_first"], [
            ("InvertedResidual", m.recon_trunk[5], jnas._inverted_residual, p["recon_trunk"]["5"]),
            ("ResidualBlockBN", m.recon_trunk[2], jnas._res_bn, p["recon_trunk"]["2"]),
            ("ResidualBlockLeakyBN", m.recon_trunk[0], jnas._res_leaky_bn, p["recon_trunk"]["0"])]),
    29: lambda m, p: (_wrapped_conv("conv3x3"), p["fea_conv"], [
        ("RFDB29", m.B1, jclrfdn._rfdb29, p["B1"]),
        ("ESA", m.B1.esa, jblocks.esa, p["B1"]["esa"])]),
    31: lambda m, p: (_wrapped_conv("conv"), p["fea_conv"], [
        ("BuildingBlock", m.mods[0], jmisc._building_block, p["mods"]["0"]),
        ("ESA", m.mods[0].esa_last, jmisc._esa31, p["mods"]["0"]["esa_last"])]),
    33: lambda m, p: (_conv, p["fea_conv"], [
        ("m_RFDB", m.B1, jmrfdn._m_rfdb, p["B1"]),
        ("Multiception", m.B1.c1_r, lambda q, v: jmrfdn._multiception(q, v, 3), p["B1"]["c1_r"])]),
    34: lambda m, p: (_conv, p["conv_first"]["0"], [
        ("ResidualBlock_ESA", m.recon_trunk[0][0], jmisc._res_esa, p["recon_trunk"]["0"]["0"]),
        ("ESA34", m.recon_trunk[0][0].ESA, jmisc._esa34, p["recon_trunk"]["0"]["0"]["ESA"])]),
    36: lambda m, p: (_conv, p["fea_conv"], [
        ("LRFFB", m.B1, jrfesr._lrffb, p["B1"]),
        ("EFSA", m.B1.b0.body[3], jrfesr._efsa, p["B1"]["b0"]["body"]["3"])]),
    39: lambda m, p: (_conv, p["FEM"]["0"], [
        ("IMDB_plus", m.FEM[1].sub[0], lambda q, v: jmisc._imdb_plus(q, v, 6),
         p["FEM"]["1"]["sub"]["0"])]),
    42: lambda m, p: (
        lambda q, v: (jops.conv(q["conv1_2"], v) + jops.conv(q["conv1_1"], v)
                      + jops.conv(q["conv1_3"], v)), p, [
            ("RFDB42", m.B1, jrlcsr._rfdb42, p["B1"]),
            ("ESA42", m.B1.esa, jrlcsr._esa42, p["B1"]["esa"])]),
    43: lambda m, p: (
        lambda q, v: jops.conv(q["fea_conv"], jops.conv(q["sub_mean"], v, padding=0)), p, [
            ("ResDB", m.body_unit1, jresdn._resdb, p["body_unit1"]),
            ("ESA", m.body_unit1.attention, jblocks.esa, p["body_unit1"]["attention"])]),
    44: lambda m, p: (lambda q, v: jops.conv(q, v * 255.0), p["fea_conv"], [
        ("MSDB", m.B[0], lambda q, v: jmsdn._msdb(q, v, 4), p["B"]["0"]),
        ("VisionAttention", m.B[0].attention, lambda q, v: jmsdn._vision_attention(q, v, 4),
         p["B"]["0"]["attention"])]),
}


# the attention family: model, JAX params -> _block_cases' triple. The
# heads crop the image so that IMDTN's windows of 6 tile it (36x30) and
# MobileSR's windows of 8 pad it (40x30 -> 40x32).
ATTENTION_CASES = {
    9: lambda m, p: (lambda q, v: jops.conv(q, v[:, :36, :30]), p["fea_conv"], [
        ("IMDTB", m.IMDTB1, lambda q, v: jimdtn._imdtb(q, v, 16), p["IMDTB1"]),
        ("RSTB", m.IMDTB1.transformer, jimdtn._rstb, p["IMDTB1"]["transformer"])]),
    12: lambda m, p: (_conv, p["fea_conv"], [
        ("STB", m.B1, jhnct._stb, p["B1"]),
        ("SwinT", m.B1.swinT, jhnct._swin_t, p["B1"]["swinT"])]),
    20: lambda m, p: (lambda q, v: jops.conv(q, v[:, :, :30]), p["head"], [
        ("Transformer", m.body.layers[0]["0"], jmsr._transformer, p["body"]["layers"]["0"]["0"]),
        ("ResBlock", m.body.layers[0]["1"], jmsr._res_block, p["body"]["layers"]["0"]["1"])]),
    30: lambda m, p: (_conv, p["conv3"], [
        ("TransformerBlock", m.path1["1"].arr[0], jscet._transformer_block,
         p["path1"]["1"]["arr"]["0"]),
        ("SCPA", m.path1["0"].arr[0], jscet._scpa, p["path1"]["0"]["arr"]["0"])]),
}


# Per-tier bounds of check_blocks, as (max, mean) of |port - JAX| in units
# of the largest reference value.
# - high: f32 on both sides, sums in another order: measured at most 1.2e-6
#   (19 f32 ulps); the bound is 1e-5.
# - fasthi and fast: every conv output is rounded to bf16, and a store may
#   round the other way where the two f32 sums differ in their last bits:
#   at most 4 bf16 ulps (2**-7 relative) anywhere and 1/8 of one on
#   average (measured at most 1.1e-2 and 4.1e-4, PRRN under fasthi).
# - fast16: the same in f16 ulps (2**-10), but 1/4 of one on average: XLA's
#   CPU GELU, sigmoid and SiLU on f16 are off by 0.87, 0.44 and 0.60 f16
#   ulps on average against f64 (the port's, rounded once from f32: 0.26,
#   0.25, 0.33); BSRN's block, which applies GELU seven times, measured
#   2.0e-3 and 1.9e-4.
BLOCK_BOUNDS = {"high": (1e-5, 1e-5), "fasthi": (4 * 2.0 ** -7, 2.0 ** -7 / 8),
                "fast": (4 * 2.0 ** -7, 2.0 ** -7 / 8),
                "fast16": (4 * 2.0 ** -10, 2.0 ** -10 / 4)}


@contextlib.contextmanager
def f32_means():
    """The JAX ``global_avg_pool`` with its sum taken in f32. Under a bf16
    tier the JAX op reduces in bf16 (``jnp.mean(..., dtype=bfloat16)``),
    and XLA's CPU backend then accumulates in bf16: 1280 values of mean
    0.41 sum to 512 against 521.25 (measured). The TPU sums in f32, and so
    does the port (``ops.global_avg_pool``); under f32 and f16 the JAX op
    already sums in f32, so this changes nothing there."""
    def gap(x, keepdims: bool = True):
        return jax.numpy.mean(x.astype(jax.numpy.float32), axis=(1, 2),
                              keepdims=keepdims).astype(x.dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "global_avg_pool", gap)
        mp.setattr(jops.nn, "global_avg_pool", gap)
        yield


# The attention models whose f32 scores config.attn_bf16 rounds to bf16 at
# their gated tier ("scores": HNCT under high, IMDTN under fast16, whose f16
# scores turn f32 when the f32 relative-position bias is added). Where the
# two frameworks' f32 logits differ in their last bits, a logit rounds to
# the neighbouring bf16 value, which moves its probability by up to 2**-8
# times the logit: bf16 roundings, held to the bf16 tier's bounds. Measured
# on the CPU: HNCT's Swin layer 1.1e-4 max, 2.9e-7 mean (2.6e-7 and 3.3e-8
# with the scores in f32); IMDTN's RSTB 1.8e-2 and 4.2e-4 (3.6e-3 and
# 2.8e-4 with the scores in f32). MobileSR's scores stay f16 under fast16,
# so "scores" leaves them alone and its blocks keep the f16 bounds.
SCORES_BF16_SITES = {9: "imdtn", 12: "hnct"}


def block_bounds(mid: int, tier: str):
    """(max, mean) bound of check_blocks for model ``mid`` under ``tier``."""
    with config.numerics_mode(tier):
        if mid in SCORES_BF16_SITES and config.attn_bf16(SCORES_BF16_SITES[mid]) != "off":
            return BLOCK_BOUNDS["fast"]
    return BLOCK_BOUNDS[tier]


def check_blocks(mid: int, tier: str) -> None:
    """One block and its gate under ``tier``, fed JAX's head output on a
    real image, within ``BLOCK_BOUNDS[tier]``; JAX's means summed in f32
    (:func:`f32_means`). The models of the last zoo slice hold JAX to the
    roundings its code writes (``jax_run``'s ``exact_rounding``): with XLA's
    excess precision RFESR's EFSA gate differs by 8.6% of its largest value
    under fasthi (its bf16 sum ``c3 + c1_`` of values up to 1328 and 230
    feeds a 1x1 conv unrounded), without it by one bf16 ulp (measured on
    the CPU)."""
    head_fn, head, cases = _block_cases(mid)
    x = image_crop(mid)
    with f32_means(), jconfig.numerics_mode(tier):
        # a fresh function: jax.jit(head_fn) would reuse a trace that another
        # model's check made of the same head function under another tier
        h = np.asarray(jax.jit(lambda *a: head_fn(*a))(head, x))
    top_bound, mean_bound = block_bounds(mid, tier)
    with config.numerics_mode(tier), torch.inference_mode():
        act = config.numerics().activation_dtype
        ht = ops.from_nhwc(torch.from_numpy(h.astype(np.float32))).to(act)
        for tag, module, fn, q in cases:
            with f32_means():
                ref = jax_run(fn, tier, q, h,
                              exact_rounding=mid in _LAST_SLICE_CASES or mid in ATTENTION_CASES)
            out = ops.to_nhwc(module(ht)).float().numpy()
            assert out.shape == ref.shape, tag
            d, top = np.abs(out - ref), np.abs(ref).max()
            assert d.max() <= top_bound * top, (tag, d.max() / top)
            assert d.mean() <= mean_bound * top, (tag, d.mean() / top)


def check_complexity(mid: int) -> None:
    """The JAX count of the cache's own layout (IMDTN's grouped convs, as
    the reference counts them, not the densified ones)."""
    model, name, _ = port_model(mid)
    apply, params = jax_model(mid, stock=True)
    ref = jsummary.model_complexity(apply, params, COMPLEXITY_HW)
    assert summary.model_complexity(model, COMPLEXITY_HW) == ref
    assert ref["num_parameters"] * 1e6 == summary.count_params(model)


def check_weight_carry(mid: int) -> None:
    model, _, _ = port_model(mid)
    _, params = jax_model(mid, stock=True)
    flat = porter.to_torch(params)
    state = model.state_dict()
    assert set(flat) == set(state)
    for k, v in flat.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)


def check_registry_fields(mid: int) -> None:
    spec, jspec = registry.get_spec(mid), jregistry.get_spec(mid)
    for field in ("name", "ckpt", "data_range", "tile", "max_tiles_per_call"):
        assert getattr(spec, field) == getattr(jspec, field), field


def check_server_tier(mid: int, gated: str) -> None:
    """``SRServer`` serves at the gated tier by default, uint8 in and out."""
    name = registry.get_spec(mid).name
    assert serving.gated_tier(name) == gated
    srv = serving.SRServer(model_id=mid, device="cpu", max_batch=1)
    assert srv.tier == gated
    out = srv.process_one(np.zeros((24, 20, 3), np.uint8))
    assert out.shape == (96, 80, 3) and out.dtype == np.uint8
