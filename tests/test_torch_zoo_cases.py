"""Shared checks (no tests of their own) of the port's RFDN skeleton and IMDN
family against the JAX package, used by ``tests/test_torch_rfdn.py`` and
``tests/test_torch_imdn_efdn.py``.

Every model is held, on the CPU, to:

- its torch-reference goldens under ``parity`` (the bar of
  ``tests/test_model_parity.py``, 2e-4 * data_range);
- the JAX apply under ``parity`` on the same numpy-seeded input;
- under its gated tier where that tier is ported (``high`` or ``fasthi``),
  one block and its attention gate fed the same input as the JAX ones,
  and under ``fasthi`` the whole model on a real image;
- the JAX ``model_complexity`` exactly, and a weight carry that consumes
  every cached key.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu.harness import registry as jregistry
from ntire2022_esr_tpu.harness import summary as jsummary
from ntire2022_esr_tpu.models import blocks as jblocks
from ntire2022_esr_tpu.models import efdn as jefdn
from ntire2022_esr_tpu.models import plainrfdn as jplain
from ntire2022_esr_tpu.models import rfdn_variants as jvar
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


def jax_model(mid: int):
    apply, params, *_ = jregistry.build_model(mid)
    return apply, params


def jax_run(fn, tier, *args):
    # a fresh function per call: jax.jit caches on the function object and
    # would silently reuse a trace made under another tier
    with jconfig.numerics_mode(tier):
        return np.asarray(jax.jit(lambda *a: fn(*a))(*args)).astype(np.float32)


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
    range is 0..1); the bound is 1e-4 * dr, and 2e-3 * dr for model 13."""
    model, _, dr = port_model(mid)
    apply, params = jax_model(mid)
    x = np.random.RandomState(0).rand(1, 24, 20, 3).astype(np.float32) * dr
    ref = jax_run(apply, "parity", params, x)
    with torch.inference_mode(), config.numerics_mode("parity"):
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 96, 80, 3)
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


def _block_cases(mid: int):
    """(head params, [(tag, port module, JAX fn, its params)]) for one block
    of the model and its attention gate, each fed the head conv's output."""
    model, _, _ = port_model(mid)
    _, p = jax_model(mid)
    if mid in (-1, 26):
        sub = p["model"]["1"]["sub"]["0"]
        return p["model"]["0"], [
            ("IMDBlock", model.model[1].sub[0], lambda q, v: jblocks.imd_block(q, v, 16), sub)]
    if mid == 1:
        cell = p["cells"]["0"]
        return p["head"], [("Cell", model.cells[0], jefdn._cell, cell),
                           ("ESA", model.cells[0].att, jblocks.esa, cell["att"])]
    b = p["B1"]
    block = {
        5: jplain._rfdb_plain, 25: jvar._frfdb, 35: jvar._rfdb35, 37: jvar._bmdb,
        38: jvar._rfdnext_block,
        8: lambda q, v: jblocks.rfdb(q, v, residual=False, esa_fn=jblocks.esa_no_f),
        13: lambda q, v: jblocks.rfdb(q, v, dilations=(1, 2, 5)),
        40: lambda q, v: jblocks.rfdb(q, v, residual=False),
    }.get(mid, jblocks.rfdb)
    gate = {5: jplain.esa_plain, 8: jblocks.esa_no_f, 35: jvar._esa_unshuffle,
            38: jvar._cx}.get(mid, jblocks.esa)
    return p["fea_conv"], [("block", model.B1, block, b), ("gate", model.B1.esa, gate, b["esa"])]


def check_blocks(mid: int, tier: str) -> None:
    """One block and its gate under ``tier`` fed JAX's head-conv output of a
    real image. ``high`` is f32 on both sides (sums in another order): 1e-5
    of the largest value (measured at most 19 f32 ulps, 2.2e-6). ``fasthi``
    stores every conv output in bf16 and a store may round the other way:
    at most 4 bf16 ulps (2**-7 relative) of the largest value anywhere and
    1/8 of one on average (measured at most 1.8 and 0.04)."""
    head, cases = _block_cases(mid)
    x = image_crop(mid)
    with jconfig.numerics_mode(tier):
        h = np.asarray(jax.jit(lambda q, v: jops.conv(q, v))(head, x))
    with config.numerics_mode(tier), torch.inference_mode():
        act = config.numerics().activation_dtype
        ht = ops.from_nhwc(torch.from_numpy(h.astype(np.float32))).to(act)
        for tag, module, fn, q in cases:
            ref = jax_run(fn, tier, q, h)
            out = ops.to_nhwc(module(ht)).float().numpy()
            assert out.shape == ref.shape, tag
            d, top = np.abs(out - ref), np.abs(ref).max()
            if tier == "high":
                assert d.max() <= 1e-5 * top, (tag, d.max() / top)
            else:
                assert d.max() <= 4 * 2.0 ** -7 * top, (tag, d.max() / top)
                assert d.mean() <= 2.0 ** -7 / 8 * top, (tag, d.mean() / top)


def check_complexity(mid: int) -> None:
    model, name, _ = port_model(mid)
    apply, params = jax_model(mid)
    ref = jsummary.model_complexity(apply, params, COMPLEXITY_HW)
    assert summary.model_complexity(model, COMPLEXITY_HW) == ref
    assert ref["num_parameters"] * 1e6 == summary.count_params(model)


def check_weight_carry(mid: int) -> None:
    model, _, _ = port_model(mid)
    _, params = jax_model(mid)
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
    """``SRServer`` serves at the gated tier, or refuses it when the tier is
    not ported (``fast``) unless the caller names a ported one."""
    name = registry.get_spec(mid).name
    assert serving.gated_tier(name) == gated
    if gated in config.modes():
        assert serving.SRServer(model_id=mid, device="cpu").tier == gated
    else:
        with pytest.raises(ValueError, match="unported tier 'fast'"):
            serving.SRServer(model_id=mid, device="cpu")
        srv = serving.SRServer(model_id=mid, device="cpu", tier="parity", max_batch=1)
        out = srv.process_one(np.zeros((24, 20, 3), np.uint8))
        assert out.shape == (96, 80, 3) and out.dtype == np.uint8
