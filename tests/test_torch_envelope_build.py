"""The port's plan-measuring half on the CPU.

``ntire2022_esr_tpu_torch/tools/make_gated_envelope.py`` is held to the
JAX package's builder (``tools/make_gated_envelope.py``, loaded by path):
its rules on the synthetic ledgers of ``tests/test_gated_envelope.py``, and
the TPU's committed envelope rebuilt from the TPU's committed sweeps. The
card's committed rows must rebuild the card's committed envelope.
``tools/sweep_zoo_sustained.py`` writes one tiny RLFN row, halves its batch
on running out of memory only, and resumes only what was measured the same
way.
"""

import copy
import importlib.util
import json
import os

import pytest
import torch

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.harness import envelope, registry, stagesplit
from ntire2022_esr_tpu_torch.tools import make_gated_envelope as mge
from ntire2022_esr_tpu_torch.tools import sweep_zoo_sustained as sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTO = os.path.join(REPO, "results", "protocol")


def _load_tool(name):
    """A script of the JAX package's ``tools/``, loaded by path (neither
    script imports JAX at module level)."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jmge():
    return _load_tool("make_gated_envelope")


def _proto(name):
    path = os.path.join(PROTO, name)
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)


def test_gated_deltas_match_jax(jmge):
    ledger = _proto("numerics_delta_r4.json")
    assert mge.gated_deltas(ledger) == jmge.gated_deltas(ledger)


def test_tpu_envelope_rebuilt(jmge):
    """The TPU's sweep files through the port's builder give the committed
    TPU envelope, and JAX's builder gives the same."""
    base = _proto("zoo_sustained.json")
    deltas = mge.gated_deltas(_proto("numerics_delta_r4.json"))
    tier_rows = mge.fastest_rows((n, r) for f in jmge.TIER_FILES for n, r in _proto(f).items())
    tiled = {s.name for s in registry.all_specs() if s.tile is not None}
    assert tiled == {"02_NLFFC"}
    env = mge.build_envelope(base, deltas, tier_rows, 0.005, tiled, pin_high={12})
    jenv = jmge.build_envelope(base, deltas, tier_rows, 0.005, tiled, pin_high={12})
    assert env == jenv == _proto("zoo_sustained_gated.json")
    assert list(env) == list(_proto("zoo_sustained_gated.json"))
    assert mge.TITAN_MS == _load_tool("merge_sustained").TITAN_MS


# -- the rules of tests/test_gated_envelope.py, both builders on one ledger ----------

_DELTA = "numerics_delta_r4.json"
_SCET = "30_SCET|attn=auto|tail=auto|fast,fast16"


def _srow(mid, batch, mode, ms):
    return {"model_id": mid, "batch": batch, "mode": mode, "ms_per_image_sustained": ms}


def _ledgers():
    """tests/test_gated_envelope.py's synthetic files, by name."""
    return {
        "zoo_sustained.json": {
            "04_RLFN": _srow(4, 128, "high", 1.62), "30_SCET": _srow(30, 64, "high", 19.8)},
        "zoo_sustained_fast_r3.json": {
            "04_RLFN": _srow(4, 128, "fast", 0.80), "30_SCET": _srow(30, 128, "fast", 2.87)},
        "zoo_sustained_fast16_r4.json": {
            "04_RLFN": _srow(4, 64, "fast16", 5.08), "30_SCET": _srow(30, 64, "fast16", 9.0)},
        _DELTA: {
            "04_RLFN|attn=auto|tail=auto|fast,fast16": {
                "model_id": 4, "images": 8, "attn": "auto", "tail": "auto", "w8": False,
                "parity_psnr": 26.8, "delta_db": {"fast": -0.0222, "fast16": 0.0004},
                "delta_db_worst": {"fast": -0.0310, "fast16": 0.0007}},
            _SCET: {
                "model_id": 30, "images": 8, "attn": "auto", "tail": "auto", "w8": False,
                "parity_psnr": 26.4, "delta_db": {"fast": 0.0009, "fast16": 0.0012},
                "delta_db_worst": {"fast": 0.0021, "fast16": 0.0030}},
            "30_SCET|attn=auto|tail=bf16|high": {
                "model_id": 30, "images": 8, "attn": "auto", "tail": "bf16", "w8": False,
                "parity_psnr": 26.4, "delta_db": {"high": -0.9}, "delta_db_worst": {"high": -1.2}},
            "04_RLFN|attn=auto|tail=auto|w8|fast": {
                "model_id": 4, "images": 8, "attn": "auto", "tail": "auto", "w8": True,
                "parity_psnr": 26.8, "delta_db": {"fast": 0.0}, "delta_db_worst": {"fast": 0.0}},
        },
    }


def _both(jmge, tmp_path, files, args=(), gate=0.005, worst_gate=0.01, min_images=8,
          pin_high=(12,), extra=None):
    """The envelope of ``files`` by JAX's ``main`` (with its flags ``args``)
    and by the port's ``fastest_rows`` + ``build_envelope`` (with the same
    settings, and the ``extra`` rows); equal, returned."""
    proto = tmp_path / "protocol"
    proto.mkdir(exist_ok=True)
    for name, obj in files.items():
        (proto / name).write_text(json.dumps(obj))
    jenv = jmge.main(["--proto_dir", str(proto), *args])
    tiers = [files.get(f, {}) for f in jmge.TIER_FILES] + ([extra] if extra else [])
    tier_rows = mge.fastest_rows((n, r) for t in tiers for n, r in t.items())
    env = mge.build_envelope(files["zoo_sustained.json"], mge.gated_deltas(files[_DELTA]),
                             tier_rows, gate, {"02_NLFFC"}, min_images=min_images,
                             worst_gate=worst_gate, pin_high=set(pin_high))
    assert env == jenv
    return env


def _rule_gate_and_speed(jmge, tmp_path, f):
    env = _both(jmge, tmp_path, f)
    assert (env["04_RLFN"]["tier"], env["04_RLFN"]["ms_per_image_sustained"]) == ("high", 1.62)
    assert env["04_RLFN"]["tier_delta_db"] is None
    s = env["30_SCET"]
    assert (s["tier"], s["ms_per_image_sustained"], s["delta_images"]) == ("fast", 2.87, 8)
    assert (s["tier_delta_db"], s["tier_delta_db_worst"]) == (0.0009, 0.0021)


def _rule_forced_variants(jmge, tmp_path, f):
    d = mge.gated_deltas(f[_DELTA])
    assert d == jmge.gated_deltas(f[_DELTA])
    assert "high" not in d["30_SCET"] and "fast" in d["30_SCET"]
    assert d["04_RLFN"]["fast"][0] == -0.0222


def _scet_fast_6(f, images):
    f[_DELTA]["30_SCET|attn=auto|tail=auto|fast"] = {
        "model_id": 30, "images": images, "attn": "auto", "tail": "auto", "w8": False,
        "parity_psnr": 26.4, "delta_db": {"fast": -0.0060}, "delta_db_worst": {"fast": -0.0080}}


def _rule_best_powered(jmge, tmp_path, f):
    _scet_fast_6(f, 12)
    env = _both(jmge, tmp_path, f)
    assert (env["30_SCET"]["tier"], env["30_SCET"]["ms_per_image_sustained"]) == ("fast16", 9.0)


def _rule_ties_conservative(jmge, tmp_path, f):
    _scet_fast_6(f, 8)
    d = mge.gated_deltas(f[_DELTA])
    assert d == jmge.gated_deltas(f[_DELTA]) and d["30_SCET"]["fast"][0] == -0.0060


def _rule_under_powered(jmge, tmp_path, f):
    f[_DELTA][_SCET]["images"] = 2
    assert _both(jmge, tmp_path, f)["30_SCET"]["tier"] == "high"
    env = _both(jmge, tmp_path, f, ["--min_images", "2"], min_images=2)
    assert env["30_SCET"]["tier"] == "fast"


def _rule_worst_image(jmge, tmp_path, f):
    f[_DELTA][_SCET]["delta_db_worst"] = {"fast": -0.0150, "fast16": 0.0200}
    assert _both(jmge, tmp_path, f)["30_SCET"]["tier"] == "high"


def _rule_legacy_no_worst(jmge, tmp_path, f):
    del f[_DELTA][_SCET]["delta_db_worst"]
    assert _both(jmge, tmp_path, f)["30_SCET"]["tier"] == "high"


def _rule_missing_delta(jmge, tmp_path, f):
    f[_DELTA] = {k: v for k, v in f[_DELTA].items() if "30_SCET" not in k}
    assert _both(jmge, tmp_path, f)["30_SCET"]["tier"] == "high"


def _rule_gate_widening(jmge, tmp_path, f):
    env = _both(jmge, tmp_path, f, ["--gate", "0.05", "--worst_gate", "0.05"], gate=0.05,
                worst_gate=0.05)
    assert (env["04_RLFN"]["tier"], env["04_RLFN"]["ms_per_image_sustained"]) == ("fast", 0.80)


def _rule_extra_fastest(jmge, tmp_path, f):
    tuned = {"30_SCET": {"model_id": 30, "batch": 128, "mode": "fast",
                         "ms_per_image_sustained": 2.50}}
    (tmp_path / "tuned.json").write_text(json.dumps(tuned))
    env = _both(jmge, tmp_path, f, ["--extra", str(tmp_path / "tuned.json")], extra=tuned)
    assert (env["30_SCET"]["tier"], env["30_SCET"]["ms_per_image_sustained"]) == ("fast", 2.50)


def _rule_fasthi_candidates(jmge, tmp_path, f):
    f["zoo_sustained_fasthi_r5.json"] = {"04_RLFN": {
        "model_id": 4, "batch": 128, "mode": "fasthi", "method": "chain",
        "ms_per_image_sustained": 0.98}}
    f[_DELTA]["04_RLFN|attn=auto|tail=auto|fasthi"] = {
        "model_id": 4, "images": 8, "attn": "auto", "tail": "auto", "w8": False,
        "parity_psnr": 26.8, "delta_db": {"fasthi": -0.0093},
        "delta_db_worst": {"fasthi": -0.0109}}
    assert _both(jmge, tmp_path, f)["04_RLFN"]["tier"] == "high"
    f["zoo_sustained_fasthi16_r5.json"] = {"04_RLFN": {
        "model_id": 4, "batch": 128, "mode": "fasthi16", "method": "chain",
        "ms_per_image_sustained": 1.10}}
    f[_DELTA]["04_RLFN|attn=auto|tail=auto|fasthi16"] = {
        "model_id": 4, "images": 8, "attn": "auto", "tail": "auto", "w8": False,
        "parity_psnr": 26.8, "delta_db": {"fasthi16": -0.0011},
        "delta_db_worst": {"fasthi16": -0.0014}}
    r = _both(jmge, tmp_path, f)["04_RLFN"]
    assert (r["tier"], r["ms_per_image_sustained"], r["method"]) == ("fasthi16", 1.10, "chain")


def _rule_write(jmge, tmp_path, f):
    env = _both(jmge, tmp_path, f, ["--write"])
    written = json.loads((tmp_path / "protocol" / "zoo_sustained_gated.json").read_text())
    assert written == env and set(env) == {"04_RLFN", "30_SCET"}
    assert env["30_SCET"]["tier"] == "fast"


def _rule_pin_high(jmge, tmp_path, f):
    env = _both(jmge, tmp_path, f, ["--pin_high", "30"], pin_high=(30,))
    assert env["30_SCET"]["tier"] == env["04_RLFN"]["tier"] == "high"


RULES = {r.__name__[len("_rule_"):]: r for r in (
    _rule_gate_and_speed, _rule_forced_variants, _rule_best_powered, _rule_ties_conservative,
    _rule_under_powered, _rule_worst_image, _rule_legacy_no_worst, _rule_missing_delta,
    _rule_gate_widening, _rule_extra_fastest, _rule_fasthi_candidates, _rule_write,
    _rule_pin_high)}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rules_match_jax(jmge, tmp_path, rule):
    RULES[rule](jmge, tmp_path, copy.deepcopy(_ledgers()))


# -- the card's rows and envelope ----------------------------------------------------

def _card_rows():
    with open(mge.ROWS_PATH) as fh:
        return json.load(fh)


def test_card_rows_rebuild_the_card_envelope():
    """The committed rows, from one NVIDIA card with its power limit on
    every row, rebuild the committed card envelope; every ported model has
    a high row, split rows for the 6 split-capable models, fori rows for
    the tiled model, a row at every tier the ledger admits."""
    rows = _card_rows()
    devices = {r["device"] for r in rows.values()}
    assert len(devices) == 1 and all(d.startswith("NVIDIA") and d.endswith(" W") for d in devices)
    with open(envelope.DEFAULT_PATH) as fh:
        assert mge.build() == json.load(fh)
    deltas = mge.gated_deltas(_proto("numerics_delta_r4.json"))
    for spec in registry.all_specs():
        methods = ("fori",) if spec.tile is not None else (
            ("chain", "split") if spec.model_id in stagesplit.split_ids() else ("chain",))
        for mode in ("high",) + mge.FASTER_TIERS:
            if mode == "high" or mge.admits(deltas.get(spec.name, {}).get(mode)):
                for method in methods:
                    assert sweep.row_key(spec.name, mode, method) in rows, (spec.name, mode,
                                                                             method)


def test_card_plans():
    """Every ported model has a card plan at a tier of the port, ``fori``
    iff it is tiled, ``split`` only where it has a split, each naming the
    card."""
    plans = envelope.load_envelope()
    assert sorted(p.model_id for p in plans.values()) == sorted(registry.available_ids())
    for p in plans.values():
        spec = registry.get_spec(p.model_id)
        assert p.tier in config.modes() and p.device.startswith("NVIDIA"), p
        assert (p.method == "fori") == (spec.tile is not None), p.name
        assert p.method != "split" or p.model_id in stagesplit.split_ids(), p.name
        assert p.tier == "high" or p.tier_delta_db is not None
    assert plans["12_HNCT"].tier == "high"


def _row(name, mode, method, ms, device="NVIDIA X, 1.00 W", **kw):
    mid = int(name.split("_")[0])
    return {f"{name}|{mode}|{method}": dict(model_id=mid, mode=mode, method=method,
                                            ms_per_image_sustained=ms, device=device, **kw)}


def test_card_inputs_rules():
    """The high base is the faster of chain and split; a model without a
    high row, or rows of two devices, raise."""
    rows = {**_row("28_NASNetBN", "high", "chain", 3.0),
            **_row("28_NASNetBN", "high", "split", 2.0, chunk=8),
            **_row("04_RLFN", "high", "chain", 1.0), **_row("04_RLFN", "fast", "chain", 0.5),
            **_row("02_NLFFC", "high", "fori", 90.0)}
    base, tier_rows, dev = mge.card_inputs(rows, ["04_RLFN", "28_NASNetBN", "02_NLFFC"],
                                           {"02_NLFFC"})
    assert base["28_NASNetBN"]["method"] == "split" and dev == "NVIDIA X, 1.00 W"
    assert tier_rows["04_RLFN"]["fast"]["ms_per_image_sustained"] == 0.5
    with pytest.raises(ValueError, match="no high row"):
        mge.card_inputs(rows, ["04_RLFN", "09_IMDTN"], ())
    with pytest.raises(ValueError, match="2 devices"):
        mge.card_inputs({**rows, **_row("09_IMDTN", "high", "chain", 9.0, device="cpu")},
                        ["04_RLFN"], ())


# -- the sweep on the CPU ------------------------------------------------------------

def _sweep(out, **kw):
    args = dict(size=16, reps=1, iters=1, device="cpu")
    args.update(kw)
    return sweep.sweep([4], "high", "chain", str(out), **args)


def test_sweep_writes_a_row(tmp_path):
    """One tiny RLFN row (16², batch 2), with every field."""
    rows = _sweep(tmp_path / "rows.json", batch=2)
    with open(tmp_path / "rows.json") as fh:
        assert json.load(fh) == rows
    row = rows["04_RLFN|high|chain"]
    assert set(row) == {"model_id", "batch", "reps", "iters", "mode", "size", "method",
                        "ms_per_image_sustained", "device"}
    assert (row["model_id"], row["batch"], row["reps"], row["iters"], row["mode"], row["size"],
            row["method"], row["device"]) == (4, 2, 1, 1, "high", 16, "chain", "cpu")
    assert row["ms_per_image_sustained"] > 0


@pytest.fixture
def stub_timer(monkeypatch):
    """``chain_timer`` replaced by a stub that records each batch and runs
    out of memory above batch 2 (or raises what ``calls.raises`` holds)."""
    calls = []

    def stub(model, x, reps, iters):
        calls.append(x.shape[0])
        if getattr(stub, "raises", None) is not None:
            raise stub.raises
        if x.shape[0] > 2:
            raise torch.cuda.OutOfMemoryError("stub: out of memory")
        return 0.004

    monkeypatch.setattr(sweep, "chain_timer", stub)
    stub.calls = calls
    return stub


def test_sweep_halves_on_out_of_memory(tmp_path, stub_timer):
    rows = _sweep(tmp_path / "rows.json")
    assert stub_timer.calls == [128, 64, 32, 16, 8, 4, 2]
    assert rows["04_RLFN|high|chain"]["batch"] == 2
    assert rows["04_RLFN|high|chain"]["ms_per_image_sustained"] == 0.004 * 1e3 / 1 / 2


def test_sweep_propagates_other_errors(tmp_path, stub_timer):
    stub_timer.raises = ValueError("not memory")
    with pytest.raises(ValueError, match="not memory"):
        _sweep(tmp_path / "rows.json")
    assert stub_timer.calls == [128] and not (tmp_path / "rows.json").exists()


def test_sweep_resumes_only_the_same_methodology(tmp_path, stub_timer):
    out = tmp_path / "rows.json"
    _sweep(out, batch=2)
    assert stub_timer.calls == [2]
    _sweep(out, batch=2)
    assert stub_timer.calls == [2]  # the same way: kept
    rows = _sweep(out, batch=2, reps=3)
    assert stub_timer.calls == [2, 2] and rows["04_RLFN|high|chain"]["reps"] == 3
