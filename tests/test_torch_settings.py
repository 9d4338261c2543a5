"""The ``NTIRE_*`` settings that the port reads, against the JAX package's.

Each setting is read once, when ``config`` (or the registry, for
``NTIRE_WEIGHTS`` and ``NTIRE_TORCH_ZOO``) is imported, so a fresh interpreter with the variables
set imports both packages and prints what they resolved to: every value
must be equal, and an invalid value must raise the same ``ValueError`` in
both. In process: the HR-tail API that takes JAX's older booleans.
"""

import json
import os
import subprocess
import sys

import pytest

from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu_torch import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every variable the port reads; each test sets some of them and unsets the rest
PORTED = ("NTIRE_W8", "NTIRE_FUSE_UPSAMPLE_CONV", "NTIRE_ATTN_BF16", "NTIRE_HR_TAIL",
          "NTIRE_HR_TAIL_BF16", "NTIRE_WEIGHTS", "NTIRE_TORCH_ZOO")
TIERS = ("parity", "high", "mixed", "fast", "fast16", "fasthi", "fasthi16")
ATTN_SITES = ("mha", "mobilesr", "hnct", "imdtn")
TAIL_SITES = ("m_rfdn", "lwfanet", "nasnetbn", "mobilesr", "rfdb")

# each package's resolved settings, printed as one JSON line: {"jax": ..., "torch": ...}
_RESOLVE = """
import importlib, json
out = {}
for name, pkg in (("jax", "ntire2022_esr_tpu"), ("torch", "ntire2022_esr_tpu_torch")):
    c = importlib.import_module(pkg + ".config")
    r = importlib.import_module(pkg + ".harness.registry")
    got = {"weights_int8": c.weights_int8(), "attn_override": c.attn_bf16_override(),
           "hr_tail_override": c.hr_tail_override(), "weights_dir": r.DEFAULT_WEIGHTS_DIR,
           "zoo_dir": r.DEFAULT_ZOO_DIR}
    for tier in %r:
        with c.numerics_mode(tier):
            got[tier] = {"fuse_upsample_conv": c.fuse_upsample_conv(),
                         "attn": {s: c.attn_bf16(s) for s in %r},
                         "hr_tail": {s: c.hr_tail(s) for s in %r},
                         "hr_tail_bf16": {s: c.hr_tail_bf16(s) for s in %r}}
    out[name] = got
print(json.dumps(out))
""" % (TIERS, ATTN_SITES, TAIL_SITES, TAIL_SITES)

# imports that must fail: each package's error, printed as one JSON line
_IMPORT = """
import importlib, json
out = {}
for name, pkg in (("jax", "ntire2022_esr_tpu"), ("torch", "ntire2022_esr_tpu_torch")):
    try:
        importlib.import_module(pkg + ".config")
        out[name] = "imported"
    except ValueError as e:
        out[name] = f"ValueError: {e}"
print(json.dumps(out))
"""


def _run(code: str, env_vars: dict) -> dict:
    """``code`` in a fresh interpreter with ``env_vars`` set and the other
    ported variables unset; its last line of output, parsed."""
    env = {k: v for k, v in os.environ.items() if k not in PORTED}
    env.update(env_vars)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("env", [
    {},
    {"NTIRE_W8": "1", "NTIRE_FUSE_UPSAMPLE_CONV": "0", "NTIRE_ATTN_BF16": "scores_f16",
     "NTIRE_HR_TAIL": "f16", "NTIRE_HR_TAIL_BF16": "0", "NTIRE_WEIGHTS": "/elsewhere/weights",
     "NTIRE_TORCH_ZOO": "/elsewhere/model_zoo"},
    {"NTIRE_W8": "0", "NTIRE_FUSE_UPSAMPLE_CONV": "1", "NTIRE_ATTN_BF16": "probs",
     "NTIRE_HR_TAIL_BF16": "1"},
    {"NTIRE_W8": "true", "NTIRE_FUSE_UPSAMPLE_CONV": "yes", "NTIRE_ATTN_BF16": "",
     "NTIRE_HR_TAIL_BF16": "0"},
], ids=["unset", "forced", "legacy_bf16", "not_one"])
def test_environment_resolves_as_jax(env):
    """Unset: w8 off, the others AUTO. Forced values, the older
    ``NTIRE_HR_TAIL_BF16`` (read only when ``NTIRE_HR_TAIL`` is unset), and
    values that are not "1" (off, as JAX reads them) or empty (AUTO)."""
    got = _run(_RESOLVE, env)
    ours, theirs = got["torch"], got["jax"]
    if "NTIRE_WEIGHTS" not in env:  # each package's own default directory
        assert os.path.basename(ours.pop("weights_dir")) == os.path.basename(
            theirs.pop("weights_dir")) == "weights"
    if "NTIRE_TORCH_ZOO" not in env:
        # the reference's model_zoo: JAX names it by an absolute path, the
        # port inside its own checkout
        assert ours.pop("zoo_dir") == os.path.join(ROOT, "reference", "model_zoo")
        assert theirs.pop("zoo_dir").endswith(os.path.join("reference", "model_zoo"))
    assert ours == theirs
    assert ours["weights_int8"] == (env.get("NTIRE_W8") == "1")


@pytest.mark.parametrize("var,value", [("NTIRE_ATTN_BF16", "bf16"), ("NTIRE_HR_TAIL", "on")])
def test_invalid_environment_raises_as_jax(var, value):
    got = _run(_IMPORT, {var: value})
    ours, theirs = got["torch"], got["jax"]
    assert ours.startswith("ValueError:") and var in ours
    assert ours == theirs


@pytest.fixture
def hr_tail_restored():
    saved = (jconfig.hr_tail_override(), config.hr_tail_override())
    yield
    jconfig.set_hr_tail(saved[0])
    config.set_hr_tail(saved[1])


@pytest.mark.parametrize("value", [True, False, None, "off", "bf16", "f16"])
def test_hr_tail_api_matches_jax(hr_tail_restored, value):
    """``set_hr_tail`` takes JAX's older booleans (True is "bf16", False
    "off"); ``hr_tail_override`` reads the forced value back (None under
    AUTO); ``hr_tail_bf16`` and ``set_hr_tail_bf16`` are the boolean
    forms; every site under every tier resolves as in JAX."""
    for setter in ("set_hr_tail", "set_hr_tail_bf16"):
        if setter == "set_hr_tail_bf16" and isinstance(value, str):
            continue
        getattr(jconfig, setter)(value)
        getattr(config, setter)(value)
        assert config.hr_tail_override() == jconfig.hr_tail_override()
        for tier in TIERS:
            with jconfig.numerics_mode(tier), config.numerics_mode(tier):
                for site in TAIL_SITES:
                    assert config.hr_tail(site) == jconfig.hr_tail(site), (tier, site)
                    assert config.hr_tail_bf16(site) == jconfig.hr_tail_bf16(site), (tier, site)
    with pytest.raises(ValueError):
        config.set_hr_tail("on")


def test_weights_int8_setter_matches_jax():
    prev = (jconfig.weights_int8(), config.weights_int8())
    try:
        for v in (True, False, 1, 0):
            jconfig.set_weights_int8(v)
            config.set_weights_int8(v)
            assert config.weights_int8() is jconfig.weights_int8() is bool(v)
    finally:
        jconfig.set_weights_int8(prev[0])
        config.set_weights_int8(prev[1])
