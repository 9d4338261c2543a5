"""The port's torch-checkpoint path (``porter/reader.py``, ``convert.py``,
``reparam.py``, the registry's convert-on-miss) against the JAX package's
porter and registry on the same ``.pth`` files, and against torch itself."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ntire2022_esr_tpu import porter as jporter
from ntire2022_esr_tpu.harness import registry as jregistry
from ntire2022_esr_tpu_torch import porter
from ntire2022_esr_tpu_torch.harness import registry

GOLDEN_BLOCKS = os.path.join(os.path.dirname(__file__), "goldens", "blocks.npz")


def _save(tmp_path, obj, name="ckpt.pth"):
    path = str(tmp_path / name)
    torch.save(obj, path)
    return path


def _same_flat(a, b):
    """Equal key order, dtypes and values, bit for bit."""
    assert list(a) == list(b)
    for k in a:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        assert va.dtype == vb.dtype and va.shape == vb.shape, k
        np.testing.assert_array_equal(va, vb, err_msg=k)


def test_plain_state_dict(tmp_path):
    sd = {"conv.weight": torch.randn(8, 3, 3, 3), "conv.bias": torch.randn(8)}
    path = _save(tmp_path, sd)
    out = porter.read_torch_checkpoint(path)
    assert list(out) == ["conv.weight", "conv.bias"]
    assert all(isinstance(v, np.ndarray) for v in out.values())
    _same_flat(out, jporter.read_torch_checkpoint(path))


@pytest.mark.parametrize("wrapper", ["params", "net", "model_state_dict", "state_dict"])
def test_wrapped_state_dicts(tmp_path, wrapper):
    """The wrapper key is found under ``unwrap="auto"``, a step counter
    beside it ignored; an explicit key takes that key."""
    sd = {"a.weight": torch.ones(4, 2, 3, 3), "a.bias": torch.zeros(4)}
    path = _save(tmp_path, {wrapper: sd, "epoch": 12})
    out = porter.read_torch_checkpoint(path)
    assert list(out) == ["a.weight", "a.bias"]
    _same_flat(out, jporter.read_torch_checkpoint(path))
    _same_flat(porter.read_torch_checkpoint(path, unwrap=wrapper), out)


def test_module_prefix_stripped_and_non_tensors_skipped(tmp_path):
    sd = {"module.fea.weight": torch.ones(4, 2, 3, 3), "module.fea.bias": torch.ones(4),
          "module.step": 3}
    path = _save(tmp_path, sd)
    out = porter.read_torch_checkpoint(path)
    assert list(out) == ["fea.weight", "fea.bias"]
    _same_flat(out, jporter.read_torch_checkpoint(path))


def test_fold_weight_norm_matches_torch():
    """``g * v / ||v||`` in f64 against torch's own ``weight_norm`` forward
    (f32), and against JAX's fold bit for bit."""
    torch.manual_seed(0)
    conv = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv2d(4, 8, 3))
    with torch.no_grad():
        conv.parametrizations.weight.original0.mul_(1.7)  # g away from ||v||
        ref = conv.weight.detach().numpy()
    sd = {"weight_g": conv.parametrizations.weight.original0.detach().numpy(),
          "weight_v": conv.parametrizations.weight.original1.detach().numpy(),
          "bias": conv.bias.detach().numpy()}
    folded = porter.fold_weight_norm(sd)
    assert list(folded) == ["weight", "bias"]
    np.testing.assert_allclose(folded["weight"], ref, rtol=1e-6, atol=1e-7)
    _same_flat(folded, jporter.convert.fold_weight_norm(sd))
    flat = porter.port_state_dict(sd)
    np.testing.assert_array_equal(flat["weight"], folded["weight"].transpose(2, 3, 1, 0))


def test_buffers_dropped():
    sd = {
        "b.attn_mask": np.zeros((4, 9, 9), np.float32),
        "b.attn.relative_position_index": np.zeros((9, 9), np.int64),
        "bn.num_batches_tracked": np.int64(7),
        "bn.running_mean": np.zeros(4, np.float32),
        "extra.weight": np.ones((3, 3), np.float32),
    }
    assert list(porter.port_state_dict(sd)) == ["bn.running_mean", "extra.weight"]
    assert list(porter.port_state_dict(sd, drop_keys=(r"^extra\.",))) == ["bn.running_mean"]


def _rule_state_dict(rng):
    """A state dict that meets every rule: convs, linears, a conv-transpose,
    a raw 4-D table, a weight-norm pair, BN buffers, Swin buffers."""
    return {
        "c.weight": rng.randn(8, 3, 5, 7).astype(np.float32),
        "c.bias": rng.randn(8).astype(np.float32),
        "fc.weight": rng.randn(6, 4).astype(np.float32),
        "table": rng.randn(6, 4).astype(np.float32),
        "up.weight": rng.randn(4, 2, 2, 2).astype(np.float32),
        "raw.weight": rng.randn(1, 2, 3, 3).astype(np.float32),
        "wn.weight_g": (rng.rand(5, 1, 1, 1) + 0.5).astype(np.float32),
        "wn.weight_v": rng.randn(5, 3, 3, 3).astype(np.float32),
        "bn.running_var": rng.rand(4).astype(np.float32),
        "bn.num_batches_tracked": np.int64(3),
        "blk.attn_mask": np.zeros((2, 4, 4), np.float32),
        "blk.relative_position_index": np.zeros((4, 4), np.int64),
        "drop.me": np.ones(2, np.float32),
    }


RULES = dict(linear_keys=(r"^fc\.",), conv_transpose_keys=(r"^up\.",),
             raw_keys=(r"^raw\.",), drop_keys=(r"^drop\.",))


def test_port_state_dict_equals_jax(tmp_path, rng):
    """The same ``.pth`` read and ported by both packages: the same flat
    arrays bit for bit, and the same npz (``save_params``) read by both."""
    sd = _rule_state_dict(rng)
    path = _save(tmp_path, {"params": {"module." + k: torch.from_numpy(np.asarray(v))
                                       for k, v in sd.items()}})
    ours = porter.port_state_dict(porter.read_torch_checkpoint(path), **RULES)
    theirs = jporter.port_state_dict(jporter.read_torch_checkpoint(path), **RULES)
    _same_flat(ours, theirs)
    assert ours["fc.weight"].shape == (4, 6) and ours["table"].shape == (6, 4)
    assert ours["up.weight"].shape == (2, 2, 4, 2) and ours["raw.weight"].shape == (1, 2, 3, 3)
    npz = str(tmp_path / "w.npz")
    porter.save_params(npz, porter.nest(ours))
    _same_flat(porter.flatten(jporter.load_params(npz)), ours)


def test_reference_state_dict_inverts_the_rules(rng):
    sd = {k: v for k, v in _rule_state_dict(rng).items() if "weight_" not in k}
    flat = porter.port_state_dict(sd, **RULES)
    back = porter.reference_state_dict(
        porter.nest(flat), **{k: v for k, v in RULES.items() if k != "drop_keys"})
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(sd[k]), err_msg=k)
    _same_flat(porter.port_state_dict({k: t.numpy() for k, t in back.items()}, **RULES), flat)


def _linearblock_case(tag):
    with np.load(GOLDEN_BLOCKS) as z:
        prefix = f"linearblock_{tag}/"
        return {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}


@pytest.mark.parametrize("tag,with_idt", [("linear", False), ("idt", True), ("prelu", False)])
def test_fold_linear_block(tag, with_idt):
    """The fold equals the reference's ``rep_params`` (the goldens) and
    JAX's bit for bit, and the folded conv computes the composed convs
    (3x3 then 1x1, + x where ``with_idt``, then the PReLU) in torch."""
    c = _linearblock_case(tag)
    args = (c["p/conv3x3.weight"], c["p/conv3x3.bias"], c["p/conv1x1.weight"],
            c["p/conv1x1.bias"])
    rk, rb = porter.fold_linear_block(*args, with_idt=with_idt)
    np.testing.assert_allclose(rk, c["p/rep/weight"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(rb, c["p/rep/bias"], atol=1e-6, rtol=0)
    jrk, jrb = jporter.fold_linear_block(*args, with_idt=with_idt)
    np.testing.assert_array_equal(rk, jrk)
    np.testing.assert_array_equal(rb, jrb)

    tree = porter.nest({k[2:]: v for k, v in c.items()
                        if k.startswith("p/") and not k.startswith("p/rep/")})
    folded = porter.fold_linear_block_tree(tree, with_idt=with_idt)
    oihw = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(3, 2, 0, 1)))
            for k, v in (("w3", args[0]), ("w1", args[2]), ("rk", folded["weight"]))}
    x = torch.from_numpy(c["x"])
    composed = F.conv2d(F.conv2d(x, oihw["w3"], torch.from_numpy(args[1]), padding=1),
                        oihw["w1"], torch.from_numpy(args[3]))
    if with_idt:
        composed = composed + x
    out = F.conv2d(x, oihw["rk"], torch.from_numpy(folded["bias"]), padding=1)
    if tag == "prelu":
        slope = torch.from_numpy(folded["act"]["weight"])
        out, composed = F.prelu(out, slope), F.prelu(composed, slope)
    torch.testing.assert_close(out, composed, rtol=0, atol=2e-6)
    np.testing.assert_allclose(out.numpy(), c["y"], atol=2e-6, rtol=0)


def test_fold_linear_block_validation():
    w3 = np.zeros((3, 3, 4, 8), np.float32)
    w1 = np.zeros((1, 1, 8, 6), np.float32)
    with pytest.raises(ValueError, match="identity fold"):
        porter.fold_linear_block(w3, None, w1, None, with_idt=True)
    with pytest.raises(ValueError, match="mid-channel"):
        porter.fold_linear_block(w3, None, np.zeros((1, 1, 5, 6), np.float32), None)
    with pytest.raises(ValueError, match="3x3 then 1x1"):
        porter.fold_linear_block(w1, None, w1, None)


# JAX's other per-spec rules, at the values the port's load_params always uses
DEFAULT_RULES = {"unwrap": "auto", "conv_transpose_keys": (), "raw_keys": (), "drop_keys": (),
                 "postprocess": None}


def test_spec_rules_match_jax():
    """Every registered model reads and ports its checkpoint by JAX's rules:
    the same ``linear_keys``, and JAX's other rules at the reader's and
    porter's defaults, which the port applies to every model."""
    assert registry.available_ids() == jregistry.available_ids()
    assert len(registry.all_specs()) == 42
    for spec, jspec in zip(registry.all_specs(), jregistry.all_specs()):
        assert spec.model_id == jspec.model_id
        assert spec.linear_keys == jspec.linear_keys, spec.name
        for field, value in DEFAULT_RULES.items():
            assert getattr(jspec, field) == value, (spec.name, field)


def _write_pth(spec, zoo, wrap: bool):
    """The model's ``.pth`` made from the shipped npz by inverting the
    layout rules, with the buffers the porter drops added (BN counters,
    and for a Swin model each attention's relative-position index and an
    attention mask); ``wrap`` nests it under ``params`` with DataParallel's
    ``module.`` prefix."""
    sd = porter.reference_state_dict(registry.load_params(spec), linear_keys=spec.linear_keys)
    for k in list(sd):
        if k.endswith("running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(5)
        if k.endswith("relative_position_bias_table"):
            base = k[:-len("relative_position_bias_table")]
            sd[base + "relative_position_index"] = torch.zeros((36, 36), dtype=torch.int64)
            sd[base[:-len("attn.")] + "attn_mask"] = torch.zeros((4, 36, 36))
    if wrap:
        sd = {"params": {"module." + k: v for k, v in sd.items()}, "iter": 1000}
    torch.save(sd, os.path.join(zoo, spec.ckpt))
    return sd


@pytest.mark.parametrize("mid", [4, 18, 9])
def test_build_model_from_pth(tmp_path, mid):
    """``build_model`` with an empty cache directory ports the ``.pth``: the
    npz it writes equals the shipped one in every key, dtype and value (and
    the JAX registry's from the same file), the model equals the one built
    from the shipped cache, and a second build reads the new npz."""
    spec = registry.get_spec(mid)
    zoo, cache, jcache = (str(tmp_path / d) for d in ("zoo", "cache", "jcache"))
    os.makedirs(zoo)
    sd = _write_pth(spec, zoo, wrap=mid != 4)
    if mid == 9:
        assert any(k.endswith("attn_mask") for k in sd["params"])
    model, name, dr, tile = registry.build_model(mid, weights_dir=cache, zoo_dir=zoo,
                                                 device="cpu")
    written = registry.weights_path(spec, cache)
    with np.load(written) as got, np.load(registry.weights_path(spec)) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jspec = jregistry.get_spec(mid)
    jregistry.load_params(jspec, weights_dir=jcache, zoo_dir=zoo)
    with np.load(written) as got, np.load(jregistry.weights_path(jspec, jcache)) as theirs:
        assert sorted(got.files) == sorted(theirs.files)
        for k in theirs.files:
            np.testing.assert_array_equal(got[k], theirs[k], err_msg=k)
    shipped = registry.build_model(mid, device="cpu")[0]
    for (k, a), (k2, b) in zip(model.state_dict().items(), shipped.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 36, 30, 3).astype(np.float32) * dr)
    with torch.inference_mode():
        torch.testing.assert_close(model(x), shipped(x), rtol=0, atol=0)
    os.remove(os.path.join(zoo, spec.ckpt))  # the second build reads the cache alone
    registry.build_model(mid, weights_dir=cache, zoo_dir=zoo, device="cpu")


def test_load_params_without_cache_writes_nothing(tmp_path):
    spec = registry.get_spec(4)
    zoo = str(tmp_path / "zoo")
    os.makedirs(zoo)
    _write_pth(spec, zoo, wrap=False)
    tree = registry.load_params(spec, str(tmp_path / "cache"), zoo, cache=False)
    assert not os.path.exists(str(tmp_path / "cache"))
    assert set(porter.flatten(tree)) == set(porter.flatten(registry.load_params(spec)))


def test_missing_checkpoint_names_the_file(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"team04_rlfn\.pth.*NTIRE_TORCH_ZOO"):
        registry.load_params(registry.get_spec(4), str(tmp_path / "cache"), str(tmp_path))
