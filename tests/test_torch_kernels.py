"""The port's kernel modules on the CPU: each kernel's plain PyTorch
version against the JAX Pallas kernel (interpret mode) and the unfused JAX
graph, the host-side weight packing the CUDA kernels read, the wrappers'
dispatch and checks, and the port's independence from JAX.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each against its plain version there.
"""

import ast
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu_torch import config, ops, porter
from ntire2022_esr_tpu_torch.ops.kernels import build, conv_chain, tail

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    yield


def _t(a):
    return ops.from_nhwc(torch.from_numpy(np.ascontiguousarray(a)))


def _n(t):
    return ops.to_nhwc(t).float().numpy()


def _oihw(w_hwio):
    return porter.to_torch({"c": {"weight": w_hwio}})["c.weight"]


def _chain_case(rng, shape, chans):
    x = rng.randn(*shape).astype(np.float32) * 0.5
    ws = [rng.randn(3, 3, ci, co).astype(np.float32) * 0.05 for ci, co in chans]
    bs = [rng.randn(co).astype(np.float32) * 0.1 for _, co in chans]
    return x, ws, bs


# the shapes of tests/test_pallas_kernels.py (chains, then the mixed-width RLFB chain)
CHAIN_CASES = [
    ((1, 40, 52, 16), [(16, 16)] * 3, True),
    ((2, 33, 47, 8), [(8, 8)], False),
    ((1, 64, 64, 24), [(24, 24)] * 2, True),
    ((1, 40, 40, 20), [(20, 24), (24, 24), (24, 20)], True),
]


@pytest.mark.parametrize("shape,chans,residual", CHAIN_CASES)
def test_chain_plain_matches_pallas(rng, interpret_pallas, shape, chans, residual):
    from ntire2022_esr_tpu.ops.pallas import fused_conv3x3_chain as pallas_chain

    x, ws, bs = _chain_case(rng, shape, chans)
    ref = np.asarray(pallas_chain(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                  [jnp.asarray(b) for b in bs], slope=0.05, residual=residual))
    out = conv_chain.fused_conv3x3_chain(_t(x), [_oihw(w) for w in ws],
                                         [torch.from_numpy(b) for b in bs],
                                         slope=0.05, residual=residual)
    # f32 both; the bar of tests/test_pallas_kernels.py
    np.testing.assert_allclose(_n(out), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tier", ["fasthi16", "fasthi"])
def test_chain_plain_matches_unfused_jax_storage_tiers(rng, tier):
    """Under a storage tier the chain rounds every stage to the storage
    dtype (f16 / bf16), as the unfused JAX graph does (the Pallas kernel
    does not)."""
    x, ws, bs = _chain_case(rng, (2, 24, 20, 46), [(46, 48), (48, 48), (48, 46)])
    act, tdt, ulp = {"fasthi16": (np.float16, torch.float16, 2.0 ** -10),
                     "fasthi": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}[tier]
    x = np.asarray(jnp.asarray(x * 8).astype(act))
    with jconfig.numerics_mode(tier):
        h = jnp.asarray(x)
        for w, b in zip(ws, bs):
            h = jops.leaky_relu(jops.conv2d(h, jnp.asarray(w), jnp.asarray(b)), 0.05)
        ref = np.asarray(h + jnp.asarray(x)).astype(np.float32)
    xt = ops.from_nhwc(torch.from_numpy(x.astype(np.float32)).to(tdt))
    with config.numerics_mode(tier):
        out = conv_chain.fused_conv3x3_chain(xt, [_oihw(w) for w in ws],
                                             [torch.from_numpy(b) for b in bs])
    assert out.dtype == tdt
    d = np.abs(_n(out) - ref)
    # each stage's store may round the other way where the two frameworks'
    # f32 sums differ in the last bits; such a one-ulp flip feeds the next
    # stage, so allow 4 ulps and an eighth of one on average
    assert (d <= 4 * ulp * np.maximum(np.abs(ref), 1.0)).all(), d.max()
    assert d.mean() < ulp / 8 * np.abs(ref).mean() + 1e-4, d.mean()


@pytest.mark.parametrize("shape,cin,cout", [((1, 40, 52, 16), 16, 3), ((2, 33, 47, 12), 12, 3)])
def test_tail_plain_matches_pallas(rng, interpret_pallas, shape, cin, cout):
    from ntire2022_esr_tpu.ops.pallas import fused_conv3x3_pixelshuffle as pallas_tail

    r = 4
    x = rng.randn(*shape).astype(np.float32) * 0.5
    w = rng.randn(3, 3, cin, cout * r * r).astype(np.float32) * 0.05
    b = rng.randn(cout * r * r).astype(np.float32) * 0.1
    ref = np.asarray(pallas_tail(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), r=r))
    out = tail.fused_conv3x3_pixelshuffle(_t(x), _oihw(w), torch.from_numpy(b), r=r)
    assert out.shape == (shape[0], cout, shape[1] * r, shape[2] * r)
    np.testing.assert_allclose(_n(out), ref, rtol=1e-4, atol=1e-5)


def test_tail_plain_matches_unfused_jax_fasthi16(rng):
    x = (rng.randn(1, 9, 7, 46) * 4).astype(np.float16)
    w = rng.randn(3, 3, 46, 48).astype(np.float32) * 0.05
    b = rng.randn(48).astype(np.float32)
    with jconfig.numerics_mode("fasthi16"):
        ref = np.asarray(jops.pixel_shuffle(jops.conv2d(jnp.asarray(x), jnp.asarray(w),
                                                        jnp.asarray(b)), 4))
    with config.numerics_mode("fasthi16"):
        out = tail.fused_conv3x3_pixelshuffle(_t(x), _oihw(w), torch.from_numpy(b))
    assert out.dtype == torch.float16
    # one f16 store: one ulp at most
    np.testing.assert_allclose(_n(out), ref.astype(np.float32), rtol=2.0 ** -9, atol=1e-6)


def test_cpu_wrappers_count_no_launch(rng):
    x, ws, bs = _chain_case(rng, (1, 8, 8, 4), [(4, 4)] * 3)
    before = (conv_chain.launches, tail.launches)
    args = (_t(x), [_oihw(w) for w in ws], [torch.from_numpy(b) for b in bs])
    assert torch.equal(conv_chain.fused_conv3x3_chain(*args), conv_chain.conv3x3_chain_plain(*args))
    w = _oihw(rng.randn(3, 3, 4, 16).astype(np.float32))
    assert torch.equal(tail.fused_conv3x3_pixelshuffle(_t(x), w, None),
                       tail.conv3x3_pixelshuffle_plain(_t(x), w, None))
    assert (conv_chain.launches, tail.launches) == before


def test_wrappers_reject_bad_inputs(rng):
    x, ws, bs = _chain_case(rng, (1, 8, 8, 4), [(4, 6), (6, 5)])
    args = ([_oihw(w) for w in ws], [torch.from_numpy(b) for b in bs])
    with pytest.raises(ValueError, match="residual"):
        conv_chain.fused_conv3x3_chain(_t(x), *args, residual=True)
    with config.numerics_mode("fasthi16"), pytest.raises(TypeError, match="fasthi16"):
        conv_chain.fused_conv3x3_chain(_t(x), *args, residual=False)  # f32 x, f16 tier
    with pytest.raises(ValueError, match="3x3"):
        tail.fused_conv3x3_pixelshuffle(_t(x), torch.zeros(16, 5, 3, 3))
    with pytest.raises(RuntimeError, match="no kernel"):
        tail.fused_conv3x3_pixelshuffle(_t(x).to("meta"), torch.zeros(16, 4, 3, 3, device="meta"))


def test_pack_conv3x3_layout(rng):
    """The CUDA kernels read weights as [ky][kx][cin][cout padded to the
    channel group], zeros in the pad, and the bias padded likewise."""
    w_hwio = rng.randn(3, 3, 5, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    wk, bk = build.pack_conv3x3(_oihw(w_hwio), torch.from_numpy(b), group=4)
    wk = wk.numpy().reshape(3, 3, 5, 8)
    np.testing.assert_array_equal(wk[..., :7], w_hwio)
    assert (wk[..., 7] == 0).all()
    np.testing.assert_array_equal(bk.numpy(), np.concatenate([b, [0.0]]).astype(np.float32))
    _, bk0 = build.pack_conv3x3(_oihw(w_hwio), None, group=12)
    assert bk0.shape == (12,) and (bk0 == 0).all()


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is held by chip_smoke.py")
    from ntire2022_esr_tpu_torch.harness import registry, serving

    with pytest.raises(RuntimeError, match="CUDA"):
        config.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.build_model(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.SRServer(model_id=4, device="cuda")


def _port_files():
    pkg = os.path.join(REPO, "ntire2022_esr_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    files = list(_port_files())
    assert len(files) > 10
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "ntire2022_esr_tpu"), f"{path} imports {name}"
