"""The zoo's x4 upsamplers on the tail kernel's route, on the CPU.

Every 3x3 conv + PixelShuffle(4) of a zoo model goes through
``models.blocks.conv_shuffle``, which sends it to
``ops.fused.conv_pixelshuffle``: the tail kernel on a CUDA tensor, its
plain version (``tail.conv3x3_pixelshuffle_plain``) here. Each model, at
its gated tier on a seeded LR input, calls the plain version exactly at
its sites, with the widths the weight cache gives, and its output equals,
bit for bit, the same forward with ``conv_shuffle`` on ``ops.conv`` +
``ops.pixel_shuffle``. The sites are ``chip_smoke.ZOO_TAILS``, the table
the card counts the kernel's launches against (phase 8): (cin, conv
channels) read from ``weights/*.npz``, cout 3 but SCET's two heads (cout
4). AALN (11) and MobileSR (20) upsample by 1x1 convs and RLCSR (42) by
the sum of three convs: they stay on stock ops and call it zero times.

The goldens, the JAX comparisons and the complexity counts of these
models (``tests/test_torch_conv_zoo_*.py`` and the others) run through the
routed forwards too.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_zoo_cases as cases
from ntire2022_esr_tpu_torch import config, ops
from ntire2022_esr_tpu_torch.harness import envelope, registry, serving
from ntire2022_esr_tpu_torch.models import blocks
from ntire2022_esr_tpu_torch.ops.kernels import tail

ZOO_TAILS = chip_smoke.ZOO_TAILS
STOCK_SITES = (11, 20, 42)
# the least LR side every ESA's strided 3x3 and 7/3 max-pool take
LR = 16


@pytest.fixture
def plain_tail_calls(monkeypatch):
    """(cin, conv channels, r) of each call of the tail's plain version."""
    calls = []
    plain = tail.conv3x3_pixelshuffle_plain

    def counted(x, w, b, *, r=4, scale=None):
        calls.append((int(x.shape[1]), int(w.shape[0]), r))
        return plain(x, w, b, r=r, scale=scale)

    monkeypatch.setattr(tail, "conv3x3_pixelshuffle_plain", counted)
    return calls


def _stock_shuffle(p, x, r, *, stride=1, padding=1):
    return ops.pixel_shuffle(ops.conv(p, x, stride=stride, padding=padding), r)


def _routed_and_stock(model, tier, dr, monkeypatch):
    """The model's output at ``tier`` on a seeded LR input, routed and with
    ``conv_shuffle`` on stock ops."""
    x = torch.from_numpy(np.random.RandomState(31).rand(1, LR, LR, 3).astype(np.float32) * dr)
    with torch.inference_mode(), config.numerics_mode(tier):
        out = model(x)
        with monkeypatch.context() as mp:
            mp.setattr(blocks, "conv_shuffle", _stock_shuffle)
            ref = model(x)
    return out, ref


@pytest.mark.parametrize("mid", sorted(ZOO_TAILS) + list(STOCK_SITES))
def test_upsamplers_take_the_tail(plain_tail_calls, monkeypatch, mid):
    model, name, dr = cases.port_model(mid)
    tier = serving.gated_tier(name, envelope.TPU_PATH)
    out, ref = _routed_and_stock(model, tier, dr, monkeypatch)
    assert plain_tail_calls == [(cin, nch, 4) for cin, nch in ZOO_TAILS.get(mid, ())]
    assert out.dtype == ref.dtype and torch.equal(out, ref)


def test_f32_input_under_a_storage_tier_stays_stock(plain_tail_calls, monkeypatch):
    """ESAN (34) under fasthi and fasthi16, which store 2 bytes and contract
    in f32: its ``upconv0`` reads the f32 LR image, which the tier's f32
    conv takes unrounded, as JAX's does. The tail takes it so too, on its
    f32 path (the output rounded into the storage dtype), as the stock conv
    does: both upsamplers take the tail, and the forward equals, bit for
    bit, the stock one."""
    model, _, dr = cases.port_model(34)
    for tier in ("fasthi", "fasthi16"):
        plain_tail_calls.clear()
        out, ref = _routed_and_stock(model, tier, dr, monkeypatch)
        assert plain_tail_calls == [(3, 48, 4), (32, 48, 4)]
        assert out.dtype == ref.dtype and torch.equal(out, ref)


def test_w8_upsampler_takes_the_tail(plain_tail_calls, monkeypatch):
    """RFDN (00) on int8 weights: the tail's plain version gets the int8
    weight and its scale, and the forward equals the stock one."""
    prev = config.weights_int8()
    config.set_weights_int8(True)
    try:
        model, name, dr, _ = registry.build_model(0, device="cpu")
    finally:
        config.set_weights_int8(prev)
    assert model.upsampler[0].weight.dtype == torch.int8
    out, ref = _routed_and_stock(model, serving.gated_tier(name, envelope.TPU_PATH), dr,
                                 monkeypatch)
    assert plain_tail_calls == [(50, 48, 4)]
    assert torch.equal(out, ref)
