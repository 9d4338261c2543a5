"""The parity screen's CPU side: what a gated tier costs in PSNR against
parity is the tier's own arithmetic, the same in the port as in JAX.

``chip_smoke.py`` phase 8 prints each zoo model's gated-tier PSNR beside
its parity PSNR on one synthetic frame, and fails a model that misses
parity by more than 0.01 dB unless the mean of its gaps over
``chip_smoke.ZOO_SCREEN_FRAMES`` frames is JAX's mean over the same frames
(``tests/goldens/zoo_tier_gaps.json``, written by
``tests/make_zoo_tier_gaps.py``) within 0.002 dB. Here, on a seeded
128x192 synthetic image (the generator's kind of field), one model per
tier runs in the port and in JAX (compiled without excess precision, with
the tiers' documented arithmetic: ``tier_arithmetic``) under parity and
its gated tier, and the two gaps agree within the challenge's 0.01 dB. The
2-byte tiers lose 0.1-2 dB on such smooth images (DIV2K: under 0.01 dB,
the envelope's ``tier_delta_db``), so a rounding the port dropped or added
would show; where the two frameworks' f32 sums differ in their last bits a
2-byte store rounds the other way, and at this size such flips alone moved
the fasthi gap by 0.0026 dB (measured).
"""

import json
import os

import numpy as np
import pytest

import chip_smoke
import test_torch_zoo_cases as cases
from ntire2022_esr_tpu_torch.harness import data, envelope, registry, serving

# one model per tier: EFDN (01, fasthi), EFDN (05, fast), BSRN (18, fast16),
# team06's RFDN (06, high)
SCREEN = {"fasthi": 1, "fast": 5, "fast16": 18, "high": 6}
LR_HW = (128, 192)


def _pair(seed: int = 1):
    h, w = LR_HW
    hr = data.synthetic_hr(np.random.RandomState(seed), 4 * h, 4 * w)
    lr = np.round(hr.reshape(h, 4, w, 4, 3).mean(axis=(1, 3))).astype(np.uint8)
    return lr, hr


@pytest.mark.parametrize("tier", sorted(SCREEN))
def test_port_gap_is_jax_gap(tier):
    mid = SCREEN[tier]
    assert serving.gated_tier(registry.get_spec(mid).name, envelope.TPU_PATH) == tier
    lr, hr = _pair()
    tiers = ("parity", tier)
    p, j = cases.port_psnrs(mid, [(lr, hr)], tiers), cases.jax_psnrs(mid, [(lr, hr)], tiers)
    p, j = {t: v[0] for t, v in p.items()}, {t: v[0] for t, v in j.items()}
    gap, jgap = p[tier] - p["parity"], j[tier] - j["parity"]
    assert abs(p["parity"] - j["parity"]) <= 1e-3, (p, j)
    assert abs(gap - jgap) <= chip_smoke.PSNR_BAR_DB, (gap, jgap)


def test_tier_gaps_file_covers_the_zoo():
    """Phase 8's JAX gaps: one per zoo model and frame, at its gated tier,
    on phase 8's frames, the first being its served image."""
    with open(os.path.join(os.path.dirname(chip_smoke.__file__), chip_smoke.ZOO_TIER_GAPS)) as f:
        rec = json.load(f)
    assert rec["image"]["seed"] == chip_smoke.ZOO_SCREEN_SEED
    assert rec["image"]["frames"] == chip_smoke.ZOO_SCREEN_FRAMES
    assert tuple(rec["image"]["lr_shape"][:2]) == chip_smoke.PROTOCOL_VALID[0]
    for mid in chip_smoke.ZOO_IDS:
        name = registry.get_spec(mid).name
        m = rec["models"][name]
        assert m["id"] == mid and m["tier"] == serving.gated_tier(name, envelope.TPU_PATH)
        assert m["gap_db"] == m["psnr_tier"] - m["psnr_parity"] == m["gaps_db"][0]
        assert len(m["gaps_db"]) == chip_smoke.ZOO_SCREEN_FRAMES
