"""JAX's PSNR cost of each zoo model's gated tier against parity, on the
synthetic frames of ``chip_smoke.py``'s phase 8, written to
``tests/goldens/zoo_tier_gaps.json``:

    JAX_PLATFORMS=cpu python tests/make_zoo_tier_gaps.py [model ids]

The frames are the ``chip_smoke.ZOO_SCREEN_FRAMES`` pairs
``harness.data.write_synthetic_div2k`` writes for LR 339x510 frames from
``chip_smoke.ZOO_SCREEN_SEED`` (read back through the port's PNG codec,
the HR cropped to a multiple of 4), as phase 8 reads them; the first is
phase 8's served frame. For each model the JAX forward runs on the CPU
under parity and under its gated tier
(``results/protocol/zoo_sustained_gated.json``), compiled without XLA's
excess precision, with the tiers' documented arithmetic
(``test_torch_zoo_cases.tier_arithmetic``): ``gaps_db`` per frame, and
``gap_db``, ``psnr_parity`` and ``psnr_tier`` of the first. For the record
``gap_db_jax_ops`` is the first frame's gap on JAX's own ops, where XLA's
CPU backend computes sigmoid and GELU on 2-byte operands at its own
precision; ``xla_cpu_2byte_elementwise`` is the share of values on which
it departs from the value computed in f32 and rounded once.

Phase 8 fails a model whose gated tier on the card misses its parity PSNR
on the first frame by more than 0.01 dB, unless the mean of JAX's gaps
here over the frames is the card's mean within
``chip_smoke.SCREEN_JAX_BAR_DB``: then the loss is the tier's arithmetic,
not the port's. ``tests/test_torch_parity_screen.py`` holds the port's gap
to JAX's on the CPU. With ids, only those models are computed anew and
merged into the file.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import chip_smoke  # noqa: E402
import test_torch_zoo_cases as cases  # noqa: E402
from ntire2022_esr_tpu_torch.harness import data, envelope, registry, serving  # noqa: E402
from ntire2022_esr_tpu_torch.utils import image as img_util  # noqa: E402

OUT = os.path.join(HERE, "goldens", "zoo_tier_gaps.json")


def screen_pairs():
    """[(lr, hr)] uint8 of phase 8's synthetic frames."""
    with tempfile.TemporaryDirectory() as d:
        written = data.write_synthetic_div2k(
            d, [chip_smoke.PROTOCOL_VALID[0]] * chip_smoke.ZOO_SCREEN_FRAMES,
            seed=chip_smoke.ZOO_SCREEN_SEED)
        return [(img_util.imread_uint(lr), img_util.modcrop(img_util.imread_uint(hr), 4))
                for lr, hr in written]


def elementwise_departures() -> dict:
    """Share of 65536 seeded values (normal, sd 4) on which XLA's CPU
    backend's sigmoid and GELU of a 2-byte operand (compiled without excess
    precision) differ from the f32 value rounded once to that dtype."""
    import jax
    import jax.numpy as jnp

    x = np.random.RandomState(0).standard_normal(1 << 16).astype(np.float32) * 4
    fns = {"sigmoid": jax.nn.sigmoid, "gelu": lambda v: jax.nn.gelu(v, approximate=False)}
    out = {}
    for dt in (jnp.bfloat16, jnp.float16):
        v = jnp.asarray(x).astype(dt)
        for name, fn in fns.items():
            got = jax.jit(fn).lower(v).compile(
                compiler_options={"xla_allow_excess_precision": False})(v)
            once = fn(v.astype(jnp.float32)).astype(dt)
            out[f"{name}_{jnp.dtype(dt).name}"] = float(jnp.mean(got != once))
    return out


def main(ids) -> None:
    pairs = screen_pairs()
    rec = {"image": {"lr_shape": list(pairs[0][0].shape), "seed": chip_smoke.ZOO_SCREEN_SEED,
                     "frames": len(pairs), "writer": "harness.data.write_synthetic_div2k"},
           "xla_cpu_2byte_elementwise": elementwise_departures(), "models": {}}
    if ids and os.path.exists(OUT):
        with open(OUT) as f:
            rec["models"] = json.load(f)["models"]
    for mid in ids or chip_smoke.ZOO_IDS:
        t = time.perf_counter()
        name = registry.get_spec(mid).name
        tier = serving.gated_tier(name, envelope.TPU_PATH)
        p = cases.jax_psnrs(mid, pairs, ("parity", tier))
        own = cases.jax_psnrs(mid, pairs[:1], ("parity", tier), documented=False)
        gaps = [a - b for a, b in zip(p[tier], p["parity"])]
        rec["models"][name] = {"id": mid, "tier": tier, "psnr_parity": p["parity"][0],
                               "psnr_tier": p[tier][0], "gap_db": gaps[0], "gaps_db": gaps,
                               "gap_db_jax_ops": own[tier][0] - own["parity"][0]}
        print(f"{name} [{tier}]: parity {p['parity'][0]:.4f} dB, tier {p[tier][0]:.4f} dB, gap "
              f"{gaps[0]:+.4f}, mean over {len(gaps)} frames {np.mean(gaps):+.4f}; on JAX's own "
              f"ops {rec['models'][name]['gap_db_jax_ops']:+.4f} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        with open(OUT, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]])
