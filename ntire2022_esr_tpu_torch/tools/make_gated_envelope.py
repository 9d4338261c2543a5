"""Build the card's gated serving envelope: for each model, the fastest
tier measured on the card whose PSNR shift against parity passes the
quality gate (counterpart of the JAX package's
``tools/make_gated_envelope.py``, with its rules).

Inputs:
  - the card's sustained rows (``tools/sweep_zoo_sustained.py``; default
    ``results/h100/zoo_sustained.json``), each one model at one tier and
    one dispatch (``chain``, ``split`` or the tiled ``fori``), with the
    card's name and power limit in ``device``;
  - the JAX package's PSNR-delta ledger
    (``results/protocol/numerics_delta_r4.json``): each tier's shift
    against parity on 8 or more DIV2K-like images. Those are dB shifts, not
    times, and are not measured again on the card (DIV2K is not in the
    repository).

A faster tier enters when its mean shift is within the gate (0.005 dB),
its worst image within 0.01 dB, on 8 images or more; HNCT (12) stays at
``high`` (its weights are a random init, so its deltas support no quality
claim). The ``high`` base of a model is its fastest ``high`` row (``chain``
or ``split``; ``fori`` for the tiled model), so the envelope never serves
a model slower than ``high``. Candidate rows are the fastest row of each
model and tier across the given files. Every ported model must have a
``high`` row, and the rows must name one device.

    python -m ntire2022_esr_tpu_torch.tools.make_gated_envelope [ROWS.json ...] [--write]

prints the envelope as a table (the card's ms an image beside the Titan
Xp's published time) and, with ``--write``, writes
``results/h100/zoo_sustained_gated.json`` (``harness/envelope.py``'s
``DEFAULT_PATH``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ntire2022_esr_tpu_torch.harness import envelope, registry

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROWS_PATH = os.path.join(_REPO, "results", "h100", "zoo_sustained.json")
DELTAS_PATH = os.path.join(_REPO, "results", "protocol", "numerics_delta_r4.json")

GATE_DB = 0.005
WORST_GATE_DB = 0.01
MIN_IMAGES = 8
PIN_HIGH = (12,)
FASTER_TIERS = ("fast16", "fast", "fasthi", "fasthi16")

# published Titan Xp 'Ave Time' per model (BASELINE.md)
TITAN_MS = {
    "-1_IMDN_baseline": 50.86, "00_RFDN_baseline": 41.97, "01_EFDN": 34.81,
    "02_NLFFC": 2231.32, "03_FMEN": 28.07, "04_RLFN": 27.11, "05_EFDN": 29.97,
    "06_V1": 42.35, "08_RFDN": 38.85, "09_IMDTN": 183.43, "10_RePAFDN": 32.09,
    "11_AALN": 75.52, "12_HNCT": 332.28, "13_RFDN_Dilated": 61.04,
    "14_ARFDN": 47.75, "15_AFDN": 35.76, "16_PRRN": 75.70,
    "17_FDEN": 52.02, "18_RFDNFINALB5": 140.47, "19_IMDeception": 63.18,
    "20_MobileSR": 164.80, "22_RFDN40": 34.67, "23_MDAN": 317.66,
    "24_MDGN": 34.92, "25_FasterRFDN": 38.32, "26_IMDN": 48.20,
    "27_LWFANet": 247.90, "28_NASNetBN": 101.69, "29_RFDN_Conv3X3": 23.96,
    "30_SCET": 87.87, "31_SR_model": 39.63, "33_m_RFDN": 207.99,
    "34_ESAN": 41.80, "35_RFDN": 83.41, "36_RFESR": 56.88, "37_BMDN": 31.16,
    "38_RFDN": 64.71, "39_IMDN_plus": 34.10, "40_RFDNPrune": 32.59,
    "42_RLCSR": 56.34, "43_ResDN": 51.42, "44_MSDN": 34.24,
}

Delta = Tuple[float, int, Optional[float]]  # (mean shift dB, images, worst image dB | None)


def gated_deltas(delta_art: dict) -> Dict[str, Dict[str, Delta]]:
    """name -> mode -> (delta, images, worst-per-image delta | None).

    Per (name, mode) the row with the most images wins; ties break toward
    the larger |delta|. Only rows measured with the shipped storage config
    (``attn`` and ``tail`` AUTO, no w8) count: forced variants measure
    other things. ``worst`` is None for rows that predate per-image
    tracking."""
    out: Dict[str, Dict[str, Delta]] = {}
    for key, row in delta_art.items():
        name = key.split("|")[0]
        if row.get("attn") != "auto" or row.get("tail") != "auto":
            continue
        if row.get("w8"):
            continue
        n = row.get("images", 0)
        for mode, d in row.get("delta_db", {}).items():
            worst = row.get("delta_db_worst", {}).get(mode)
            cur = out.setdefault(name, {})
            old = cur.get(mode)
            if (old is None or n > old[1]
                    or (n == old[1] and abs(d) > abs(old[0]))):
                cur[mode] = (d, n, worst)
    return out


def admits(d: Optional[Delta], gate: float = GATE_DB, min_images: int = MIN_IMAGES,
           worst_gate: float = WORST_GATE_DB) -> bool:
    """Whether a ledger entry admits its tier: measured on ``min_images``
    or more images, |mean| within ``gate`` and |worst image| within
    ``worst_gate`` (an entry with no worst image does not)."""
    if d is None:
        return False
    delta, n_imgs, worst = d
    return (n_imgs >= min_images and abs(delta) <= gate
            and worst is not None and abs(worst) <= worst_gate)


def build_envelope(base: dict, deltas: dict, tier_rows: dict, gate: float,
                   tiled_names: Iterable[str] = (), min_images: int = MIN_IMAGES,
                   worst_gate: float = WORST_GATE_DB, pin_high: Iterable[int] = ()) -> dict:
    """Per model: the fastest tier whose measured shift passes the gate.

    ``base[name]`` is the model's ``high`` row, always admissible; a faster
    tier needs a row in ``tier_rows[name][mode]`` and a ledger entry that
    :func:`admits` it. A tiled model (``tiled_names``) admits only ``fori``
    rows, and every plan's ``method`` is the dispatch that serves it:
    ``fori`` for a tiled model, ``split`` for a split row, else ``chain``."""
    env = {}
    for name in sorted(base, key=lambda n: base[n]["model_id"]):
        best = dict(base[name])
        best["tier"] = "high"
        best["tier_delta_db"] = None
        modes = () if base[name]["model_id"] in pin_high else FASTER_TIERS
        for mode in modes:
            row = tier_rows.get(name, {}).get(mode)
            d = deltas.get(name, {}).get(mode)
            if row is None or d is None:
                continue
            if name in tiled_names and row.get("method") != "fori":
                continue
            if not admits(d, gate, min_images, worst_gate):
                continue
            if row["ms_per_image_sustained"] < best["ms_per_image_sustained"]:
                best = dict(row)
                best["tier"] = mode
                best["tier_delta_db"] = d[0]
                best["tier_delta_db_worst"] = d[2]
                best["delta_images"] = d[1]
        if name in tiled_names:
            best["method"] = "fori"
        elif best.get("method") != "split":
            best["method"] = "chain"
        env[name] = best
    return env


def fastest_rows(rows: Iterable[Tuple[str, dict]]) -> Dict[str, Dict[str, dict]]:
    """name -> mode -> the fastest of the ``(name, row)`` pairs."""
    out: Dict[str, Dict[str, dict]] = {}
    for name, row in rows:
        cur = out.setdefault(name, {}).get(row.get("mode"))
        if cur is None or row["ms_per_image_sustained"] < cur["ms_per_image_sustained"]:
            out[name][row.get("mode")] = row
    return out


def card_inputs(rows: Dict[str, dict], names: Sequence[str],
                tiled_names: Iterable[str]) -> Tuple[dict, dict, str]:
    """``(base, tier_rows, device)`` for :func:`build_envelope` from the
    card's rows (``"name|mode|method"`` -> row). ``base[name]`` is the
    fastest ``high`` row of each model in ``names``: ``chain`` or ``split``,
    or ``fori`` for a tiled model. Raises if a model has no such row, or if
    the rows name more than one device."""
    devices = sorted({str(r.get("device")) for r in rows.values()})
    if len(devices) != 1:
        raise ValueError(f"the rows name {len(devices)} devices, not one: {devices}")
    named = [(key.split("|")[0], row) for key, row in rows.items()]
    tiled = set(tiled_names)
    high = fastest_rows((n, r) for n, r in named if r.get("mode") == "high"
                        and (r.get("method") == "fori") == (n in tiled))
    missing = [n for n in names if "high" not in high.get(n, {})]
    if missing:
        raise ValueError(f"no high row for {missing}: the envelope never drops a model")
    base = {n: high[n]["high"] for n in names}
    return base, fastest_rows(named), devices[0]


def table(env: dict) -> str:
    """The envelope as JAX's table: the card's ms an image beside the Titan
    Xp's published time."""
    lines = ["| model | ms/img | tier | batch | method | delta dB | worst img | n | "
             "Titan ms | speedup |", "|---|---|---|---|---|---|---|---|---|---|"]
    sps = []
    for name, r in env.items():
        ms, ti = r["ms_per_image_sustained"], TITAN_MS[name]
        sps.append(ti / ms)
        d, w = r["tier_delta_db"], r.get("tier_delta_db_worst")
        lines.append(f"| {name} | {ms:.3f} | {r['tier']} | {r.get('batch')} | {r['method']} | "
                     f"{'AUTO ledger' if d is None else f'{d:+.4f}'} | "
                     f"{'—' if w is None else f'{w:+.4f}'} | {r.get('delta_images', '—')} | "
                     f"{ti:.1f} | {ti / ms:.1f}x |")
    geo = math.exp(sum(math.log(s) for s in sps) / len(sps))
    flipped = sum(r["tier"] != "high" for r in env.values())
    lines.append(f"\n{flipped} models at a faster tier than high; against the Titan Xp geomean "
                 f"{geo:.1f}x, min {min(sps):.1f}x, max {max(sps):.1f}x (n={len(sps)})")
    return "\n".join(lines)


def load_rows(paths: Sequence[str]) -> Dict[str, dict]:
    rows: Dict[str, dict] = {}
    for path in paths:
        with open(path) as fh:
            rows.update(json.load(fh))
    return rows


def build(paths: Sequence[str] = (ROWS_PATH,)) -> dict:
    """The card's envelope from the row files and the delta ledger, for
    every model of the port's registry, under the module's rules."""
    specs = [registry.get_spec(mid) for mid in registry.available_ids()]
    tiled = {s.name for s in specs if s.tile is not None}
    base, tier_rows, _ = card_inputs(load_rows(paths), [s.name for s in specs], tiled)
    with open(DELTAS_PATH) as fh:
        deltas = gated_deltas(json.load(fh))
    return build_envelope(base, deltas, tier_rows, GATE_DB, tiled, min_images=MIN_IMAGES,
                          worst_gate=WORST_GATE_DB, pin_high=set(PIN_HIGH))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("rows", nargs="*", default=[ROWS_PATH],
                    help="the card's sustained rows (default results/h100/zoo_sustained.json)")
    ap.add_argument("--write", action="store_true",
                    help="write the envelope to results/h100/zoo_sustained_gated.json")
    args = ap.parse_args(argv)
    env = build(args.rows)
    print(f"device: {next(iter(env.values()))['device']}")
    print(table(env))
    if args.write:
        os.makedirs(os.path.dirname(envelope.DEFAULT_PATH), exist_ok=True)
        with open(envelope.DEFAULT_PATH, "w") as fh:
            json.dump(env, fh, indent=1)
            fh.write("\n")
        print(f"wrote {envelope.DEFAULT_PATH}")
    return env


if __name__ == "__main__":
    main()
