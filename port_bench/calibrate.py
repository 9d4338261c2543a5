"""Readings that the limits of ``limits/<workload>.json`` are set from.

    python3 port_bench/calibrate.py --workload rlfn.serve --seeds 101-112 \
        --control-seeds 201-203 --seconds 3 [--out FILE]

For each of ``--seeds``, one whole run of the cell in this process
(``run.execute``: set-up, a window of ``--seconds`` at the cell's own
sizes and load, the comparison with the plain reference), and for each of
``--control-seeds`` each control that the limits file names
(``controls``), at the cell's sizes and with as many outputs as a run
compares: either ``program:<tier>``, the port's own path one step of
precision lower, run as a whole run at that tier, or the reference
computed one step of precision lower (``compare.CONTROLS``), put in the
program's place on that seed's frames. One JSON line a reading, on
standard output and, with ``--out``, appended to that file. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from port_bench import cells, compare, frames, run  # noqa: E402


def seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


PROGRAM = "program:"


def control_reading(cell: cells.Cell, control: str, seed: int, device: torch.device,
                    seconds: float = 3.0) -> dict:
    """The numbers of ``control`` on the frames of ``seed``: as many
    outputs as a run keeps, drawn from the seed."""
    if control.startswith(PROGRAM):
        res = run.execute(cell, seed, seconds, False, device, t_start=time.perf_counter(),
                          tier=control[len(PROGRAM):])
        return {k: v["value"] for k, v in res["checks"].items() if k != "tier"}
    pool = frames.make(cell.traffic["frames"], seed, device).cpu().numpy()
    k = min(int(cell.traffic["sample"]), len(pool))
    keys = sorted(random.Random(seed).sample(range(len(pool)), k))
    return compare.numbers(cell.traffic["compare"], cell.config, pool[keys], None, device,
                           control=control)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.set_num_threads(1)  # as run.main
    cell = cells.cell(args.workload)

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    for s in seeds(args.seeds):
        t0 = time.perf_counter()
        res = run.execute(cell, s, args.seconds, False, device, t_start=t0)
        emit({"workload": args.workload, "kind": "program", "seed": s, "tier": res["tier"],
              "attempted": res["attempted"],
              "numbers": {k: v["value"] for k, v in res["checks"].items()},
              "metrics": {k: v["value"] for k, v in res["metrics"].items()}})
    for control in cell.limits["controls"]:
        for s in seeds(args.control_seeds):
            emit({"workload": args.workload, "kind": "control", "control": control, "seed": s,
                  "numbers": control_reading(cell, control, s, device, args.seconds)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
