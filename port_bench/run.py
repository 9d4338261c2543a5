"""Run one cell of the port's benchmark on this machine's card.

    python3 port_bench/run.py --workload rlfn.serve --seed 7 --seconds 20 --trace 0

Measures ``ntire2022_esr_tpu_torch`` (the PyTorch and CUDA port) and
nothing of the JAX package. The cell's configuration, mix, limits and
metric readers are found by name (``cells.py``); its driver
(``drivers/<name>.py``) sets up the port, then measures a window of
``--seconds``. ``setup_s`` runs from this process's start to the window's
start; ``peak_mem_mb`` is ``torch.cuda.max_memory_allocated()`` over the
window (reset at its start), in MiB as the challenge reports it.

The port runs at the tier that the configuration states for the cell
(``tiers`` in ``configs/<config>.json``); a run in which the port reports
another tier is not correct. After the window the port's state is freed,
and the plain reference (``reference/<config>.py``) is run on the frames
of the outputs kept: ``compare.py`` decides ``correct`` by the limits of
``limits/<workload>.json``, and the numbers compared, each beside its
limit (the tier beside the stated one), are the last lines on standard
error and the last key (``checks``) of the result.

With ``--trace 1`` the window is a bounded one under ``torch.profiler``
(the mix's ``trace_batches`` or ``trace_replays``), and the result holds
the cell's per-layer metrics (``metrics/<name>.py``) instead of its
end-to-end ones, the device's busy and window seconds, and the breakdown.

The last line of standard output is the JSON result. Exit codes: 0 with a
result; 2 no card, or fewer than the cell asks for; 3 JAX or the JAX
package loaded in this process, looked for as the last step before the
result is printed; 1 any other failure. Only an exit 0 prints a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench import cells, compare, trace as trace_mod, work  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ntire2022_esr_tpu")
MIB = 1024 ** 2


@dataclasses.dataclass
class Context:
    cell: cells.Cell
    seed: int
    device: torch.device
    tier: str


def jax_loaded() -> list:
    """The forbidden top-level module names in ``sys.modules``, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _profile(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _read_trace(prof, window: str) -> trace_mod.Trace:
    tmp = tempfile.mkdtemp(prefix="port_bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return trace_mod.Trace(events, window)


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: Optional[float] = None,
            tier: Optional[str] = None) -> dict:
    """Set up, measure and check one run of ``cell``; the result's dict.
    ``tier`` runs the port at another tier than the stated one (a control:
    such a run is not correct)."""
    t_start = T_START if t_start is None else t_start
    cuda = device.type == "cuda"
    driver = cells.load_module("drivers", cell.traffic["driver"])
    phases = {"imports": time.perf_counter() - t_start}
    if cuda:
        from ntire2022_esr_tpu_torch.ops.kernels import build
        build.build()  # both libraries at once, where they are not built yet
    phases["kernels"] = time.perf_counter() - t_start - sum(phases.values())
    state = driver.setup(Context(cell, seed, device, tier or cell.tier))
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    phases["driver"] = setup_s - sum(phases.values())

    rng = random.Random(seed)
    prof = _profile(device) if trace else contextlib.nullcontext()
    with prof:
        win = driver.window(state, seconds, trace, rng)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    driver.release(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    keys = [k for k, _ in win.samples]
    values = compare.numbers(cell.traffic["compare"], cell.config, win.pool[keys],
                             [o for _, o in win.samples], device)
    correct, checks = compare.judge(values, cell.limits)
    checks["tier"] = {"value": win.tier, "limit": cell.tier}
    correct = correct and win.tier == cell.tier

    metrics = {}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(max(setup_peak, window_peak)) if cuda else 0}
    result = {"correct": correct, "attempted": win.units, "failed": 0}
    if not trace:
        e2e = dict(win.e2e, setup_s=setup_s, peak_mem_mb=window_peak / MIB)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        tr = _read_trace(prof, driver.WINDOW)
        h, w = int(cell.traffic["frames"]["height"]), int(cell.traffic["frames"]["width"])
        ref = cells.load_module("reference", cell.config["name"])
        flops = 2.0 * work.forward_macs(ref, os.path.join(cells.ROOT, cell.config["weights"]),
                                        h, w)
        reading = trace_mod.Reading(trace=tr, units=win.units, timed_s=win.timed_s,
                                    config=cell.config, tier=win.tier, frame_hw=(h, w),
                                    flops_per_frame=flops)
        for m in cell.per_layer:
            v = cells.load_module("metrics", m["name"]).read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = reading.busy_s
        dev["window_s"] = reading.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    result["metrics"] = metrics
    result["device"] = dev
    result["tier"] = win.tier
    result["setup_phases_s"] = phases
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's build caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    # one host thread for torch's CPU work: the host that serves the card is
    # shared, and a pool of threads waiting on each other there makes runs
    # spread; the port's host work is copies of a few MB at a time
    torch.set_num_threads(1)

    cell = cells.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"))
    found = jax_loaded()  # after the comparison and the readers, as the last step
    if found:
        print(f"port_bench: JAX modules loaded in the measuring process: {found}",
              file=sys.stderr)
        return 3
    print(f"port_bench: {args.workload} seed {args.seed} tier {result['tier']} "
          f"correct {result['correct']}; set-up by phase (s): {result['setup_phases_s']}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
