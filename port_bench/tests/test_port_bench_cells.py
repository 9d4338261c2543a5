"""Every cell of BENCHMARK.json resolves to its files by name, and the file
keeps to the benchmark's contract as far as a test on the CPU can see."""

import json
import os
import re

import pytest

from port_bench import calibrate, cells, compare

BENCH = cells.load_json(cells.BENCHMARK)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(cells.BENCHMARK) <= 64 * 1024


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(w):
    c = cells.cell(w)
    assert c.chips in (1, 4)
    assert os.path.exists(cells.path_of("reference", c.config["name"], ".py"))
    cells.load_module("reference", c.config["name"])
    drv = cells.load_module("drivers", c.traffic["driver"])
    for fn in ("setup", "window", "release"):
        assert callable(getattr(drv, fn))
    assert isinstance(drv.WINDOW, str)
    from ntire2022_esr_tpu_torch import config as port_config

    assert c.tier in port_config.modes()
    for control in c.limits["controls"]:
        tier = control[len(calibrate.PROGRAM):] if control.startswith(calibrate.PROGRAM) else None
        assert control in compare.CONTROLS and control != "f32" or tier in port_config.modes()
    for n in c.limits["numbers"].values():
        assert n["lower"] < n["limit"] < n["upper"]
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(cells.load_module("metrics", m["name"]).read)


def test_names_and_entries():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
        assert cells.load_json(os.path.join(cells.ROOT, c["file"]))["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


def test_every_configuration_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    names = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert any(cells.applies(m, w) for w in names)


def test_unknown_cell():
    with pytest.raises(KeyError):
        cells.cell("nonesuch.serve")


def test_files_named_from_names():
    for dirpath, _, files in os.walk(cells.HERE):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), cells.ROOT)
            assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
            json.dumps(rel)
