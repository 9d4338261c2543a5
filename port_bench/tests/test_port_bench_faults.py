"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (``run.execute``: set-up, window, comparison) on the CPU, at frames
small enough for a test, with the port's plain versions standing in for
its kernels; the outputs kept are every output of the window. The faults
are planted in the port where its answers are produced: an answer
altered, half of each batch left out (its outputs copied from the other
half), a step that returns its state unchanged (the previous batch's or
replay's output). Half a batch does not exist at the protocol's batch of
one; one chip has no exchange between chips.
"""

import sys
import types

import pytest
import torch

from port_bench import cells, compare, run

SERVE = ("rlfn.serve", "imdn.serve")
PROTOCOL = ("rlfn.protocol", "imdn.protocol")


def _small(name):
    c = cells.cell(name)
    tr = c.traffic
    if tr["driver"] == "serve_stream":
        # 128x128: ~80K values a sub-pixel channel, so that the sampling
        # noise of max_mean_shift stays under its limit
        tr["frames"].update(count=5, height=128, width=128)
        tr.update(batch=2, warm_batches=1, trace_batches=2)
    else:
        tr["frames"].update(count=3, height=24, width=36)
        tr.update(warm_replays=1, trace_replays=3)
    tr["sample"] = 1000  # every output of the window
    return c


def _run(name, trace=False):
    torch.manual_seed(0)
    return run.execute(_small(name), 2 ** 31 + 11, 0.3, trace, torch.device("cpu"),
                       t_start=0.0)


@pytest.mark.parametrize("name", SERVE + PROTOCOL)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and list(res)[-1] == "checks"


@pytest.mark.parametrize("name", SERVE)
def test_serve_answer_altered(name, monkeypatch):
    from ntire2022_esr_tpu_torch.harness import serving

    orig = serving.u8_out

    def altered(y, dr):
        out = orig(y, dr)
        out[:, 0, 0, 0] += 3
        return out

    monkeypatch.setattr(serving, "u8_out", altered)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_serve_half_batch_left_out(name, monkeypatch):
    from ntire2022_esr_tpu_torch.harness import serving

    orig = serving.SRServer._serve

    def half(self, u8):
        n = u8.shape[0]
        out = orig(self, u8[:(n + 1) // 2])
        return torch.cat([out, out])[:n]

    monkeypatch.setattr(serving.SRServer, "_serve", half)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_serve_state_unchanged(name, monkeypatch):
    from ntire2022_esr_tpu_torch.harness import serving

    orig = serving.SRServer._serve
    last = {}

    def stale(self, u8):
        out = last.get("out")
        fresh = orig(self, u8)
        last["out"] = fresh
        return fresh if out is None or out.shape != fresh.shape else out

    monkeypatch.setattr(serving.SRServer, "_serve", stale)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", PROTOCOL)
def test_protocol_answer_altered(name, monkeypatch):
    from ntire2022_esr_tpu_torch.harness import tiling

    orig = tiling.forward

    def altered(model, x, tile=None, **kw):
        y = orig(model, x, tile, **kw).clone()
        y[0, 0, 0, 0] += 1.0
        return y

    monkeypatch.setattr(tiling, "forward", altered)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", PROTOCOL)
def test_protocol_state_unchanged(name, monkeypatch):
    from ntire2022_esr_tpu_torch.harness import tiling

    orig = tiling.forward
    first = {}

    def stale(model, x, tile=None, **kw):
        if "y" not in first:
            first["y"] = orig(model, x, tile, **kw)
        return first["y"]

    monkeypatch.setattr(tiling, "forward", stale)
    assert not _run(name)["correct"]


def test_traced_run_reads_layers():
    res = _run("rlfn.serve", trace=True)
    assert res["correct"]
    assert "mfu.serve" in res["metrics"] and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_refused(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "rlfn.serve", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_tier_other_than_stated_not_correct():
    res = run.execute(_small("rlfn.serve"), 2 ** 31 + 11, 0.3, False, torch.device("cpu"),
                      t_start=0.0, tier="fast16")
    assert not res["correct"]
    assert res["checks"]["tier"] == {"value": "fast16", "limit": "fasthi16"}


def test_jax_loaded_after_window_refused(monkeypatch, capsys):
    """A forbidden module that comes in after the window (here while the
    outputs are compared) leaves exit 3 and no result."""
    small = _small("rlfn.serve")
    monkeypatch.setattr(cells, "cell", lambda name: small)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "unused")
    execute, numbers = run.execute, compare.numbers
    monkeypatch.setattr(run, "execute", lambda cell, seed, seconds, trace, device: execute(
        cell, seed, seconds, trace, torch.device("cpu"), t_start=0.0))

    def planted(*args, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return numbers(*args, **kw)

    monkeypatch.setattr(compare, "numbers", planted)
    assert run.main(["--workload", "rlfn.serve", "--seed", "5", "--seconds", "0.3"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
