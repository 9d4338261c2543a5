"""The plain references against the port's models on the CPU, at a small
frame, and the work counted on them."""

import os

import numpy as np
import pytest
import torch

from port_bench import cells, work

WEIGHTS = {"rlfn": "weights/team04_rlfn.npz", "imdn": "weights/imdn_baseline.npz"}


@pytest.mark.parametrize("name,model_id", [("rlfn", 4), ("imdn", -1)])
def test_reference_matches_port(name, model_id):
    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import registry

    cfg = cells.load_json(cells.path_of("configs", name, ".json"))
    ref = cells.load_module("reference", name)
    params = ref.load(os.path.join(cells.ROOT, cfg["weights"]), "cpu")
    dr = float(cfg["data_range"])
    g = torch.Generator().manual_seed(5)
    x = torch.rand((2, 3, 30, 34), generator=g) * dr
    with config.numerics_mode("parity"), torch.no_grad():
        model, _, mdr, _ = registry.build_model(model_id, device="cpu")
        want = model(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        got = ref.forward(params, x)
    assert mdr == dr
    assert got.shape == (2, 3, 120, 136)
    assert float((got - want).abs().max()) <= 2e-5 * dr


@pytest.mark.parametrize("name", ["rlfn", "imdn"])
def test_parameter_count(name):
    cfg = cells.load_json(cells.path_of("configs", name, ".json"))
    with np.load(os.path.join(cells.ROOT, cfg["weights"])) as z:
        assert sum(z[k].size for k in z.files) == cfg["parameters"]


def test_imdn_macs_by_hand():
    per_px = (3 * 64 * 9 + 8 * (64 * 64 * 9 + 2 * 48 * 64 * 9 + 48 * 16 * 9 + 64 * 64)
              + 64 * 64 * 9 + 64 * 48 * 9)
    ref = cells.load_module("reference", "imdn")
    assert work.forward_macs(ref, os.path.join(cells.ROOT, WEIGHTS["imdn"]), 40, 24) == per_px * 40 * 24


def test_rlfn_macs_by_hand():
    h, w = 64, 48
    body = 46 * 48 * 9 + 48 * 48 * 9 + 48 * 46 * 9 + 46 * 46
    hs, ws = (h - 3) // 2 + 1, (w - 3) // 2 + 1          # ESA's strided conv
    hp, wp = (hs - 7) // 3 + 1, (ws - 7) // 3 + 1        # its max-pool
    esa = (46 * 16 + 16 * 16 + 16 * 46) * h * w + 16 * 16 * 9 * (hs * ws + hp * wp)
    want = (3 * 46 * 9 + 46 * 46 * 9 + 46 * 48 * 9) * h * w + 4 * (body * h * w + esa)
    ref = cells.load_module("reference", "rlfn")
    assert work.forward_macs(ref, os.path.join(cells.ROOT, WEIGHTS["rlfn"]), h, w) == want


def test_kernel_work():
    ops, nbytes = work.chain_work([46, 48, 48, 46], 256, 256, 2)
    assert ops == 2 * 256 * 256 * 9 * (46 * 48 + 48 * 48 + 48 * 46)
    assert nbytes == 2 * (256 * 256 * 92 + 9 * (46 * 48 + 48 * 48 + 48 * 46) + 48 + 48 + 46)
    ops, nbytes = work.tail_work(46, 48, 256, 256, 4)
    assert ops == 2 * 256 * 256 * 9 * 46 * 48
    assert nbytes == 4 * (256 * 256 * 94 + 9 * 46 * 48 + 48)
    cfg = cells.load_json(cells.path_of("configs", "rlfn", ".json"))
    per = work.kernel_bound_s(cfg, "chain", "fasthi16", 256, 256)
    assert per == pytest.approx(4 * ops_bound(work.chain_work([46, 48, 48, 46], 256, 256, 2)))
    with pytest.raises(KeyError):
        work.storage_bytes("nonesuch")


def ops_bound(ob):
    return max(ob[0] / work.PEAK_FLOPS, ob[1] / work.PEAK_BYTES)
