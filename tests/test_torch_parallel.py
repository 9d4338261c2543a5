"""The port's multi-device paths (``ntire2022_esr_tpu_torch/parallel/``, the
runners' mesh branches, the CLI's ``--mesh/--spatial/--space`` and
``SRServer(mesh=)``) on the CPU, as the JAX package's ``test_parallel.py``
holds the JAX ones, and against the JAX functions on the 8 virtual CPU
devices that ``tests/conftest.py`` sets up. The port's meshes list the
CPU once per entry (``make_mesh(..., devices=[cpu] * n)``), so entries
run one after the other on it: these tests hold the slab, halo, window,
padding and pipeline logic, not copies between devices, which only a
machine with two cards can show. Inputs come from numpy seeds."""

import json
import logging
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import test_torch_zoo_cases as cases
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu.harness import registry as jregistry
from ntire2022_esr_tpu.parallel import data_space_mesh as jdata_space_mesh
from ntire2022_esr_tpu.parallel import make_mesh as jmake_mesh
from ntire2022_esr_tpu.parallel import eval as jeval
from ntire2022_esr_tpu.parallel import spatial as jspatial
from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.harness import cli, data, graphs, registry, runner, stagesplit
from ntire2022_esr_tpu_torch.harness.serving import SRServer
from ntire2022_esr_tpu_torch.parallel import (PipelinedSR, SpatialShardUnavailable,
                                              data_space_mesh, make_mesh, make_spatial_apply,
                                              sharded_batch_apply, sharded_eval_step,
                                              spatial_shard_apply)
from ntire2022_esr_tpu_torch.parallel.eval import psnr_from_mse, sharded_tiled_apply

CPU = torch.device("cpu")
CPU8 = [CPU] * 8
# the toy and the conv net are f32 on both sides and exact per pixel: the
# JAX and port outputs agree to f32 rounding (the sums of the convs run in
# another order), the sharded and whole forwards of one framework exactly
RTOL = 1e-5
# A zoo model sharded against its whole forward, under parity: the CPU
# convolution picks its algorithm by shape, so the port's own whole forward
# of one image moves by up to 7.4e-5 * data_range between batch 1 and batch
# 2 (IMDN_plus at 128x24, measured); the bar is the zoo's JAX-parity bound
# (tests/test_torch_zoo_cases.py check_jax_parity), 1e-4 * data_range
SLAB_ATOL = 1e-4


class Toy(nn.Module):
    """JAX's ``_toy_apply``: nearest x4, times ``w``."""

    def __init__(self, w: float):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(w), requires_grad=False)

    def forward(self, x):
        return x.repeat_interleave(4, 1).repeat_interleave(4, 2) * self.w


def _jtoy(params, x):
    return jnp.repeat(jnp.repeat(x, 4, axis=1), 4, axis=2) * params["w"]


class ConvNet(nn.Module):
    """JAX's conv stack of ``test_spatial_shard_windowed_odd_h_exact``: two
    same-padded 3x3 convs (a bias on the first, so a zero input row is not
    zero padding), LeakyReLU(0.1), PixelShuffle(4); NHWC in and out."""

    def __init__(self, rs):
        super().__init__()
        self.k1 = nn.Parameter(torch.from_numpy(rs.randn(8, 3, 3, 3).astype(np.float32) * 0.2),
                               requires_grad=False)
        self.k2 = nn.Parameter(torch.from_numpy(rs.randn(48, 8, 3, 3).astype(np.float32) * 0.2),
                               requires_grad=False)
        self.b1 = nn.Parameter(torch.from_numpy(rs.randn(8).astype(np.float32)),
                               requires_grad=False)

    def forward(self, x):
        h = F.leaky_relu(F.conv2d(x.permute(0, 3, 1, 2), self.k1, self.b1, padding=1), 0.1)
        return F.pixel_shuffle(F.conv2d(h, self.k2, padding=1), 4).permute(0, 2, 3, 1)


def _rand(rs, shape, scale=1.0):
    return rs.rand(*shape).astype(np.float32) * scale


def _logger(name):
    logger = logging.getLogger(name)
    logger.propagate = False
    logger.addHandler(logging.NullHandler())
    return logger


# -- mesh --------------------------------------------------------------------------

def test_mesh_shapes_match_jax():
    mesh = make_mesh(devices=CPU8)
    assert mesh.devices.shape == (8,) == jmake_mesh().devices.shape
    assert mesh.shape == {"data": 8} and mesh.distinct == [CPU]
    assert data_space_mesh(4, 2, devices=CPU8).shape == jdata_space_mesh(4, 2).shape \
        == {"data": 4, "space": 2}
    with pytest.raises(ValueError, match="devices"):
        data_space_mesh(8, 2, devices=CPU8)
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((4, 2), ("data",), devices=CPU8)


def test_mesh_too_many_devices():
    with pytest.raises(ValueError):
        make_mesh(99, devices=CPU8)
    if not torch.cuda.is_available():
        # the default devices are the CUDA cards: none here
        with pytest.raises(ValueError, match="requested 1 devices, have 0"):
            make_mesh(1)
        # the CLI's meshes on a card take the default devices too
        with pytest.raises(ValueError, match="requested \\(1, 2\\) = 2 devices, have 0"):
            data_space_mesh(1, 2)
    # and on the CPU, the CPU listed once an entry
    assert list(make_mesh(3, devices=[CPU] * 3).devices) == [CPU] * 3


# -- data parallel ------------------------------------------------------------------

def test_sharded_batch_apply_matches_jax(rng):
    x = _rand(rng, (16, 8, 8, 3))
    out = sharded_batch_apply(Toy(2.0), make_mesh(devices=CPU8))(torch.from_numpy(x))
    ref = np.asarray(jeval.sharded_batch_apply(_jtoy, jmake_mesh())({"w": np.float32(2.0)}, x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        sharded_batch_apply(Toy(2.0), make_mesh(devices=CPU8))(torch.zeros(3, 8, 8, 3))


def test_sharded_eval_step_matches_jax(rng):
    """The per-image MSE in the uint8 domain (border 4) against JAX's, on
    an output 1.1 times the HR (so the MSE is not 0)."""
    lr = _rand(rng, (8, 12, 12, 3))
    hr = np.round(np.clip(np.repeat(np.repeat(lr, 4, 1), 4, 2), 0, 1) * 255.0)
    sr, mse = sharded_eval_step(Toy(1.1), make_mesh(devices=CPU8))(
        torch.from_numpy(lr), torch.from_numpy(hr))
    jsr, jmse = jeval.sharded_eval_step(_jtoy, jmake_mesh())({"w": np.float32(1.1)}, lr, hr)
    assert mse.shape == (8,)
    np.testing.assert_allclose(sr.numpy(), np.asarray(jsr), rtol=1e-6)
    np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-5)
    np.testing.assert_allclose(psnr_from_mse(mse).numpy(), np.asarray(jeval.psnr_from_mse(jmse)),
                               rtol=1e-5)
    # an output equal to the HR: only the uint8 rounding is left
    _, mse1 = sharded_eval_step(Toy(1.0), make_mesh(devices=CPU8))(
        torch.from_numpy(lr), torch.from_numpy(hr))
    assert float(mse1.max()) < 0.5 and float(psnr_from_mse(mse1.clamp_min(1e-8)).min()) > 55.0


def test_sharded_tile_grid(rng):
    """70x90 in tiles of 48 (overlap 16): 6 tiles padded with 2 zero tiles
    to the 8 entries, against the port's tiled_apply and JAX's grid."""
    from ntire2022_esr_tpu_torch.harness import tiling

    x = _rand(rng, (1, 70, 90, 3))
    toy = Toy(1.5)
    out = sharded_tiled_apply(toy, make_mesh(devices=CPU8), torch.from_numpy(x), tile=48,
                              tile_overlap=16)
    ref = tiling.tiled_apply(toy, torch.from_numpy(x), tile=48, tile_overlap=16)
    jref = jeval.sharded_tiled_apply(_jtoy, jmake_mesh(), {"w": np.float32(1.5)}, x, tile=48,
                                     tile_overlap=16)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), rtol=RTOL, atol=RTOL)


# -- spatial ------------------------------------------------------------------------

def test_spatial_shard_exact_for_pointwise_model(rng):
    """Halo scheme (64 rows over 8 entries) on the toy: exact, and equal to
    JAX's ``spatial_shard_apply``."""
    x = _rand(rng, (2, 64, 40, 3))
    fn = make_spatial_apply(Toy(2.0), make_mesh(devices=CPU8), overlap=4)
    assert fn.plan(x.shape) == "halo"
    out = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, Toy(2.0)(torch.from_numpy(x)).numpy())
    ref = jspatial.spatial_shard_apply(_jtoy, jmake_mesh(), {"w": np.float32(2.0)}, x, overlap=4)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6)


def test_spatial_shard_windowed_odd_h_exact(rng):
    """Heights no 8-way split divides take the windowed scheme; a biased
    conv stack (receptive field 2 <= overlap 4) equals its whole forward
    within f32 rounding, and JAX's windowed forward of the same net."""
    net = ConvNet(rng)
    p = {"k1": net.k1.numpy().transpose(2, 3, 1, 0), "k2": net.k2.numpy().transpose(2, 3, 1, 0),
         "b1": net.b1.numpy()}

    def jnet(params, a):
        h = jops.leaky_relu(jops.conv2d(a, params["k1"]) + params["b1"], 0.1)
        return jops.pixel_shuffle(jops.conv2d(h, params["k2"]), 4)

    fn = make_spatial_apply(net, make_mesh(devices=CPU8), overlap=4)
    jfn = jspatial.make_spatial_apply(jnet, jmake_mesh(), overlap=4)
    for h in (67, 61, 97):
        x = _rand(rng, (1, h, 24, 3))
        assert fn.plan(x.shape) == "windowed"
        with torch.inference_mode():
            out = fn(torch.from_numpy(x)).numpy()
            ref = net(torch.from_numpy(x)).numpy()
        assert out.shape == ref.shape == (1, 4 * h, 96, 3)
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(out, np.asarray(jfn(p, x)), rtol=RTOL, atol=RTOL)


def test_prepare_places_shards_and_replay_runs_them(rng, monkeypatch):
    """The sharded forwards' ``prepare`` places the shards (and with
    graphs captures); ``replay`` only runs them. Under a CPU stand-in for
    ``graphs.GraphedForward``, each entry of a mesh that lists one device
    twice has a graph of its own, captured anew at each new slab shape, in
    the order halo (H 20), windowed (H 21), halo (H 20): every capture
    falls in ``prepare``, and the output equals the toy's whole forward
    exactly (it is pointwise). Eager, ``prepare`` runs no forward."""
    events = []

    class Graph:
        def __init__(self, fn, device):
            self.fn, self.key = fn, None

        def prepare(self, x):
            if (tuple(x.shape), x.dtype) != self.key:
                self.key = (tuple(x.shape), x.dtype)
                events.append("capture")
            self.static = x.clone()

        def replay(self):
            events.append("replay")
            return self.fn(self.static)

    monkeypatch.setattr(graphs, "GraphedForward", Graph)
    toy, mesh2 = Toy(2.0), make_mesh(devices=[CPU] * 2)
    spatial = make_spatial_apply(toy, mesh2, overlap=4, graphed=True)
    for h, scheme in ((20, "halo"), (21, "windowed"), (20, "halo")):
        x = torch.from_numpy(_rand(rng, (1, h, 12, 3)))
        assert spatial.plan(x.shape) == scheme
        events.clear()
        spatial.prepare(x)
        assert events == ["capture"] * 2, (h, events)
        events.clear()
        out = spatial.replay()
        assert events == ["replay"] * 2, (h, events)
        torch.testing.assert_close(out, toy(x), rtol=0, atol=0)
    assert len(spatial.replicas._graphs) == 2

    batch = sharded_batch_apply(toy, mesh2, graphed=True)
    for k in range(2):  # the second batch of the shape reuses both graphs
        x = torch.from_numpy(_rand(rng, (4, 8, 8, 3)))
        events.clear()
        batch.prepare(x)
        assert events == ["capture"] * 2 * (k == 0)
        torch.testing.assert_close(batch.replay(), toy(x), rtol=0, atol=0)

    calls = []
    eager = make_spatial_apply(toy, mesh2, overlap=4,
                               fn=lambda m, v: calls.append(v.shape) or m(v))
    x = torch.from_numpy(_rand(rng, (1, 20, 12, 3)))
    eager.prepare(x)
    assert calls == []
    torch.testing.assert_close(eager.replay(), toy(x), rtol=0, atol=0)
    assert len(calls) == 2


@pytest.mark.parametrize("model_id", [24, 39])
def test_spatial_shard_slab_safe_zoo_models(model_id, rng):
    """Two slab-safe zoo models (MDGN, IMDN_plus) H-sharded at their
    declared halo against the port's unsharded forward, under parity:
    2 entries at JAX's height (halo scheme) and 8 at an odd one for MDGN
    (windowed), within ``SLAB_ATOL``."""
    spec = registry.get_spec(model_id)
    assert spec.slab_safe
    model, _, dr = cases.port_model(model_id)
    h = max(2 * spec.halo + 16, 96)
    cases_ = [(2, h)] + ([(8, 8 * 8 + 5)] if model_id == 24 else [])
    for n, hh in cases_:
        x = torch.from_numpy(_rand(rng, (1, hh, 24, 3), dr))
        fn = make_spatial_apply(model, make_mesh(devices=[CPU] * n), overlap=spec.halo)
        with torch.inference_mode(), config.numerics_mode("parity"):
            out = fn(x).numpy()
            ref = model(x).numpy()
        assert fn.plan(x.shape) == ("halo" if n == 2 else "windowed")
        np.testing.assert_allclose(out, ref, atol=SLAB_ATOL * dr, rtol=0)


def test_spatial_shard_matches_jax_on_its_mesh(rng):
    """MDGN H-sharded over 2 entries against JAX's ``spatial_shard_apply``
    on 2 virtual devices, under parity: the JAX-parity bound of the zoo
    tests, 1e-4 * data_range (f32 both, sums in another order)."""
    spec = registry.get_spec(24)
    model, _, dr = cases.port_model(24)
    apply, params = cases.jax_model(24)
    x = _rand(rng, (1, 96, 24, 3), dr)
    with torch.inference_mode(), config.numerics_mode("parity"):
        out = spatial_shard_apply(model, make_mesh(devices=[CPU] * 2), torch.from_numpy(x),
                                  overlap=spec.halo).numpy()
    ref = np.asarray(jspatial.spatial_shard_apply(apply, jmake_mesh(2), params, x,
                                                  overlap=spec.halo))
    assert out.shape == ref.shape == (1, 384, 96, 3)
    assert np.abs(out - ref).max() <= 1e-4 * dr


def test_spatial_shard_too_small_h_raises(rng):
    fn = make_spatial_apply(Toy(1.0), make_mesh(devices=CPU8), overlap=32)
    x = torch.from_numpy(_rand(rng, (1, 33, 16, 3)))
    with pytest.raises(SpatialShardUnavailable, match="too small"):
        fn(x)
    assert issubclass(SpatialShardUnavailable, ValueError)


def test_batch_spatial_composed_exact_halo(rng):
    """A 4x2 (data, space) mesh, H divisible: composed == whole == JAX's."""
    x = _rand(rng, (8, 64, 40, 3))
    fn = make_spatial_apply(Toy(2.0), data_space_mesh(4, 2, devices=CPU8), overlap=4,
                            axis="space", batch_axis="data")
    jfn = jspatial.make_spatial_apply(_jtoy, jdata_space_mesh(4, 2), overlap=4, axis="space",
                                      batch_axis="data")
    out = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, Toy(2.0)(torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(out, np.asarray(jfn({"w": np.float32(2.0)}, x)), rtol=1e-6)


def test_batch_spatial_composed_zoo_model_odd_h(rng):
    """A 2x2 mesh over MDGN at an odd H (windowed in each group): composed
    == unsharded forward within ``SLAB_ATOL``."""
    spec = registry.get_spec(24)
    model, _, dr = cases.port_model(24)
    h = 4 * spec.halo + 17
    x = torch.from_numpy(_rand(rng, (2, h, 24, 3), dr))
    fn = make_spatial_apply(model, data_space_mesh(2, 2, devices=[CPU] * 4),
                            overlap=spec.halo, axis="space", batch_axis="data")
    with torch.inference_mode(), config.numerics_mode("parity"):
        out = fn(x).numpy()
        ref = model(x).numpy()
    assert fn.plan(x.shape) == "windowed"
    np.testing.assert_allclose(out, ref, atol=SLAB_ATOL * dr, rtol=0)


def test_batch_spatial_batch_divisibility():
    fn = make_spatial_apply(Toy(1.0), data_space_mesh(4, 2, devices=CPU8), overlap=4,
                            axis="space", batch_axis="data")
    with pytest.raises(ValueError, match="divide"):
        fn(torch.zeros(3, 64, 40, 3))


def test_slab_flags_match_jax():
    """``slab_safe`` and ``halo`` of every registry id are JAX's."""
    ids = sorted(registry._REGISTRY)
    assert ids == sorted(jregistry._REGISTRY)
    for mid in ids:
        spec, jspec = registry.get_spec(mid), jregistry.get_spec(mid)
        assert (spec.slab_safe, spec.halo) == (jspec.slab_safe, jspec.halo), mid
    assert [m for m in ids if registry.get_spec(m).slab_safe] == [-1, 3, 24, 26, 28, 39]


# -- CLI ----------------------------------------------------------------------------

def test_cli_rejects_spatial_for_unsafe_model(tmp_path):
    """--spatial on a model that is not slab-safe, and --spatial alone,
    raise before any image is read."""
    args = types.SimpleNamespace(save_dir=str(tmp_path), ssim=False, x8=False, batched=False,
                                 include_test=False, mesh=2, spatial=True, space=2,
                                 data_dir=str(tmp_path))
    logger = _logger("test_cli_spatial")
    with pytest.raises(ValueError, match="not slab-decomposable"):
        cli.evaluate_model(4, args, logger, CPU)
    args.mesh = 0
    with pytest.raises(ValueError, match="requires --mesh"):
        cli.evaluate_model(4, args, logger, CPU)


def test_cli_composed_batched_spatial(tmp_path, monkeypatch):
    """``--batched --spatial --mesh 4 --space 2 --device cpu`` on two
    synthetic DIV2K pairs (LR 64x16: 32-row slabs over the 2-way space
    axis, MDGN's halo 24): the results.json entry holds each image's PSNR,
    equal (1e-6 dB: the same f32 forward per pixel) to ``run_batched``
    without a mesh. Then the composed path refuses RLFN."""
    root = str(tmp_path / "div2k")
    data.write_synthetic_div2k(root, [(64, 16), (64, 16)], seed=4)
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    prev = config.mode()
    try:
        cli.main(["--data_dir", root, "--save_dir", str(tmp_path / "sr"), "--model_id", "24",
                  "--batched", "--spatial", "--mesh", "4", "--space", "2", "--device", "cpu"])
        model, name, dr = cases.port_model(24)
        ref = runner.run_batched(model, name, dr, _logger("test_cli_composed"),
                                 types.SimpleNamespace(save_dir=str(tmp_path / "ref"), ssim=False),
                                 mode="valid",
                                 pairs=data.select_dataset(root, "valid")[:2])
    finally:
        config.set_mode(prev)
    with open(work / "results.json") as fh:
        entry = json.load(fh)["24_MDGN"]
    assert len(entry["valid_psnr"]) == 2 and all(np.isfinite(entry["valid_psnr"]))
    np.testing.assert_allclose(entry["valid_psnr"], ref["valid_psnr"], rtol=0, atol=1e-6)
    args = types.SimpleNamespace(save_dir=str(tmp_path), ssim=False, x8=False, batched=True,
                                 include_test=False, mesh=4, spatial=True, space=2,
                                 data_dir=root)
    with pytest.raises(ValueError, match="slab-decomposable"):
        cli.evaluate_model(4, args, _logger("test_cli_composed"), CPU)
    args.mesh = 3
    with pytest.raises(ValueError, match="must divide by --space 2"):
        cli.evaluate_model(24, args, _logger("test_cli_composed"), CPU)


# -- runner -------------------------------------------------------------------------

def test_runner_spatial_fallback_is_logged_once_per_shape(tmp_path):
    """``runner.run(spatial_mesh=)`` over 2 entries: the two 20-row images
    are too small for MDGN's halo of 24 and take the one-device forward,
    logged once for their shape; the 64-row image is H-sharded. Every PSNR
    equals the run without a mesh (1e-6 dB)."""
    root = str(tmp_path / "div2k")
    data.write_synthetic_div2k(root, [(20, 16), (20, 16), (64, 16)], seed=6)
    pairs = data.select_dataset(root, "valid")[:3]
    model, name, dr = cases.port_model(24)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("test_runner_spatial")
    logger.propagate = False
    logger.setLevel(logging.INFO)
    logger.addHandler(Keep())
    args = types.SimpleNamespace(save_dir=str(tmp_path / "sr"), ssim=False)
    with config.numerics_mode("parity"):
        got = runner.run(model, name, dr, None, logger, args, mode="valid", pairs=pairs,
                         spatial_mesh=make_mesh(devices=[CPU] * 2), spatial_overlap=24)
        ref = runner.run(model, name, dr, None, _logger("test_runner_ref"), args, mode="valid",
                         pairs=pairs)
    fallbacks = [m for m in records if "spatial sharding unavailable" in m]
    assert len(fallbacks) == 1 and "(1, 20, 16, 3)" in fallbacks[0], fallbacks
    np.testing.assert_allclose(got["valid_psnr"], ref["valid_psnr"], rtol=0, atol=1e-6)
    assert len(got["valid_runtime"]) == 3


def test_run_batched_mesh_pads_and_charges_per_slot(tmp_path, monkeypatch):
    """``run_batched(mesh=)`` over 2 entries with 3 images of one shape:
    the batch is padded to 4, each image is charged a quarter of the
    batch's time (a timer that reads 8 ms), and the PSNRs equal the run
    without a mesh."""
    from ntire2022_esr_tpu_torch.harness import profiling

    monkeypatch.setattr(profiling.MeshTimer, "stop", lambda self: 8.0)
    root = str(tmp_path / "div2k")
    data.write_synthetic_div2k(root, [(24, 20)] * 3, seed=7)
    pairs = data.select_dataset(root, "valid")[:3]
    model, name, dr = cases.port_model(4)
    args = types.SimpleNamespace(save_dir=str(tmp_path / "sr"), ssim=False)
    logger = _logger("test_run_batched_mesh")
    with config.numerics_mode("parity"):
        got = runner.run_batched(model, name, dr, logger, args, mode="valid", pairs=pairs,
                                 mesh=make_mesh(devices=[CPU] * 2), u8_io=True)
        ref = runner.run_batched(model, name, dr, logger, args, mode="valid", pairs=pairs,
                                 u8_io=True)
    np.testing.assert_allclose(got["valid_psnr"], ref["valid_psnr"], rtol=0, atol=1e-6)
    assert got["valid_runtime"] == [2.0] * 3


# -- pipeline -----------------------------------------------------------------------

def test_pipelined_sr_matches_whole_forward(rng):
    """NASNetBN's body | tail over two entries against its whole forward,
    under parity: the same f32 work, 1e-5 * data_range (JAX's bound)."""
    model, _, dr = cases.port_model(28)
    pipe = PipelinedSR(28, devices=[CPU, CPU], model=model)
    x = _rand(rng, (2, 16, 20, 3), dr)
    with torch.inference_mode(), config.numerics_mode("parity"):
        ref = model(torch.from_numpy(x)).numpy()
        out = pipe.process_one(x)
    np.testing.assert_allclose(out, ref, atol=1e-5 * max(dr, 1.0), rtol=0)


def test_pipelined_sr_stream_order_and_devices(rng, monkeypatch):
    """Four batches come out in order, each equal to its own forward; the
    body runs on the first device and the tail on the second (recorded
    from the tensors each stage is given)."""
    model, _, dr = cases.port_model(28)
    seen = []
    sp = stagesplit.get_split(28)
    spy = stagesplit.Split(lambda m, x: seen.append(("body", x.device)) or sp.body(m, x),
                           lambda m, h, x: seen.append(("tail", h.device, x.device))
                           or sp.tail(m, h, x))
    monkeypatch.setitem(stagesplit._SPLITS, 28, spy)
    pipe = PipelinedSR(28, devices=["cpu", "cpu"], depth=2, model=model)
    assert pipe.devices == (CPU, CPU)
    batches = [_rand(rng, (1, 16, 16, 3), dr) for _ in range(4)]
    with config.numerics_mode("parity"):
        outs = list(pipe.process_stream(batches))
        assert len(outs) == 4
        for b, o in zip(batches, outs):
            np.testing.assert_array_equal(o, pipe.process_one(b))
    d0, d1 = pipe.devices
    assert seen[:2] == [("body", d0), ("tail", d1, d1)]
    assert len(seen) == 16


def test_pipelined_sr_validation():
    with pytest.raises(KeyError, match="stage split"):
        PipelinedSR(4, devices=[CPU, CPU])
    with pytest.raises(ValueError, match="2 devices"):
        PipelinedSR(28, devices=[CPU] * 3)


# -- serving ------------------------------------------------------------------------

def test_server_mesh_pads_and_matches_unsharded(rng):
    """SRServer(mesh=) over 2 entries: 3 frames (padded to 4 when
    submitted) come back as 3 frames equal to the unsharded server's (the
    same forward per frame on the CPU: exact)."""
    frames = [rng.randint(0, 256, (24, 20, 3), dtype=np.uint8) for _ in range(3)]
    mesh = make_mesh(devices=[CPU] * 2)
    srv = SRServer(model_id=4, device="cpu", max_batch=4, mesh=mesh)
    ref = SRServer(model_id=4, device="cpu", max_batch=4)
    srv.warmup((24, 20), batch=2)
    got = list(srv.process_stream(frames))
    assert len(got) == 3
    np.testing.assert_array_equal(np.stack(got), np.stack(list(ref.process_stream(frames))))
    np.testing.assert_array_equal(srv.process_one(frames[0]), got[0])


def test_server_mesh_divisibility():
    mesh = make_mesh(devices=[CPU] * 2)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        SRServer(model_id=4, device="cpu", max_batch=3, mesh=mesh)
    srv = SRServer(model_id=4, device="cpu", max_batch=4, mesh=mesh)
    with pytest.raises(ValueError, match="warmup batch 3"):
        srv.warmup((24, 20), batch=3)
