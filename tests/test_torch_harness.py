"""The port's challenge protocol (tiler, x8 ensemble, complexity report,
runner, CLI) on the CPU against the JAX package's harness, on the same
numpy-seeded synthetic DIV2K-layout images. RLFN runs at its full widths
under parity; its tolerance is ``tests/test_torch_rlfn.py``'s (1e-3 on
outputs in 0..255)."""

import json
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from ntire2022_esr_tpu.harness import cli as jcli
from ntire2022_esr_tpu.harness import ensemble as jensemble
from ntire2022_esr_tpu.harness import registry as jregistry
from ntire2022_esr_tpu.harness import runner as jrunner
from ntire2022_esr_tpu.harness import summary as jsummary
from ntire2022_esr_tpu.harness import tiling as jtiling
from ntire2022_esr_tpu import ops as jops
from ntire2022_esr_tpu.utils import image as jimg
from ntire2022_esr_tpu_torch import config, ops
from ntire2022_esr_tpu_torch.harness import cli, data, ensemble, graphs, profiling, registry, runner
from ntire2022_esr_tpu_torch.harness import summary, tiling
from ntire2022_esr_tpu_torch.utils import image as pimg
from ntire2022_esr_tpu_torch.utils import metrics as pmetrics

RLFN_ATOL = 1e-3  # tests/test_torch_rlfn.py, parity: f32 both, sums in another order


@pytest.fixture(scope="module")
def model():
    return registry.build_model(4, device="cpu")[0]


@pytest.fixture(scope="module")
def jmodel():
    apply, params, *_ = jregistry.build_model(4)
    return apply, params


@pytest.fixture(scope="module")
def div2k(tmp_path_factory):
    """Two valid and one test pair in the DIV2K layout, plus a third valid
    LR of the first shape (for the runner's buckets)."""
    root = str(tmp_path_factory.mktemp("div2k"))
    pairs = data.write_synthetic_div2k(root, [(20, 28), (40, 36), (20, 28)], [(24, 20)], seed=0)
    return root, pairs


def _logger(name):
    log = logging.getLogger(name)
    log.addHandler(logging.NullHandler())
    return log


def _nhwc(rng, shape):
    return rng.rand(*shape).astype(np.float32) * 255.0


def test_synthetic_div2k_layout(div2k):
    root, pairs = div2k
    assert pairs == data.select_dataset(root, "valid")[:3] + data.select_dataset(root, "test")[:1]
    lr, hr = pimg.imread_uint(pairs[1][0]), pimg.imread_uint(pairs[1][1])
    assert lr.shape == (40, 36, 3) and hr.shape == (160, 144, 3)
    block = hr.reshape(40, 4, 36, 4, 3).mean(axis=(1, 3))
    np.testing.assert_array_equal(lr, np.round(block).astype(np.uint8))
    assert hr.std() > 10  # a field, not a constant


# -- tiler -------------------------------------------------------------------

def _toy(x):
    return x.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2) * 0.5


def _jtoy(params, x):
    return jnp.repeat(jnp.repeat(x, 4, axis=1), 4, axis=2) * params["scale"]


def test_tile_starts_match_jax():
    for size, tile, stride in ((100, 48, 32), (48, 48, 16), (339, 128, 96), (40, 24, 16)):
        assert tiling._tile_starts(size, tile, stride) == jtiling._tile_starts(size, tile, stride)


@pytest.mark.parametrize("max_tiles", [1, 4, 1000])
def test_tiled_pointwise_model_exact(rng, max_tiles):
    x = rng.rand(1, 70, 90, 3).astype(np.float32)
    calls = []

    def spy(b):
        calls.append(b.shape[0])
        return _toy(b)

    out = tiling.tiled_apply(spy, torch.from_numpy(x), tile=48, tile_overlap=16,
                             max_tiles_per_call=max_tiles)
    ref = jtiling.tiled_apply(_jtoy, {"scale": np.float32(0.5)}, jnp.asarray(x), tile=48,
                              tile_overlap=16, max_tiles_per_call=max_tiles)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # 2 x 3 tiles, gathered into one batch per chunk
    assert calls == {1: [1] * 6, 4: [4, 2], 1000: [6]}[max_tiles]
    np.testing.assert_allclose(out.numpy(), _toy(torch.from_numpy(x)).numpy(), rtol=1e-6)


def test_tiled_apply_rejects_batch():
    with pytest.raises(ValueError, match="single image"):
        tiling.tiled_apply(_toy, torch.zeros(2, 64, 64, 3), tile=48)
    out = tiling.forward(_toy, torch.zeros(1, 16, 12, 3), tile=None)
    assert out.shape == (1, 64, 48, 3)


@pytest.mark.parametrize("max_tiles", [2, 16])
def test_tiled_rlfn_matches_jax(model, jmodel, max_tiles):
    apply, params = jmodel
    x = _nhwc(np.random.RandomState(1), (1, 40, 36, 3))
    ref = jax.jit(lambda p, v: jtiling.tiled_apply(apply, p, v, 24, 8, max_tiles_per_call=max_tiles))(
        params, x)
    with torch.inference_mode():
        out = tiling.tiled_apply(model, torch.from_numpy(x), 24, 8, max_tiles_per_call=max_tiles)
    assert out.shape == (1, 160, 144, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=RLFN_ATOL)


# -- x8 ensemble ------------------------------------------------------------

def test_x8_rlfn_matches_jax(model, jmodel):
    apply, params = jmodel
    x = _nhwc(np.random.RandomState(2), (1, 20, 28, 3))
    ref = np.asarray(jax.jit(jensemble.self_ensemble_x8(apply))(params, x))
    with torch.inference_mode():
        out = ensemble.self_ensemble_x8(model)(torch.from_numpy(x))
    assert out.shape == (1, 80, 112, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=RLFN_ATOL)


@pytest.mark.parametrize("mode", range(8))
def test_x8_transforms_are_augment_imgs(rng, mode):
    """The ensemble's NHWC transforms and their inverses are
    ``augment_img``'s, from the one table both read."""
    u = rng.randint(0, 256, (1, 5, 7, 3)).astype(np.uint8)
    out = ensemble._fwd(torch.from_numpy(u), mode)
    np.testing.assert_array_equal(out[0].numpy(), pimg.augment_img(u[0], mode))
    back = ensemble._fwd(out, pimg.INVERSE_MODE[mode])
    np.testing.assert_array_equal(back.numpy(), u)


def test_x8_feeds_the_model_contiguous_nhwc(rng):
    seen = []

    class Spy(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.ones(()))

        def forward(self, x):
            seen.append((tuple(x.shape), x.is_contiguous()))
            return _toy(x)

    x = torch.from_numpy(rng.rand(1, 6, 10, 3).astype(np.float32))
    out = ensemble.self_ensemble_x8(Spy())(x)
    assert [s for s, _ in seen] == [(1, 10, 6, 3) if m in (1, 3, 5, 7) else (1, 6, 10, 3)
                                    for m in range(8)]
    assert all(c for _, c in seen)
    np.testing.assert_allclose(out.numpy(), _toy(x).numpy(), rtol=1e-6)


# -- complexity report -------------------------------------------------------

def test_complexity_rlfn_matches_jax(model, jmodel):
    apply, params = jmodel
    ref = jsummary.model_complexity(apply, params, (256, 256))
    out = summary.model_complexity(model, (256, 256))
    assert out == ref
    assert out == {"activations": 80.045184, "num_conv": 39, "flops": 19.857590272,
                   "num_parameters": 0.317218}


def test_complexity_x8_matches_jax(model, jmodel):
    apply, params = jmodel
    ref = jsummary.model_complexity(jensemble.self_ensemble_x8(apply), params, (48, 40))
    assert summary.model_complexity(ensemble.self_ensemble_x8(model), (48, 40)) == ref
    assert ref["num_conv"] == 8 * 39


class _ToyNet(nn.Module):
    """JAX's toy-net case (tests/test_harness.py test_summary_counts_convs)."""

    def __init__(self):
        super().__init__()
        self.a = nn.Conv2d(3, 8, 3)
        self.b = nn.Conv2d(8, 3, 1)
        for p in self.parameters():
            nn.init.zeros_(p)

    def forward(self, x):
        h = ops.conv(self.a, ops.from_nhwc(x))
        return ops.to_nhwc(ops.conv(self.b, h, padding=0))


def test_complexity_toy_net_matches_jax():
    def net(p, x):
        return jops.conv(p["b"], jops.conv(p["a"], x), padding=0)

    p = {"a": {"weight": np.zeros((3, 3, 3, 8), np.float32), "bias": np.zeros(8, np.float32)},
         "b": {"weight": np.zeros((1, 1, 8, 3), np.float32), "bias": np.zeros(3, np.float32)}}
    ref = jsummary.model_complexity(net, p, (32, 32))
    out = summary.model_complexity(_ToyNet(), (32, 32))
    assert out == ref
    assert out["num_conv"] == 2
    assert abs(out["flops"] * 1e9 - (3 * 3 * 3 * 8 + 8 * 3) * 32 * 32) < 1
    assert out["num_parameters"] == pytest.approx((3 * 3 * 3 * 8 + 8 + 8 * 3 + 3) / 1e6)


def test_complexity_counts_matmuls_as_jax_does():
    """mm (F.linear without bias), addmm (with bias) and bmm against the
    JAX count of the same dot_generals."""

    class MatNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.ones(5, 3))
            self.b = nn.Parameter(torch.ones(5))

        def forward(self, x):
            t = x.reshape(-1, 3)
            y = F.linear(t, self.w, self.b) + F.linear(t, self.w)
            y = y.reshape(x.shape[0] * x.shape[1], x.shape[2], 5)
            return torch.matmul(y.transpose(1, 2), y)

    def jnet(p, x):
        t = x.reshape(-1, 3)
        y = t @ p["w"].T + p["b"] + t @ p["w"].T
        y = y.reshape(x.shape[0] * x.shape[1], x.shape[2], 5)
        return jnp.matmul(jnp.swapaxes(y, 1, 2), y)

    ref = jsummary.model_complexity(jnet, {"w": np.ones((5, 3), np.float32),
                                           "b": np.ones(5, np.float32)}, (6, 4))
    out = summary.model_complexity(MatNet(), (6, 4))
    assert out == ref
    assert out["flops"] * 1e9 == pytest.approx(2 * 24 * 5 * 3 + 6 * 5 * 5 * 4)


def test_count_params_conventions(model):
    n = summary.count_params(model)
    assert n == 317218 == sum(p.numel() for p in model.parameters())
    assert summary.count_params(model, "reference", "04_RLFN") == n
    assert summary.count_params(model, "reference", "23_MDAN") == n + 15120
    assert summary.WEIGHT_NORM_G_PARAMS == jsummary.WEIGHT_NORM_G_PARAMS
    with pytest.raises(ValueError, match="convention"):
        summary.count_params(model, "published")
    bn = nn.BatchNorm2d(4)  # running statistics are buffers, not parameters
    assert summary.count_params(bn) == 8


def test_registry_fields_match_jax():
    spec, jspec = registry.get_spec(4), jregistry.get_spec(4)
    for field in ("name", "data_range", "tile", "max_tiles_per_call"):
        assert getattr(spec, field) == getattr(jspec, field), field


def test_profiling_on_cpu():
    x = torch.ones(64, 64)
    assert profiling.fence(x) is None
    med, times = profiling.device_timer(lambda a: a * 2 + 1, x, iters=3)
    assert med > 0 and len(times) == 3
    timer = profiling.Timer(torch.device("cpu"))
    timer.start()
    assert timer.stop() >= 0.0


def test_trace_and_busy_share(tmp_path):
    """profiling.trace writes a Chrome trace with the marked windows, and
    busy_share reads it (no device work on the CPU: a share of 0)."""
    with profiling.trace(str(tmp_path)):
        for _ in range(2):
            with torch.profiler.record_function("window"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    path = str(tmp_path / profiling.TRACE_FILE)
    assert profiling.busy_share(path, "window") == (0.0, 2)
    with pytest.raises(ValueError, match="no window"):
        profiling.busy_share(path, "other")


def test_busy_share_is_the_union_over_the_windows(tmp_path):
    """Overlapping device events count once, and only inside the windows."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "w", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "w", "ts": 200, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 30},   # overlaps: 10..50
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 90, "dur": 20},  # 90..100 inside
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 150, "dur": 20},  # between windows
          {"ph": "X", "cat": "gpu_memset", "name": "s", "ts": 250, "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 300}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    share, n = profiling.busy_share(str(path), "w")
    assert n == 2 and share == pytest.approx((40 + 10 + 10) / 200)


def test_timer_records_on_its_devices_stream(monkeypatch):
    """A CUDA Timer records its events on the current stream of its own
    device, not of whichever device is current."""
    seen = []

    class Event:
        def __init__(self, enable_timing):
            pass

        def record(self, stream=None):
            seen.append(stream)

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 1.5

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: ("stream of", device))
    timer = profiling.Timer(torch.device("cuda", 1))
    timer.start()
    assert timer.stop() == 1.5
    assert seen == [("stream of", torch.device("cuda", 1))] * 2


class _FakeCudaGraphs:
    """Stand-ins for the CUDA calls of ``graphs.GraphedForward`` on the
    CPU: a capture runs its body eagerly once, and a replay counts. The
    graphs made are kept as weak references."""

    def __init__(self, monkeypatch):
        import contextlib
        import weakref

        self.devices, self.graphs = [], []
        fake = self

        class Graph:
            def __init__(self):
                self.replayed = 0
                fake.graphs.append(weakref.ref(self))

            def replay(self):
                self.replayed += 1

        class Stream:
            def wait_stream(self, other):
                pass

        @contextlib.contextmanager
        def device(d):
            fake.devices.append(d)
            yield

        @contextlib.contextmanager
        def noop(*args, **kwargs):
            yield

        for name, value in (("CUDAGraph", Graph), ("Stream", Stream), ("device", device),
                            ("graph", noop), ("stream", noop), ("current_device", lambda: 0),
                            ("current_stream", lambda device=None: Stream())):
            monkeypatch.setattr(torch.cuda, name, value)
        monkeypatch.setattr(graphs, "_capture_streams", {})


def test_graphed_forward_keeps_one_graph(monkeypatch):
    """A new input shape drops the previous graph and its static buffers
    before it captures; the same shape reuses the live graph, copies the
    input into its static buffer and replays it."""
    import gc
    import weakref

    fake = _FakeCudaGraphs(monkeypatch)
    calls = []

    def fn(x):
        calls.append(tuple(x.shape))
        return x * 2

    dev = torch.device("cuda", 0)
    g = graphs.GraphedForward(fn, dev)
    c0, r0 = graphs.captures, graphs.replays
    a, b = torch.ones(1, 4, 5, 3), torch.full((1, 4, 5, 3), 3.0)
    g.prepare(a)
    out = g.replay()
    assert calls == [(1, 4, 5, 3)] * 2  # the warm-up, then the capture
    g.prepare(b)
    assert calls == [(1, 4, 5, 3)] * 2 and graphs.captures - c0 == 1
    torch.testing.assert_close(g._in, b)
    assert g.replay() is out
    first_in = weakref.ref(g._in)
    g.prepare(torch.ones(1, 6, 5, 3))
    gc.collect()
    assert fake.graphs[0]() is None and first_in() is None, "the previous graph is alive"
    g.replay()
    assert (graphs.captures - c0, graphs.replays - r0) == (2, 3)
    assert len(fake.graphs) == 2 and fake.graphs[1]().replayed == 1
    assert set(fake.devices) == {dev}
    assert len(graphs._capture_streams) == 1, "one side stream for every capture"


def test_runners_stay_eager_on_cpu(tmp_path, div2k, monkeypatch):
    """On the CPU neither runner builds a graph."""
    def refuse(*args, **kwargs):
        raise AssertionError("a graph on the CPU")

    monkeypatch.setattr(graphs, "GraphedForward", refuse)
    args = types.SimpleNamespace(save_dir=str(tmp_path / "out"), ssim=False)
    toy = _ToyScale()
    r = runner.run(toy, "toy", 255.0, None, _logger("test_torch_runner_eager"), args,
                   mode="valid", pairs=div2k[1][:2])
    b = runner.run_batched(toy, "toy", 255.0, _logger("test_torch_runner_eager_b"), args,
                           mode="valid", pairs=div2k[1][:2])
    assert len(r["valid_runtime"]) == len(b["valid_runtime"]) == 2


@pytest.mark.parametrize("path", ["run", "batched"])
def test_runner_scores_bf16_outputs(tmp_path, div2k, path):
    """Under ``fasthi`` a model's output is bf16, which numpy lacks: the
    runners score it as f32 (IMDN, model 26, against its eager forward,
    within the challenge's 0.01 dB: a bf16 store may round the other way
    where the CPU's conv sums in another order, measured 6.5e-4 dB)."""
    model, name, dr, _ = registry.build_model(26, device="cpu")
    pairs = div2k[1][:2]
    args = types.SimpleNamespace(save_dir=str(tmp_path / "out"), ssim=False)
    with config.numerics_mode("fasthi"):
        if path == "run":
            res = runner.run(model, name, dr, None, _logger("test_torch_runner_bf16"), args,
                             mode="valid", pairs=pairs)
        else:
            res = runner.run_batched(model, name, dr, _logger("test_torch_runner_bf16b"), args,
                                     mode="valid", pairs=pairs)
        for (lr, hr), p in zip(pairs, res["valid_psnr"]):
            with torch.inference_mode():
                y = model(torch.from_numpy(pimg.uint2nhwc(pimg.imread_uint(lr), dr)))
            assert y.dtype == torch.bfloat16
            sr = pimg.nhwc2uint(y.float().numpy(), dr)
            hr_img = pimg.modcrop(pimg.imread_uint(hr), 4)
            assert p == pytest.approx(pmetrics.calculate_psnr(sr, hr_img, border=4), abs=0.01)


class _ToyScale(nn.Module):
    """x4 nearest upscale, NHWC: a model with one parameter."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(()))

    def forward(self, x):
        return _toy(x) * self.w


# -- runner ------------------------------------------------------------------

@pytest.mark.parametrize("path", ["run", "batched", "batched_u8"])
def test_runner_matches_jax(tmp_path, div2k, model, jmodel, path):
    apply, params = jmodel
    pairs = div2k[1][:3]
    log = _logger("test_torch_runner")
    out, ref = {}, {}
    for side, res in (("port", out), ("jax", ref)):
        args = types.SimpleNamespace(save_dir=str(tmp_path / side), ssim=True)
        if path == "run":
            if side == "port":
                res.update(runner.run(model, "04_RLFN", 255.0, None, log, args, mode="valid",
                                      pairs=pairs))
            else:
                res.update(jrunner.run(apply, params, "04_RLFN", 255.0, None, log, args,
                                       mode="valid", pairs=pairs))
        else:
            u8 = path == "batched_u8"
            if side == "port":
                res.update(runner.run_batched(model, "04_RLFN", 255.0, log, args, mode="valid",
                                              pairs=pairs, u8_io=u8))
            else:
                res.update(jrunner.run_batched(apply, params, "04_RLFN", 255.0, log, args,
                                               mode="valid", pairs=pairs, u8_io=u8))
    assert list(out) == list(ref)
    assert len(out["valid_psnr"]) == 3 and out["valid_memory"] == 0.0
    assert all(t > 0 for t in out["valid_runtime"])
    np.testing.assert_allclose(out["valid_psnr"], ref["valid_psnr"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["valid_ssim"], ref["valid_ssim"], rtol=0, atol=1e-4)
    for _, hr in pairs:
        name = hr.rsplit("/", 1)[1]
        a = pimg.imread_uint(str(tmp_path / "port" / "04_RLFN" / "valid" / name))
        b = jimg.imread_uint(str(tmp_path / "jax" / "04_RLFN" / "valid" / name))
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_runner_relays_a_missing_file(tmp_path, div2k, model):
    """A dead prefetch thread must surface its error, not hang the loop."""
    hr = div2k[1][0][1]
    args = types.SimpleNamespace(save_dir=str(tmp_path / "out"), ssim=False)
    with pytest.raises(FileNotFoundError, match="missing_lr"):
        runner.run(model, "04_RLFN", 255.0, None, _logger("test_torch_runner_err"), args,
                   mode="valid", pairs=[(str(tmp_path / "missing_lr.png"), hr)])


def test_runner_decodes_only_between_forwards(tmp_path, div2k, monkeypatch):
    """The prefetch thread decodes while an image is scored and saved,
    never during a forward: an eager forward dispatches from Python, so a
    decoding thread would hold it up and inflate the time."""
    import time

    state = {"busy": False, "decodes": 0, "overlaps": 0}
    real_read = pimg.imread_uint
    lrs = {lr for lr, _ in div2k[1]}

    def read(path, n_channels=3):
        if path in lrs:
            state["decodes"] += 1
            state["overlaps"] += state["busy"]
        return real_read(path, n_channels)

    class Slow(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.ones(()))

        def forward(self, x):
            state["busy"] = True
            time.sleep(0.05)
            state["busy"] = False
            return _toy(x)

    monkeypatch.setattr(pimg, "imread_uint", read)
    args = types.SimpleNamespace(save_dir=str(tmp_path / "out"), ssim=False)
    res = runner.run(Slow(), "slow", 255.0, None, _logger("test_torch_runner_slow"), args,
                     mode="valid", pairs=div2k[1][:3])
    assert len(res["valid_psnr"]) == 3
    assert state["decodes"] == 3 and state["overlaps"] == 0


# -- CLI ---------------------------------------------------------------------

def _cli_run(main, workdir, argv, monkeypatch):
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    main(argv)
    with open(workdir / "results.json") as fh:
        res = json.load(fh)
    with open(workdir / "results.txt") as fh:
        table = fh.read().splitlines()
    return res, table


def test_cli_matches_jax(tmp_path, monkeypatch, caplog):
    root = str(tmp_path / "div2k")
    data.write_synthetic_div2k(root, [(20, 28), (24, 20)], [(20, 28)], seed=3)
    argv = ["--data_dir", root, "--model_id", "99", "4", "--ssim", "--include_test"]
    with caplog.at_level(logging.INFO, logger="NTIRE2022-EfficientSR"):
        ref, jtable = _cli_run(jcli.main, tmp_path / "jax",
                               argv + ["--save_dir", str(tmp_path / "jax_sr")], monkeypatch)
        caplog.clear()
        out, table = _cli_run(cli.main, tmp_path / "port",
                              argv + ["--save_dir", str(tmp_path / "port_sr"), "--device", "cpu"],
                              monkeypatch)
        # the unknown model is logged and the sweep goes on to model 4
        assert "model 99 failed; continuing sweep" in caplog.text
    assert list(out) == list(ref) == ["04_RLFN"]
    o, r = out["04_RLFN"], ref["04_RLFN"]
    assert sorted(o) == sorted(r)
    for key in ("valid_psnr", "test_psnr"):
        np.testing.assert_allclose(o[key], r[key], rtol=0, atol=1e-3)
    for key in ("activations", "num_conv", "flops", "num_parameters"):
        assert o[key] == r[key], key
    assert table[0] == jtable[0] and len(table) == len(jtable) == 2
    cols, jcols = table[1].split("\t"), jtable[1].split("\t")
    assert len(cols) == len(jcols) == 11
    # name, PSNRs, and the complexity columns; times and memory are the device's own
    for i in (0, 1, 2, 6, 7, 8, 10):
        assert cols[i] == jcols[i], (i, cols[i], jcols[i])


def test_cli_batched_u8_x8_on_cpu(tmp_path, monkeypatch):
    root = str(tmp_path / "div2k")
    data.write_synthetic_div2k(root, [(20, 28), (20, 28)], seed=4)
    out, table = _cli_run(cli.main, tmp_path / "run",
                          ["--data_dir", root, "--model_id", "4", "--batched", "--u8_io", "--x8",
                           "--device", "cpu", "--save_dir", str(tmp_path / "sr")], monkeypatch)
    e = out["04_RLFN_x8"]
    assert len(e["valid_psnr"]) == 2 and e["num_conv"] == 8 * 39
    assert e["flops"] == pytest.approx(8 * 19.857590272)
    assert table[1].startswith("04_RLFN_x8")


@pytest.mark.parametrize("mode", ["fast", "mixed"])
def test_cli_runs_fast_and_mixed(tmp_path, monkeypatch, mode):
    """``--mode fast`` and ``--mode mixed`` score RLFN on the CPU, through the
    kernels' plain versions: fast's bf16 output is scored in f32, and both
    stay within 0.1 dB of parity on these synthetic images (the JAX CLI's
    tiers; mixed is f32 here, as on the card)."""
    root = str(tmp_path / "div2k")
    data.write_synthetic_div2k(root, [(20, 28)], seed=5)
    prev = config.mode()
    try:
        res = {}
        for m in ("parity", mode):
            res[m], _ = _cli_run(cli.main, tmp_path / m,
                                 ["--data_dir", root, "--model_id", "4", "--mode", m,
                                  "--device", "cpu", "--save_dir", str(tmp_path / f"{m}_sr")],
                                 monkeypatch)
    finally:
        config.set_mode(prev)
    got, ref = res[mode]["04_RLFN"]["valid_psnr"], res["parity"]["04_RLFN"]["valid_psnr"]
    assert len(got) == 1 and np.isfinite(got[0])
    assert abs(got[0] - ref[0]) <= (1e-6 if mode == "mixed" else 0.1), (got, ref)


@pytest.mark.parametrize("flags", [
    ({"spatial": True}, "requires --mesh"),
    ({"mesh": 2, "spatial": True}, "not slab-decomposable"),
    ({"mesh": 3, "spatial": True, "batched": True, "space": 2}, "must divide by --space 2")])
def test_cli_refuses_unported_sharding(tmp_path, flags):
    """The sharding flags are ported (tests/test_torch_parallel.py); what
    JAX's CLI refuses, the port's refuses: --spatial without a mesh, RLFN
    (not slab-safe) H-sharded, a composed mesh the space axis does not
    divide. ``main`` logs a model's failure and goes on, so the model's
    evaluation is called here."""
    attrs, match = flags
    args = types.SimpleNamespace(data_dir=str(tmp_path), save_dir=str(tmp_path), ssim=False,
                                 x8=False, batched=False, include_test=False, mesh=0,
                                 spatial=False, space=2)
    vars(args).update(attrs)
    with pytest.raises(ValueError, match=match):
        cli.evaluate_model(4, args, logging.getLogger("test_cli_sharding"), torch.device("cpu"))


def test_cli_refuses_unported_tiers_and_missing_card(tmp_path):
    """Every tier of the JAX CLI's ``--mode`` is ported now: a tier it does
    not offer is refused by the parser, and one that no package has by
    ``config.set_mode``."""
    prev = config.mode()
    try:
        with pytest.raises(SystemExit):
            cli.main(["--data_dir", str(tmp_path), "--mode", "fasthi16", "--device", "cpu"])
        with pytest.raises(ValueError, match="unknown numerics mode"):
            config.set_mode("w8")
    finally:
        config.set_mode(prev)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is held by chip_smoke.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--data_dir", str(tmp_path), "--model_id", "4"])
