"""The port's serving layer on the CPU: ``tiling.ChunkedTiler``,
``profiling.chain_timer``, ``harness/stagesplit.py``, ``SRServer``'s
``stage_split=`` and ``model=``, ``harness/envelope.py`` and the
``harness.serve`` CLI, as the JAX package's ``test_serving.py``,
``test_serve_cli.py``, ``test_stagesplit.py``, ``test_envelope_policy.py``
and ``test_tiled_nlffc.py`` hold the JAX ones, and against the JAX
package's own ``ChunkedTiler``, ``split_apply``, schedule, envelope and plan
table. Inputs and frames are made from numpy seeds."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_zoo_cases as cases
from ntire2022_esr_tpu import config as jconfig
from ntire2022_esr_tpu.harness import envelope as jenvelope
from ntire2022_esr_tpu.harness import serve as jserve
from ntire2022_esr_tpu.harness import stagesplit as jstagesplit
from ntire2022_esr_tpu.harness import tiling as jtiling
from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.harness import envelope, profiling, registry, serve, stagesplit, tiling
from ntire2022_esr_tpu_torch.harness.serving import SRServer
from ntire2022_esr_tpu_torch.utils import image as img_util

# the rows of the JAX package's tests/test_serve_cli.py
ROWS = {
    "04_RLFN": {"model_id": 4, "batch": 4, "reps": 8, "tier": "fast",
                "method": "chain", "ms_per_image_sustained": 0.7,
                "tier_delta_db": -0.015},
    "28_NASNetBN": {"model_id": 28, "batch": 4, "chunk": 2, "reps": 8,
                    "tier": "high", "method": "split", "size": 256,
                    "ms_per_image_sustained": 8.9, "tier_delta_db": None},
    "02_NLFFC": {"model_id": 2, "batch": 1, "tier": "high", "method": "fori",
                 "ms_per_image_sustained": 341.4, "tier_delta_db": None},
}
# NLFFC tiled at 32 (a 128x128 body) with overlap 16: a 40x56 frame has 2 x 3 tiles
TILE, OVERLAP = 32, 16


@pytest.fixture
def artifact(tmp_path):
    p = tmp_path / "zoo_sustained_gated.json"
    p.write_text(json.dumps(ROWS))
    return str(p)


def _frames(rs, shapes):
    return [rs.randint(0, 256, s + (3,), dtype=np.uint8) for s in shapes]


def _level_diff(a, b):
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


def _nlffc_frame(seed, h, w):
    _, _, dr = cases.port_model(2)
    return torch.from_numpy(np.random.RandomState(seed).rand(1, h, w, 3).astype(np.float32) * dr)


# -- tiling -------------------------------------------------------------------------

def test_nlffc_tiled_matches_whole_image_on_small_input():
    """With the tile (256) past the image, tiled_apply is the whole forward."""
    model, _, dr = cases.port_model(2)
    g = np.load(os.path.join(cases.GOLDEN_DIR, "model_02.npz"))
    x = torch.from_numpy((g["input_u8"].astype(np.float32) / (255.0 / dr))[None])
    with torch.inference_mode():
        direct = model(x)
        tiled = tiling.forward(model, x, tile=registry.get_spec(2).tile)
    torch.testing.assert_close(tiled, direct, rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_chunked_tiler_matches_tiled_apply(chunk):
    """NLFFC over 6 tiles: chunks of 1 and 2 divide them, 4 leaves a ragged
    chunk of 2 padded to 4 and masked. The blend is tiled_apply's mean;
    the canvases are f32 here on both sides (measured equal bit for bit;
    the bound is JAX's test's, 1e-6 relative and 1e-5 * dr)."""
    model, _, dr = cases.port_model(2)
    x = _nlffc_frame(0, 40, 56)
    with torch.inference_mode(), config.numerics_mode("parity"):
        ref = tiling.tiled_apply(model, x, TILE, OVERLAP, max_tiles_per_call=chunk)
        out = tiling.ChunkedTiler(model, TILE, OVERLAP, chunk=chunk)(x)
    assert out.shape == ref.shape == (1, 160, 224, 3)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-5 * dr)


def _toy_f16(b):
    """Nearest x4 plus the tile's top-left value, so that tiles that overlap
    differ there, stored in f16 as NLFFC's output is under fast16."""
    up = b.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)
    return (up + b[:, :1, :1, :1]).to(torch.float16)


def _jtoy_f16(params, b):
    return (jnp.repeat(jnp.repeat(b, 4, axis=1), 4, axis=2) + b[:, :1, :1, :1]).astype(jnp.float16)


@pytest.mark.parametrize("hw", [(40, 56), (20, 20)])
@pytest.mark.parametrize("chunk", [2, 4])
def test_chunked_tiler_matches_jax_under_fast16(chunk, hw):
    """Against JAX's ``ChunkedTiler`` under fast16, with a model whose
    output is f16: tile 24, overlap 8, so a 40x56 frame has 2 x 3 tiles (at
    chunk 4 a ragged chunk of 2, padded and masked) and a 20x20 frame takes
    the whole-image path. Both blend into canvases of the input's dtype,
    f32, so the outputs are equal bit for bit (the small frame's is
    ``tiled_apply``'s, f16, in both). ``tiled_apply`` blends in the
    output's dtype, f16: on the tiled frame it is not JAX's (so a tiler
    with its canvases would fail here)."""
    x = np.random.RandomState(9).rand(1, *hw, 3).astype(np.float32)
    with config.numerics_mode("fast16"), jconfig.numerics_mode("fast16"):
        out = tiling.ChunkedTiler(_toy_f16, 24, 8, chunk=chunk)(torch.from_numpy(x))
        ref = np.asarray(jtiling.ChunkedTiler(_jtoy_f16, 24, 8, chunk=chunk)({}, jnp.asarray(x)))
        f16_canvas = tiling.tiled_apply(_toy_f16, torch.from_numpy(x), 24, 8,
                                        max_tiles_per_call=chunk)
    assert str(out.dtype).split(".")[-1] == ref.dtype.name
    np.testing.assert_array_equal(out.float().numpy(), ref.astype(np.float32))
    if hw == (40, 56):
        assert out.dtype == torch.float32 and f16_canvas.dtype == torch.float16
        assert not np.array_equal(f16_canvas.float().numpy(), ref)


def test_chunked_tiler_small_frame_takes_the_whole_image_path():
    model, _, dr = cases.port_model(2)
    x = _nlffc_frame(1, 24, 28)
    with torch.inference_mode():
        out = tiling.ChunkedTiler(model, TILE, OVERLAP, chunk=2)(x)
        ref = tiling.tiled_apply(model, x, TILE, OVERLAP)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-5 * dr)


def test_chunked_tiler_model_sees_only_the_chunk_shape():
    """Across two frame shapes (6 tiles each, the last chunk ragged at 4)
    the model sees nothing but (chunk, tile, tile, 3) batches."""
    model, _, _ = cases.port_model(2)
    seen = []

    def counting(b):
        seen.append(tuple(b.shape))
        return model(b)

    tiler = tiling.ChunkedTiler(counting, TILE, OVERLAP, chunk=4)
    with torch.inference_mode():
        assert tiler(_nlffc_frame(2, 40, 56)).shape == (1, 160, 224, 3)
        assert tiler(_nlffc_frame(3, 56, 40)).shape == (1, 224, 160, 3)
    assert seen == [(4, TILE, TILE, 3)] * 4


def test_chunked_tiler_rejects_batch():
    with pytest.raises(ValueError, match="single image"):
        tiling.ChunkedTiler(lambda b: b, TILE)(torch.zeros(2, 40, 40, 3))


# -- timing -------------------------------------------------------------------------

def test_chain_timer_contract():
    """One warm-up forward, then ``iters`` chains of ``reps`` forwards on
    inputs ``x * (1 + 1e-6 * i)``; each output summed; the median of the
    chains' times in seconds."""
    x = torch.ones(2, 4, 4, 3)
    scales = []

    def model(v):
        scales.append(float(v[0, 0, 0, 0]))
        return v * 2

    s = profiling.chain_timer(model, x, reps=3, iters=2)
    assert s > 0
    assert len(scales) == 1 + 3 * 2
    assert scales == [float(torch.tensor(1.0 + 1e-6 * i)) for i in [0] + [0, 1, 2] * 2]


# -- stage split -------------------------------------------------------------------

@pytest.mark.parametrize("mid", stagesplit.split_ids())
def test_split_matches_whole_forward(mid):
    """The body at batch 4 and the tail in chunks of 2 compute the whole
    forward (measured equal bit for bit on the CPU; the bound is the JAX
    test's, 1e-5 * max(dr, 1))."""
    model, name, dr = cases.port_model(mid)
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 24, 32, 3).astype(np.float32) * dr)
    with torch.inference_mode(), config.numerics_mode("parity"):
        ref = model(x)
        got = stagesplit.split_apply(mid, chunk=2)(model, x)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * max(dr, 1.0), msg=name)


@pytest.mark.parametrize("mid", stagesplit.split_ids())
def test_split_apply_matches_jax(mid):
    """The port's ``split_apply`` against JAX's on the same seeded batch of
    4 (16x16, chunks of 2) under parity: f32 on both sides, sums in
    another order. The bound is ``check_jax_parity``'s for the whole
    models, 1e-4 * dr."""
    model, name, dr = cases.port_model(mid)
    apply, params = cases.jax_model(mid)
    x = np.random.RandomState(mid).rand(4, 16, 16, 3).astype(np.float32) * dr
    with torch.inference_mode(), config.numerics_mode("parity"):
        got = stagesplit.split_apply(mid, chunk=2)(model, torch.from_numpy(x)).float().numpy()
    with jconfig.numerics_mode("parity"):
        ref = np.asarray(jstagesplit.split_apply(mid, chunk=2)(params, jnp.asarray(x)))
    assert got.shape == ref.shape == (4, 64, 64, 3)
    assert np.abs(got - ref).max() <= 1e-4 * dr, (name, np.abs(got - ref).max() / dr)


def test_split_rejects_ragged_batch_and_unknown_model():
    model, _, _ = cases.port_model(28)
    with pytest.raises(ValueError, match="multiple"):
        stagesplit.split_apply(28, chunk=2)(model, torch.zeros(3, 16, 16, 3))
    with pytest.raises(KeyError, match="stage split"):
        stagesplit.split_apply(4, chunk=2)


def test_shipped_schedule_is_split_capable():
    assert stagesplit.split_ids() == jstagesplit.split_ids() == [9, 20, 27, 28, 30, 33]
    assert stagesplit.SHIPPED == jstagesplit.SHIPPED
    for mid, (body_batch, chunk) in stagesplit.SHIPPED.items():
        assert stagesplit.get_split(mid) is not None and body_batch % chunk == 0


def test_split_chain_timer_runs():
    model, _, _ = cases.port_model(28)
    body, tail = stagesplit.get_split(28)
    s = stagesplit.split_chain_timer(body, tail, model, torch.zeros(4, 16, 16, 3), chunk=2,
                                     reps=2, iters=1)
    assert s > 0


# -- the server ---------------------------------------------------------------------

def test_server_stage_split_matches_plain_server():
    """NASNetBN served split (body at 4, tail in chunks of 2) against the
    unsplit server under parity, a ragged stream of 5 and one frame padded
    to the chunk: at most 1 level apart and under 1e-3 of values moved
    (measured equal)."""
    rs = np.random.RandomState(4)
    frames = _frames(rs, [(16, 20)] * 5)
    plain = SRServer(model_id=28, max_batch=4, device="cpu", tier="parity")
    split = SRServer(model_id=28, max_batch=4, device="cpu", tier="parity", stage_split=2)
    ref = list(plain.process_stream(frames))
    got = list(split.process_stream(frames))
    assert len(got) == len(ref) == 5
    for r, g in zip(ref + ref[:1], got + [split.process_one(frames[0])]):
        d = _level_diff(g, r)
        assert g.shape == (64, 80, 3) and d.max() <= 1 and (d > 0).mean() < 1e-3


def test_server_stage_split_validation():
    with pytest.raises(ValueError, match="stage split"):
        SRServer(model_id=4, device="cpu", stage_split=True)
    srv = SRServer(model_id=27, device="cpu", max_batch=2, stage_split=True)
    assert srv._split[1] == stagesplit.SHIPPED[27][1]


def test_server_refuses_tiled_model_and_mesh():
    with pytest.raises(ValueError, match="tiled"):
        SRServer(model_id=2, device="cpu")
    # a mesh is served (tests/test_torch_parallel.py), but not with a split
    with pytest.raises(ValueError, match="stage_split does not compose with mesh"):
        SRServer(model_id=28, device="cpu", mesh=object(), stage_split=True)


def test_server_takes_a_user_model():
    """``model=`` with ``data_range=`` serves that model (here nearest x4,
    uint8 frames back exactly); the tier is the process's at construction."""
    def toy(x):
        return x.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)

    with pytest.raises(ValueError, match="data_range"):
        SRServer(model=toy, device="cpu")
    with config.numerics_mode("high"):
        srv = SRServer(model=toy, data_range=1.0, device="cpu", max_batch=2)
    assert srv.tier == "high"
    frames = _frames(np.random.RandomState(5), [(8, 6)] * 3)
    outs = list(srv.process_stream(frames))
    for f, o in zip(frames, outs):
        np.testing.assert_array_equal(o, f.repeat(4, axis=0).repeat(4, axis=1))


# -- envelope ------------------------------------------------------------------------

def test_missing_envelope_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="make_gated_envelope"):
        envelope.load_envelope(str(tmp_path / "nope.json"))


def test_plan_parsing(artifact):
    plans = envelope.load_envelope(artifact)
    assert set(plans) == set(ROWS)
    p4 = envelope.plan_for(4, artifact)
    assert (p4.tier, p4.batch, p4.method, p4.chunk, p4.stage_split) == ("fast", 4, "chain",
                                                                          None, False)
    assert p4.ms_per_image == 0.7 and p4.device is None
    p28 = envelope.plan_for(28, artifact)
    assert (p28.method, p28.chunk, p28.stage_split) == ("split", 2, 2)
    with pytest.raises(KeyError, match="no row"):
        envelope.plan_for(44, artifact)


def test_make_server_refuses_fori_plan(artifact):
    with pytest.raises(ValueError, match="tiled runner"):
        envelope.make_server(2, path=artifact, device="cpu")


def test_make_server_pins_the_plan_tier(artifact):
    """The plan's tier (fast: bf16) serves whatever the process's tier is,
    and the process's tier is left as it was."""
    srv = envelope.make_server(4, path=artifact, max_batch=2, device="cpu")
    assert srv.tier == "fast" and srv.plan.tier_delta_db == -0.015
    lr = np.random.RandomState(6).randint(0, 256, (24, 33, 3), dtype=np.uint8)
    sr = srv.process_one(lr)
    assert config.mode() == "parity"
    model, _, dr = cases.port_model(4)
    x = torch.from_numpy(img_util.uint2nhwc(lr, dr))
    with torch.inference_mode():
        parity_ref = img_util.nhwc2uint(model(x).float().numpy(), dr)
        with config.numerics_mode("fast"):
            fast_ref = img_util.nhwc2uint(model(x).float().numpy(), dr)
    assert _level_diff(sr, fast_ref).max() <= 1
    assert _level_diff(sr, parity_ref).max() >= 2


def test_make_server_split_plan(artifact):
    srv = envelope.make_server(28, path=artifact, device="cpu")
    assert srv.plan.method == "split" and srv._split[1] == 2 and srv.tier == "high"
    lr = np.random.RandomState(7).randint(0, 256, (16, 16, 3), dtype=np.uint8)
    model, _, dr = cases.port_model(28)
    with torch.inference_mode(), config.numerics_mode("high"):
        y = model(torch.from_numpy(img_util.uint2nhwc(lr, dr)))
    ref = img_util.nhwc2uint(y.float().numpy(), dr)
    assert _level_diff(srv.process_one(lr), ref).max() <= 1


@pytest.mark.parametrize("which", ["shipped", "artifact"])
def test_envelope_matches_jax(artifact, which):
    """Every plan field by field against JAX's ``load_envelope``, on JAX's
    own envelope (``envelope.TPU_PATH``, whose rows name no device)."""
    path = envelope.TPU_PATH if which == "shipped" else artifact
    plans, jplans = envelope.load_envelope(path), jenvelope.load_envelope(path)
    assert list(plans) == list(jplans)
    for name, p in plans.items():
        j = jplans[name]
        assert p.device is None
        assert (p.model_id, p.name, p.tier, p.batch, p.method, p.chunk, p.ms_per_image,
                p.tier_delta_db, p.stage_split) == (
            j.model_id, j.name, j.tier, j.batch, j.method, j.chunk, j.ms_per_image,
            j.tier_delta_db, j.stage_split), name


def test_list_plans_matches_jax():
    """JAX's plan table (``envelope.TPU_PATH``) row for row as JAX's; only
    the time column's heading differs, naming the device whose time it is
    (the JAX package's TPU). The card's table names the card there."""
    rows = [line.split("|") for line in serve.list_plans(envelope.TPU_PATH).splitlines()]
    jrows = [line.split("|") for line in jserve.list_plans().splitlines()]
    assert len(rows) == len(jrows) == len(envelope.load_envelope(envelope.TPU_PATH)) + 2
    assert rows[1:] == jrows[1:]
    assert [c for k, c in enumerate(rows[0]) if k != 5] == [
        c for k, c in enumerate(jrows[0]) if k != 5]
    assert "TPU" in rows[0][5]
    card = serve.list_plans().splitlines()[0].split("|")[5]
    assert "TPU" not in card and "H100" in card, card


@pytest.mark.parametrize("which", ["card", "tpu"])
def test_shipped_envelope_plans_every_ported_model(which):
    """Every model of the port has a plan, in the card's envelope and in
    JAX's; the tiled model (NLFFC) and no other routes to the tiled runner;
    every split plan has a split."""
    path = envelope.DEFAULT_PATH if which == "card" else envelope.TPU_PATH
    plans = envelope.load_envelope(path)
    assert sorted(p.model_id for p in plans.values()) == sorted(registry._REGISTRY)
    for p in plans.values():
        assert p.tier in config.modes() and p.batch >= 1
        assert (p.method == "fori") == (registry.get_spec(p.model_id).tile is not None), p.name
        if p.method == "split":
            assert stagesplit.get_split(p.model_id) is not None and p.batch % p.chunk == 0
    assert envelope.plan_for(2, path).method == "fori"
    if which == "tpu":
        assert envelope.plan_for(2, path).tier == "fast16"


# -- the CLI -------------------------------------------------------------------------

def _run(capsys, argv):
    assert serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    return out, json.loads(out.strip().splitlines()[-1])


def test_cli_list(artifact, capsys):
    assert serve.main(["--list", "--envelope", artifact]) == 0
    out = capsys.readouterr().out
    assert "04_RLFN" in out and "split/2" in out and "fori" in out
    assert "AUTO ledger" in out and "-0.0150" in out and "ms/img (the JAX package's TPU)" in out


def test_cli_synthetic_chain(artifact, capsys, tmp_path):
    save = str(tmp_path / "sr")
    _, row = _run(capsys, ["--model_id", "4", "--envelope", artifact, "--synthetic", "3",
                           "--hw", "16", "16", "--save_dir", save])
    assert (row["model"], row["tier"], row["images"]) == ("04_RLFN", "fast", 3)
    assert row["images_per_sec"] > 0 and row["ms_per_image"] > 0 and row["saved"]
    assert sorted(os.listdir(save)) == [f"frame_{i:04d}_sr.png" for i in range(3)]
    assert config.mode() == "parity"


def test_cli_split_plan(artifact, capsys):
    _, row = _run(capsys, ["--model_id", "28", "--envelope", artifact, "--synthetic", "2",
                           "--hw", "16", "16"])
    assert row["method"] == "split" and row["images"] == 2


def test_cli_tier_override(artifact, capsys):
    _, row = _run(capsys, ["--model_id", "4", "--envelope", artifact, "--synthetic", "1",
                           "--hw", "16", "16", "--tier", "parity", "--batch", "1"])
    assert row["tier"] == "parity" and row["tier_delta_db"] is None and row["batch"] == 1


def test_cli_images_dir(artifact, capsys, tmp_path):
    """``--images``: every image file, saved under its own stem; each
    output is the server's for that frame."""
    src = tmp_path / "in"
    src.mkdir()
    rs = np.random.RandomState(8)
    frames = {name: rs.randint(0, 256, (16, 16, 3), dtype=np.uint8) for name in ("a", "b")}
    for name, f in frames.items():
        img_util.imsave(f, str(src / f"{name}.png"))
    (src / "notes.txt").write_text("not an image")
    save = str(tmp_path / "sr")
    _, row = _run(capsys, ["--model_id", "4", "--envelope", artifact, "--images", str(src),
                           "--save_dir", save])
    assert row["images"] == 2
    assert sorted(os.listdir(save)) == ["a_sr.png", "b_sr.png"]
    srv = envelope.make_server(4, path=artifact, device="cpu")
    for name, f in frames.items():
        np.testing.assert_array_equal(img_util.imread_uint(os.path.join(save, f"{name}_sr.png")),
                                      srv.process_one(f))


def test_cli_tiled_route(artifact, capsys, tmp_path):
    """The fori plan serves NLFFC through ChunkedTiler; a 24x24 frame is
    smaller than the tile (whole-image path) and its output is the
    model's own forward at the plan's tier."""
    save = str(tmp_path / "sr")
    _, row = _run(capsys, ["--model_id", "2", "--envelope", artifact, "--synthetic", "1",
                           "--hw", "24", "24", "--save_dir", save])
    assert row["method"] == "fori" and row["images"] == 1
    assert os.listdir(save) == ["frame_0000_sr.png"]
    frame = np.random.RandomState(0).randint(0, 256, (24, 24, 3), dtype=np.uint8)
    model, _, dr = cases.port_model(2)
    with torch.inference_mode(), config.numerics_mode("high"):
        y = model(torch.from_numpy(img_util.uint2nhwc(frame, dr)))
    np.testing.assert_array_equal(img_util.imread_uint(os.path.join(save, "frame_0000_sr.png")),
                                  img_util.nhwc2uint(y.float().numpy(), dr))


def test_image_listing(tmp_path):
    """``utils.image.get_image_paths``: image files by extension, sorted by
    directory, then by name."""
    (tmp_path / "sub").mkdir()
    for rel in ("b.png", "a.PNG", "sub/c.bmp", "skip.txt"):
        (tmp_path / rel).write_bytes(b"")
    paths = img_util.get_image_paths(str(tmp_path))
    assert [os.path.relpath(p, tmp_path) for p in paths] == ["a.PNG", "b.png", "sub/c.bmp"]
    assert img_util.get_image_paths(None) is None
    assert img_util.is_image_file("x.jpeg") and not img_util.is_image_file("x.npz")
    with pytest.raises(NotADirectoryError):
        img_util.get_image_paths(str(tmp_path / "missing"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        img_util.get_image_paths(str(tmp_path / "empty"))
