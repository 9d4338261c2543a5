"""Arguments the port takes as the JAX package does, each against the JAX
function on the CPU: ``envelope.make_server(mesh=)``,
``tiling.tiled_apply(batch_tiles=)`` and the fields of ``ServingPlan``.
(The global pools' ``keepdims`` is in ``tests/test_torch_tiers.py``.)"""

import dataclasses
import inspect
import json

import jax
import numpy as np
import pytest
import torch

import test_torch_zoo_cases as cases
from ntire2022_esr_tpu.harness import envelope as jenvelope
from ntire2022_esr_tpu.harness import tiling as jtiling
from ntire2022_esr_tpu.parallel import make_mesh as jmake_mesh
from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.harness import envelope, tiling
from ntire2022_esr_tpu_torch.parallel import make_mesh

CPU2 = [torch.device("cpu")] * 2
# a batch plan (RLFN at parity, so that the two frameworks agree to a level)
# and a split plan (NASNetBN), as the gated envelope writes them
ROWS = {
    "04_RLFN": {"model_id": 4, "batch": 4, "reps": 8, "tier": "parity", "method": "chain",
                "ms_per_image_sustained": 0.7, "tier_delta_db": 0.0},
    "28_NASNetBN": {"model_id": 28, "batch": 4, "chunk": 2, "reps": 8, "tier": "high",
                    "method": "split", "size": 256, "ms_per_image_sustained": 8.9,
                    "tier_delta_db": None},
}


@pytest.fixture
def artifact(tmp_path):
    p = tmp_path / "zoo_sustained_gated.json"
    p.write_text(json.dumps(ROWS))
    return str(p)


def test_make_server_takes_jax_arguments():
    """Every parameter of JAX's ``make_server`` is one of the port's."""
    jp = set(inspect.signature(jenvelope.make_server).parameters)
    assert jp <= set(inspect.signature(envelope.make_server).parameters), jp


def test_serving_plan_has_jax_fields():
    """Every field of JAX's ``ServingPlan`` is a field of the port's, and
    reads the same from JAX's envelope (the port adds ``device``)."""
    fields = {f.name for f in dataclasses.fields(envelope.ServingPlan)}
    jfields = {f.name for f in dataclasses.fields(jenvelope.ServingPlan)}
    assert jfields <= fields and fields - jfields == {"device"}, (jfields, fields)
    p, j = envelope.plan_for(4, envelope.TPU_PATH), jenvelope.plan_for(4)
    assert all(getattr(p, f) == getattr(j, f) for f in jfields)


def test_make_server_mesh_batch_plan(artifact):
    """A batch plan served over a mesh of two entries: equal in every value
    to the server without a mesh, and at most one level from JAX's server
    over its two-device mesh on the same frames."""
    rs = np.random.RandomState(21)
    frames = [rs.randint(0, 256, (16, 20, 3), dtype=np.uint8) for _ in range(3)]
    srv = envelope.make_server(4, path=artifact, device="cpu", mesh=make_mesh(2, devices=CPU2))
    assert srv.plan.method == "chain" and srv.tier == "parity" and srv._sharded is not None
    out = np.stack(list(srv.process_stream(frames)))
    ref = np.stack(list(envelope.make_server(4, path=artifact, device="cpu")
                        .process_stream(frames)))
    np.testing.assert_array_equal(out, ref)
    jsrv = jenvelope.make_server(4, path=artifact, mesh=jmake_mesh(2))
    jout = np.stack(list(jsrv.process_stream(frames)))
    assert np.abs(out.astype(np.int16) - jout.astype(np.int16)).max() <= 1


def test_make_server_mesh_split_plan_refused(artifact):
    """A split plan refuses a mesh, as JAX's does."""
    with pytest.raises(ValueError, match="stage_split does not compose"):
        envelope.make_server(28, path=artifact, device="cpu", mesh=make_mesh(2, devices=CPU2))
    with pytest.raises(ValueError, match="stage_split does not compose"):
        jenvelope.make_server(28, path=artifact, mesh=jmake_mesh(2))


def test_tiled_apply_one_tile_a_call():
    """``batch_tiles=False``: one model call a tile, on the image's own
    (1, tile, tile, 3) slice; the blend equals JAX's
    ``tiled_apply(..., batch_tiles=False)`` within the zoo's parity bound
    (``check_jax_parity``: 1e-4 * dr) and the batched blend of the same
    tiles."""
    model, _, dr = cases.port_model(4)
    apply, params = cases.jax_model(4)
    x = np.random.RandomState(22).rand(1, 24, 28, 3).astype(np.float32) * dr
    shapes = []

    def spy(v):
        shapes.append(tuple(v.shape))
        return model(v)

    with torch.inference_mode(), config.numerics_mode("parity"):
        out = tiling.tiled_apply(spy, torch.from_numpy(x), 16, tile_overlap=4,
                                 batch_tiles=False).numpy()
        batched = tiling.tiled_apply(model, torch.from_numpy(x), 16, tile_overlap=4).numpy()
    # rows start at 0 and 8, columns at 0 and 12: 4 tiles
    assert shapes == [(1, 16, 16, 3)] * 4
    ref = np.asarray(jax.jit(lambda p, v: jtiling.tiled_apply(
        apply, p, v, 16, tile_overlap=4, batch_tiles=False))(params, x))
    assert out.shape == ref.shape == (1, 96, 112, 3)
    assert np.abs(out - ref).max() <= 1e-4 * dr, np.abs(out - ref).max()
    assert np.abs(out - batched).max() <= 1e-4 * dr
