"""Per-model serving plans (counterpart of ``ntire2022_esr_tpu/harness/envelope.py``).

An envelope file holds, for each model, the fastest configuration whose
PSNR on the full protocol stays within 0.005 dB of the parity tier: a
numerics tier, a device batch, and a dispatch method (``chain``: the
whole forward; ``split``: the body at the batch and the x4 tail over
chunks; ``fori``: tiled). :func:`plan_for` reads one model's plan and
:func:`make_server` builds an ``SRServer`` to it.

:data:`DEFAULT_PATH`, ``results/h100/zoo_sustained_gated.json``, is the
card's envelope: the port's ``tools/sweep_zoo_sustained.py`` times each
model's candidates on an H100 and ``tools/make_gated_envelope.py`` builds the file
from those rows and the JAX package's PSNR-delta ledger. :data:`TPU_PATH`
is the JAX package's envelope, chosen by its TPU's timings; the tests and
the parity screen read it to hold the port to JAX on JAX's own plans. A
plan's ``ms_per_image`` is its file's sustained time, on the device that
``device`` names (the card's name and power limit; None in the TPU file,
whose times are the JAX package's on its TPU).

The JAX module wraps its server in a ``_PinnedServer`` that enters the
plan's tier around each call, because ``jax.jit`` traces lazily and reads
the tier then. The port's ``SRServer`` already enters its own tier around
every dispatch, so the server itself is pinned, and there is no wrapper.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

from ntire2022_esr_tpu_torch.harness.serving import SRServer

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_PATH = os.path.join(_REPO, "results", "h100", "zoo_sustained_gated.json")
TPU_PATH = os.path.join(_REPO, "results", "protocol", "zoo_sustained_gated.json")


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """One model's deployment configuration."""

    model_id: int
    name: str
    tier: str                        # numerics tier
    batch: int                       # device batch
    method: str                      # chain | split | fori (tiled)
    chunk: Optional[int]             # split only: the tail's chunk
    ms_per_image: float              # the file's sustained time on its device
    tier_delta_db: Optional[float]   # the tier's PSNR shift against parity (None: high)
    device: Optional[str]            # the card's name and power limit (None: the TPU file)

    @property
    def stage_split(self):
        """The value for ``SRServer(stage_split=...)``."""
        return self.chunk if self.method == "split" else False


def load_envelope(path: Optional[str] = None) -> Dict[str, ServingPlan]:
    """name -> ServingPlan from the envelope file."""
    path = path or DEFAULT_PATH
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"gated envelope artifact not found: {path} "
            "(ntire2022_esr_tpu_torch/tools/make_gated_envelope.py --write writes it)")
    with open(path) as fh:
        raw = json.load(fh)
    return {name: ServingPlan(
        model_id=int(row["model_id"]),
        name=name,
        tier=row.get("tier", row.get("mode", "high")),
        batch=int(row.get("batch", 1)),
        method=row.get("method", "chain"),
        chunk=int(row["chunk"]) if row.get("chunk") else None,
        ms_per_image=float(row["ms_per_image_sustained"]),
        tier_delta_db=row.get("tier_delta_db"),
        device=row.get("device"),
    ) for name, row in raw.items()}


def plan_for(model_id: int, path: Optional[str] = None) -> ServingPlan:
    """The plan of one model id."""
    for plan in load_envelope(path).values():
        if plan.model_id == model_id:
            return plan
    raise KeyError(f"model {model_id} has no row in the gated envelope")


def make_server(model_id: int, *, path: Optional[str] = None, max_batch: Optional[int] = None,
                depth: int = 2, device=None, tier: Optional[str] = None, mesh=None):
    """An ``SRServer`` at the plan's tier (or ``tier``), batch (or
    ``max_batch``) and stage split, with the plan as ``server.plan``, over
    ``mesh`` (a ``parallel.Mesh``) where one is given: a batch plan shards
    its batches over it, and a split plan refuses it, as ``SRServer``
    refuses ``mesh`` beside ``stage_split``. A tiled plan (``fori``,
    NLFFC) is refused: it is served through ``harness.tiling.ChunkedTiler``
    (``harness.serve``)."""
    plan = plan_for(model_id, path)
    if plan.method == "fori":
        raise ValueError(
            f"model {model_id} ({plan.name}) serves via the tiled runner "
            f"(method={plan.method!r}); use harness.tiling.ChunkedTiler under "
            f"config.numerics_mode({plan.tier!r}), as harness.serve does")
    server = SRServer(model_id, max_batch=max_batch or plan.batch, depth=depth, device=device,
                      tier=tier or plan.tier, stage_split=plan.stage_split, mesh=mesh)
    server.plan = plan
    return server
