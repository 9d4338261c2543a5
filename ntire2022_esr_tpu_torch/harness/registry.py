"""Model registry (counterpart of ``ntire2022_esr_tpu/harness/registry.py``).

Only model 04 (RLFN) is ported. ``build_model`` loads the npz weight
cache into the model's ``nn.Module`` on the requested device: CUDA unless
the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

from torch import nn

from ntire2022_esr_tpu_torch import config, porter
from ntire2022_esr_tpu_torch.models.rlfn import RLFN

DEFAULT_WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "weights")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    model_id: int
    name: str                       # registry display name, "{id:02}_{NET}"
    build: Callable[[], nn.Module]  # the model, weights not loaded yet
    ckpt: str                       # checkpoint file name; the cache is <stem>.npz
    data_range: float = 1.0
    tile: Optional[int] = None      # overlap-tile size (None = whole image)


_REGISTRY: Dict[int, ModelSpec] = {}


def register(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.model_id] = spec
    return spec


register(ModelSpec(model_id=4, name="04_RLFN", build=RLFN, ckpt="team04_rlfn.pth",
                   data_range=255.0))


def get_spec(model_id: int) -> ModelSpec:
    if model_id not in _REGISTRY:
        raise KeyError(f"model_id {model_id} is not ported yet (ported: {sorted(_REGISTRY)}; "
                       "the rest of the zoo is queued in ROADMAP.md)")
    return _REGISTRY[model_id]


def weights_path(spec: ModelSpec, weights_dir: Optional[str] = None) -> str:
    d = weights_dir or DEFAULT_WEIGHTS_DIR
    return os.path.join(d, os.path.splitext(spec.ckpt)[0] + ".npz")


def load_params(spec: ModelSpec, weights_dir: Optional[str] = None) -> Dict:
    """The cached weight tree (HWIO numpy arrays, as the JAX package stores it)."""
    return porter.load_params(weights_path(spec, weights_dir))


def build_model(model_id: int, weights_dir: Optional[str] = None, *,
                device=None) -> Tuple[nn.Module, str, float, Optional[int]]:
    """(model, name, data_range, tile), the model in eval mode with its
    weights loaded on ``device`` (CUDA unless ``device`` says otherwise).
    Every cached key must land in the model and every parameter must come
    from the cache."""
    dev = config.resolve_device(device)
    spec = get_spec(model_id)
    model = spec.build()
    model.load_state_dict(porter.to_torch(load_params(spec, weights_dir)), strict=True)
    model.requires_grad_(False).eval()
    return model.to(dev), spec.name, spec.data_range, spec.tile
