"""Model registry (counterpart of ``ntire2022_esr_tpu/harness/registry.py``).

Ported: model 04 (RLFN) and the RFDN skeleton and IMDN family (-1, 00,
01, 05, 06, 08, 13, 22, 25, 26, 35, 37, 38, 40), under the JAX zoo's
names, checkpoint stems and data ranges (``ntire2022_esr_tpu/models/zoo.py``).
``build_model`` loads the npz weight cache into the model's ``nn.Module``
on the requested device: CUDA unless the caller asks for the CPU. The
RFDN family's modules take their widths from the cache
(``models.blocks.Layer``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Dict, Optional, Tuple

from torch import nn

from ntire2022_esr_tpu_torch import config, porter
from ntire2022_esr_tpu_torch.models.efdn import EFDN
from ntire2022_esr_tpu_torch.models.imdn import IMDN
from ntire2022_esr_tpu_torch.models.plainrfdn import PlainRFDN
from ntire2022_esr_tpu_torch.models.rfdn import RFDN
from ntire2022_esr_tpu_torch.models.rfdn_variants import BMDN, RFDN35, FasterRFDN, RFDNext
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
    # tile-batch cap for the tiled path: a model whose per-tile activations
    # are large (NLFFC upscales first) needs small chunks
    max_tiles_per_call: int = 16


_REGISTRY: Dict[int, ModelSpec] = {}


def register(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.model_id] = spec
    return spec


for _spec in (
    ModelSpec(-1, "-1_IMDN_baseline", functools.partial(IMDN, nc=64, nb=8), "imdn_baseline.pth"),
    ModelSpec(0, "00_RFDN_baseline", RFDN, "rfdn_baseline.pth", 255.0),
    ModelSpec(1, "01_EFDN", EFDN, "team01_efdn.pth"),
    ModelSpec(4, "04_RLFN", RLFN, "team04_rlfn.pth", 255.0),
    ModelSpec(5, "05_EFDN", PlainRFDN, "team05_efdn.pt", 255.0),
    ModelSpec(6, "06_V1", RFDN, "team06_v1.pth"),
    ModelSpec(8, "08_RFDN", functools.partial(RFDN, residual=False, esa_conv_f=False),
              "team08_sfdn.pt"),
    ModelSpec(13, "13_RFDN_Dilated", functools.partial(RFDN, dilations=(1, 2, 5)),
              "team13_rfdn_dilated.pth"),
    ModelSpec(22, "22_RFDN40", RFDN, "team22_rep_rfdn.pth"),
    ModelSpec(25, "25_FasterRFDN", FasterRFDN, "team25_frfdn.pth"),
    ModelSpec(26, "26_IMDN", functools.partial(IMDN, nc=64, nb=7), "team26_imdn_nb7.pth"),
    ModelSpec(35, "35_RFDN", RFDN35, "team35_rfdn.pt", 255.0),
    ModelSpec(37, "37_BMDN", BMDN, "team37_bmdn.pth"),
    ModelSpec(38, "38_RFDN", RFDNext, "team38_rfdnext.pth"),
    ModelSpec(40, "40_RFDNPrune", functools.partial(RFDN, residual=False),
              "team40_rfdn_pruned.pth", 255.0),
):
    register(_spec)


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
