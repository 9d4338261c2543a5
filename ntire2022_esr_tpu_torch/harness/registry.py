"""Model registry (counterpart of ``ntire2022_esr_tpu/harness/registry.py``).

All 42 models of the zoo: model 04 (RLFN), the RFDN skeleton and IMDN
family (-1, 00, 01, 05, 06, 08, 13, 22, 25, 26, 35, 37, 38, 40), the rest
of the conv zoo (03, 10, 11, 14, 15, 16, 17, 18, 19, 23; 24, 27, 28, 29,
31, 33, 34, 36, 39, 42, 43, 44), the attention family (09 IMDTN, 12 HNCT,
20 MobileSR, 30 SCET) and NLFFC (02, the one tiled model), under the JAX
zoo's names, checkpoint stems, data ranges and tiling
(``ntire2022_esr_tpu/models/zoo.py``). The withheld submissions (7, 21,
32, 41) are in neither.
``build_model`` loads the npz weight cache into the model's ``nn.Module``
on the requested device: CUDA unless the caller asks for the CPU. The
RFDN family's modules take their widths from the cache
(``models.blocks.Layer``). Under the w8 tier (``config.weights_int8()``)
it quantizes the cached tree first (``porter.quantize_params_int8``); the
cache stays f32. ``NTIRE_WEIGHTS`` names another cache directory, as for
the JAX package.

Where a model's npz is missing, ``load_params`` ports its torch checkpoint
from the zoo directory (``zoo_dir``, else ``NTIRE_TORCH_ZOO``, else
``reference/model_zoo`` inside this checkout) with the porter that the JAX
package's registry uses (``porter.port_state_dict``), and writes the npz:
the same file the JAX package would write. The reader unpickles
(``porter.read_torch_checkpoint``): load only trusted files.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ntire2022_esr_tpu_torch import config, porter
from ntire2022_esr_tpu_torch.models.aaln import AALN
from ntire2022_esr_tpu_torch.models.afdn import AFDN
from ntire2022_esr_tpu_torch.models.arfdn import ARFDN
from ntire2022_esr_tpu_torch.models.bsrn import BSRN
from ntire2022_esr_tpu_torch.models.clrfdn import CLRFDN
from ntire2022_esr_tpu_torch.models.efdn import EFDN
from ntire2022_esr_tpu_torch.models.fden import FDEN
from ntire2022_esr_tpu_torch.models.fmen import FMEN
from ntire2022_esr_tpu_torch.models.hnct import HNCT
from ntire2022_esr_tpu_torch.models.imdeception import IMDeception
from ntire2022_esr_tpu_torch.models.imdn import IMDN
from ntire2022_esr_tpu_torch.models.imdtn import IMDTN
from ntire2022_esr_tpu_torch.models.m_rfdn import MRFDN
from ntire2022_esr_tpu_torch.models.mdan import MDAN
from ntire2022_esr_tpu_torch.models.misc_conv import ESAN, MDGN, IMDNPlus, LWFANet, SRModel
from ntire2022_esr_tpu_torch.models.mobilesr import MobileSR
from ntire2022_esr_tpu_torch.models.msdn import MSDN
from ntire2022_esr_tpu_torch.models.nlffc import NLFFC
from ntire2022_esr_tpu_torch.models.nasnetbn import NASNetBN
from ntire2022_esr_tpu_torch.models.plainrfdn import PlainRFDN
from ntire2022_esr_tpu_torch.models.prrn import PRRN
from ntire2022_esr_tpu_torch.models.repafdn import RePAFDN
from ntire2022_esr_tpu_torch.models.resdn import ResDN
from ntire2022_esr_tpu_torch.models.rfdn import RFDN
from ntire2022_esr_tpu_torch.models.rfdn_variants import BMDN, RFDN35, FasterRFDN, RFDNext
from ntire2022_esr_tpu_torch.models.rfesr import RFESR
from ntire2022_esr_tpu_torch.models.rlcsr import RLCSR
from ntire2022_esr_tpu_torch.models.rlfn import RLFN
from ntire2022_esr_tpu_torch.models.scet import SCET

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_WEIGHTS_DIR = os.environ.get("NTIRE_WEIGHTS", os.path.join(_ROOT, "weights"))
# the torch checkpoints (the reference's model_zoo), read on a cache miss
DEFAULT_ZOO_DIR = os.environ.get("NTIRE_TORCH_ZOO", os.path.join(_ROOT, "reference", "model_zoo"))


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
    # H-slab spatial sharding (parallel/spatial.py) is exact only for models
    # whose every op is translation-invariant with a bounded receptive field:
    # stride-1 convs, pointwise nonlinearities, channel splits and concats,
    # PixelShuffle, integer-scale resizes. A pooling grid, a size-dependent
    # resize (ESA's bilinear-back), global pooling, window or global
    # attention or an FFT is not slab-decomposable, and the CLI refuses it.
    slab_safe: bool = False
    # halo rows needed for exact slab sharding (one-sided receptive field)
    halo: int = 32
    # the checkpoint keys whose 2-D weights are nn.Linear (regular
    # expressions, porter.port_state_dict); the porter's other rules keep
    # their defaults for every registered model
    linear_keys: Sequence[str] = ()


_REGISTRY: Dict[int, ModelSpec] = {}


def register(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.model_id] = spec
    return spec


for _spec in (
    ModelSpec(-1, "-1_IMDN_baseline", functools.partial(IMDN, nc=64, nb=8), "imdn_baseline.pth",
              slab_safe=True, halo=48),
    ModelSpec(0, "00_RFDN_baseline", RFDN, "rfdn_baseline.pth", 255.0),
    ModelSpec(1, "01_EFDN", EFDN, "team01_efdn.pth"),
    # upscales x4 first: a 256 tile is a 1024x1024 body (test_demo.py:337)
    ModelSpec(2, "02_NLFFC", NLFFC, "team02_nlffc.pth", 255.0, tile=256, max_tiles_per_call=2),
    ModelSpec(3, "03_FMEN", FMEN, "team03_fmen.pth", 255.0, slab_safe=True, halo=48),
    ModelSpec(4, "04_RLFN", RLFN, "team04_rlfn.pth", 255.0),
    ModelSpec(5, "05_EFDN", PlainRFDN, "team05_efdn.pt", 255.0),
    ModelSpec(6, "06_V1", RFDN, "team06_v1.pth"),
    ModelSpec(8, "08_RFDN", functools.partial(RFDN, residual=False, esa_conv_f=False),
              "team08_sfdn.pt"),
    # the qkv, proj and mlp linears of the vendored SwinIR
    ModelSpec(9, "09_IMDTN", IMDTN, "team09_imdtn.pth", linear_keys=(r".*",)),
    ModelSpec(10, "10_RePAFDN", RePAFDN, "team10_repafdn.pth"),
    ModelSpec(11, "11_AALN", AALN, "team11_aaln.pt", 255.0),
    # qkv, proj and mlp linears; the bias table's key does not end in weight
    ModelSpec(12, "12_HNCT", HNCT, "team12_hnct.pt", linear_keys=(r".*",)),
    ModelSpec(13, "13_RFDN_Dilated", functools.partial(RFDN, dilations=(1, 2, 5)),
              "team13_rfdn_dilated.pth"),
    ModelSpec(14, "14_ARFDN", ARFDN, "team14_arfdn.pth"),
    ModelSpec(15, "15_AFDN", AFDN, "team15_afdn.pt", 255.0),
    ModelSpec(16, "16_PRRN", PRRN, "team16_prrn.pth"),
    ModelSpec(17, "17_FDEN", FDEN, "team17_fden.pth", 255.0),
    # every 2-D weight of BSRN is an nn.Linear pointwise conv
    ModelSpec(18, "18_RFDNFINALB5", BSRN, "team18_bsrn.pth", linear_keys=(r".*",)),
    ModelSpec(19, "19_IMDeception", IMDeception, "team19_imdeception.pth"),
    ModelSpec(20, "20_MobileSR", MobileSR, "team20_mobilesr.pth", linear_keys=(r".*",)),
    ModelSpec(22, "22_RFDN40", RFDN, "team22_rep_rfdn.pth"),
    ModelSpec(23, "23_MDAN", MDAN, "team23_mdan.pt", 255.0),
    ModelSpec(24, "24_MDGN", MDGN, "team24_mdgn.pth", 255.0, slab_safe=True, halo=24),
    ModelSpec(25, "25_FasterRFDN", FasterRFDN, "team25_frfdn.pth"),
    ModelSpec(26, "26_IMDN", functools.partial(IMDN, nc=64, nb=7), "team26_imdn_nb7.pth",
              slab_safe=True, halo=44),
    ModelSpec(27, "27_LWFANet", LWFANet, "team27_lwfanet.pth"),
    ModelSpec(28, "28_NASNetBN", NASNetBN, "team28_nasnetbn.pth", slab_safe=True, halo=48),
    ModelSpec(29, "29_RFDN_Conv3X3", CLRFDN, "team29_clrfdn.pth", 255.0),
    ModelSpec(30, "30_SCET", SCET, "team30_scet.pth"),
    ModelSpec(31, "31_SR_model", SRModel, "team31_sr_model.pth"),
    ModelSpec(33, "33_m_RFDN", MRFDN, "team33_m_rfdn.pth"),
    ModelSpec(34, "34_ESAN", ESAN, "team34_esan.pt", 255.0),
    ModelSpec(35, "35_RFDN", RFDN35, "team35_rfdn.pt", 255.0),
    ModelSpec(36, "36_RFESR", RFESR, "team36_rfesr.pt", 255.0),
    ModelSpec(37, "37_BMDN", BMDN, "team37_bmdn.pth"),
    ModelSpec(38, "38_RFDN", RFDNext, "team38_rfdnext.pth"),
    ModelSpec(39, "39_IMDN_plus", IMDNPlus, "team39_imdn_plus.pth", slab_safe=True, halo=56),
    ModelSpec(40, "40_RFDNPrune", functools.partial(RFDN, residual=False),
              "team40_rfdn_pruned.pth", 255.0),
    ModelSpec(42, "42_RLCSR", RLCSR, "team42_rlcsr.pt", 255.0),
    ModelSpec(43, "43_ResDN", ResDN, "team43_resdn.pth"),
    ModelSpec(44, "44_MSDN", MSDN, "team44_msdn.pth"),
):
    register(_spec)


def get_spec(model_id: int) -> ModelSpec:
    if model_id not in _REGISTRY:
        raise KeyError(f"model_id {model_id} is not in the registry (withheld submissions: "
                       f"7, 21, 32, 41; available: {sorted(_REGISTRY)})")
    return _REGISTRY[model_id]


def available_ids() -> List[int]:
    return sorted(_REGISTRY)


def all_specs() -> List[ModelSpec]:
    """Every registered ModelSpec, ordered by model_id."""
    return [_REGISTRY[i] for i in sorted(_REGISTRY)]


def weights_path(spec: ModelSpec, weights_dir: Optional[str] = None) -> str:
    d = weights_dir or DEFAULT_WEIGHTS_DIR
    return os.path.join(d, os.path.splitext(spec.ckpt)[0] + ".npz")


def load_params(spec: ModelSpec, weights_dir: Optional[str] = None,
                zoo_dir: Optional[str] = None, cache: bool = True) -> Dict:
    """The cached weight tree (HWIO numpy arrays, as the JAX package stores
    it). Where the npz is missing, the torch checkpoint ``spec.ckpt`` in
    ``zoo_dir`` (or ``DEFAULT_ZOO_DIR``) is ported and, with ``cache``,
    written as the npz."""
    npz = weights_path(spec, weights_dir)
    if os.path.exists(npz):
        return porter.load_params(npz)
    ckpt = os.path.join(zoo_dir or DEFAULT_ZOO_DIR, spec.ckpt)
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"{spec.name}: no weight cache {npz} and no checkpoint {ckpt} "
                                "(pass zoo_dir or set NTIRE_TORCH_ZOO)")
    sd = porter.read_torch_checkpoint(ckpt)
    tree = porter.nest(porter.port_state_dict(sd, linear_keys=spec.linear_keys))
    if cache:
        os.makedirs(os.path.dirname(npz), exist_ok=True)
        porter.save_params(npz, tree)
    return tree


def hold_w8(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Make each layer that ``state`` gives a ``weight_scale`` hold w8
    weights: an int8 ``weight`` and an f32 ``weight_scale`` of the state's
    shapes, which a strict ``load_state_dict`` then fills. Without it the
    load would copy the int8 values into a float parameter, casting them
    and leaving the scale with no place to go."""
    for key, scale in state.items():
        if key.endswith(".weight_scale"):
            layer = model.get_submodule(key[:-len(".weight_scale")])
            q = state[key[:-len("_scale")]]
            layer.weight = nn.Parameter(torch.empty_like(q), requires_grad=False)
            layer.weight_scale = nn.Parameter(torch.empty_like(scale), requires_grad=False)


def build_model(model_id: int, weights_dir: Optional[str] = None,
                zoo_dir: Optional[str] = None, *,
                device=None) -> Tuple[nn.Module, str, float, Optional[int]]:
    """(model, name, data_range, tile), the model in eval mode with its
    weights loaded on ``device`` (CUDA unless ``device`` says otherwise),
    from the cache or, where its npz is missing, from its torch checkpoint
    in ``zoo_dir`` (:func:`load_params`).
    Every cached key must land in the model and every parameter must come
    from the cache. Under w8 (``config.weights_int8()``) the weights are
    quantized at load (``porter.quantize_params_int8``): the model holds
    int8 weights and their f32 scales. The tensors are made outside
    inference mode, also when the caller is inside
    ``torch.inference_mode()``: the kernels' packed-weight cache keys on a
    tensor's version, which inference tensors lack."""
    dev = config.resolve_device(device)
    spec = get_spec(model_id)
    tree = load_params(spec, weights_dir, zoo_dir)
    if config.weights_int8():
        tree = porter.quantize_params_int8(tree)
    with torch.inference_mode(False):
        model = spec.build()
        state = porter.to_torch(tree)
        hold_w8(model, state)
        model.load_state_dict(state, strict=True)
        model.requires_grad_(False).eval()
        model = model.to(dev)
    return model, spec.name, spec.data_range, spec.tile
