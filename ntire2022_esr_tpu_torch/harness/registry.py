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
(``models.blocks.Layer``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Dict, Optional, Tuple

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
    # H-slab spatial sharding (parallel/spatial.py) is exact only for models
    # whose every op is translation-invariant with a bounded receptive field:
    # stride-1 convs, pointwise nonlinearities, channel splits and concats,
    # PixelShuffle, integer-scale resizes. A pooling grid, a size-dependent
    # resize (ESA's bilinear-back), global pooling, window or global
    # attention or an FFT is not slab-decomposable, and the CLI refuses it.
    slab_safe: bool = False
    # halo rows needed for exact slab sharding (one-sided receptive field)
    halo: int = 32


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
    ModelSpec(9, "09_IMDTN", IMDTN, "team09_imdtn.pth"),
    ModelSpec(10, "10_RePAFDN", RePAFDN, "team10_repafdn.pth"),
    ModelSpec(11, "11_AALN", AALN, "team11_aaln.pt", 255.0),
    ModelSpec(12, "12_HNCT", HNCT, "team12_hnct.pt"),
    ModelSpec(13, "13_RFDN_Dilated", functools.partial(RFDN, dilations=(1, 2, 5)),
              "team13_rfdn_dilated.pth"),
    ModelSpec(14, "14_ARFDN", ARFDN, "team14_arfdn.pth"),
    ModelSpec(15, "15_AFDN", AFDN, "team15_afdn.pt", 255.0),
    ModelSpec(16, "16_PRRN", PRRN, "team16_prrn.pth"),
    ModelSpec(17, "17_FDEN", FDEN, "team17_fden.pth", 255.0),
    ModelSpec(18, "18_RFDNFINALB5", BSRN, "team18_bsrn.pth"),
    ModelSpec(19, "19_IMDeception", IMDeception, "team19_imdeception.pth"),
    ModelSpec(20, "20_MobileSR", MobileSR, "team20_mobilesr.pth"),
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
    from the cache. The tensors are made outside inference mode, also when
    the caller is inside ``torch.inference_mode()``: the kernels' packed-
    weight cache keys on a tensor's version, which inference tensors lack."""
    dev = config.resolve_device(device)
    spec = get_spec(model_id)
    with torch.inference_mode(False):
        model = spec.build()
        model.load_state_dict(porter.to_torch(load_params(spec, weights_dir)), strict=True)
        model.requires_grad_(False).eval()
        model = model.to(dev)
    return model, spec.name, spec.data_range, spec.tile
