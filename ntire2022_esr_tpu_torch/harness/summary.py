"""Model complexity report (counterpart of ``ntire2022_esr_tpu/harness/summary.py``).

The JAX module counts the convolutions and dot_generals of the lowered
program. Here the model runs once on its plain path, on the CPU, at a
(1, H, W, 3) input under a ``TorchDispatchMode`` that sees every aten op:

- FLOPs  = MACs of each ``aten.convolution`` (kh*kw*(I/g)*O*H*W*N, the
  challenge counts multiply-accumulates) + those of ``aten.mm``, ``bmm``
  and ``addmm`` (output numel times the contracted size);
- #Acts  = sum of the convolutions' output numels;
- #Conv  = number of convolutions;
- #Params = parameter count (``count_params``).

Forward hooks would miss every conv of the port's models, which call
``ops.conv`` and the fused kernels instead of ``nn.Conv2d.forward``, and on
the card the kernels are opaque calls; the plain path on the CPU runs
every conv as an aten op. As in the JAX count, the matmuls of ESA's
bilinear resize are counted.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten

# Weight-norm g-vector sizes the porter folds away (g*v/||v|| -> one
# weight). The published table counts both g and v; convention="reference"
# adds them back. Counted from the reference checkpoints (sum of
# *.weight_g sizes): team23_mdan.pt 15120, team36_rfesr.pt 1152,
# team42_rlcsr.pt 1824.
WEIGHT_NORM_G_PARAMS = {"23_MDAN": 15120, "36_RFESR": 1152, "42_RLCSR": 1824}


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.conv_macs = self.dot_macs = self.conv_acts = self.num_conv = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is _aten.convolution.default:
            w, transposed, groups = args[1], args[6], args[8]
            ipg = w.shape[0] // groups if transposed else w.shape[1]
            self.conv_macs += out.numel() * ipg * w.shape[2] * w.shape[3]
            self.conv_acts += out.numel()
            self.num_conv += 1
        elif func in (_aten.mm.default, _aten.bmm.default):
            self.dot_macs += out.numel() * args[0].shape[-1]
        elif func is _aten.addmm.default:
            self.dot_macs += out.numel() * args[1].shape[-1]
        return out


def count_params(model: nn.Module, convention: str = "deploy", model_name: str = "") -> int:
    """Parameter count with torch ``model.parameters()`` semantics over the
    state dict: BatchNorm running statistics are excluded.

    ``convention="deploy"`` counts what is stored; ``"reference"`` adds the
    weight-norm g vectors the porter folded (``WEIGHT_NORM_G_PARAMS``), so
    a comparison with the published table matches."""
    n = sum(v.numel() for k, v in model.state_dict().items()
            if not (k.endswith("running_mean") or k.endswith("running_var")
                    or k.endswith("num_batches_tracked")))
    if convention == "reference":
        n += WEIGHT_NORM_G_PARAMS.get(model_name, 0)
    elif convention != "deploy":
        raise ValueError(f"convention must be 'deploy' or 'reference', got {convention!r}")
    return n


def model_complexity(model: nn.Module, input_hw: Tuple[int, int] = (256, 256),
                     params_convention: str = "deploy", model_name: str = "") -> Dict[str, float]:
    """Challenge-style complexity report on a (1, H, W, 3) input: the
    fields results.json records (activations [M], num_conv, flops [G],
    num_parameters [M]). ``model`` may live on any device; a CPU copy runs."""
    if any(t.device.type != "cpu" for t in model.state_dict().values()):
        model = copy.deepcopy(model).to("cpu")
    h, w = input_hw
    counter = _OpCounter()
    with torch.no_grad(), counter:
        model(torch.zeros((1, h, w, 3), dtype=torch.float32))
    return {
        "activations": counter.conv_acts / 1e6,
        "num_conv": counter.num_conv,
        "flops": (counter.conv_macs + counter.dot_macs) / 1e9,
        "num_parameters": count_params(model, params_convention, model_name) / 1e6,
    }
