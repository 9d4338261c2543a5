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

:func:`per_layer_macs` is the reference's ``print_model_with_flops``: the
MACs of each conv and matmul, labelled by the named parameter that feeds
its weight operand. The counter follows a parameter's name through the
ops that ``ops.nn`` applies to a weight before it reaches the contraction
(casts, views, transposes, ``contiguous``, the f16 clamp and the w8
dequant's multiply), as the JAX count follows a param leaf through its
jaxpr's ``_PASSTHROUGH`` primitives; anything else is ``<activation>``
(a conv) or ``<attention/matmul>`` (a matmul), as in JAX.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

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
    counter = _run_counted(model, input_hw)
    return {
        "activations": counter.conv_acts / 1e6,
        "num_conv": sum(1 for r in counter.rows if r[2] == "conv"),
        "flops": sum(r[0] for r in counter.rows) / 1e9,
        "num_parameters": count_params(model, params_convention, model_name) / 1e6,
    }


# ops whose output is, for naming, the tensor they were given: a weight that
# goes through them keeps its parameter's name (the first operand's; a w8
# weight's dequant multiplies it by its scale)
_PASSTHROUGH = {
    _aten._to_copy.default, _aten.clone.default, _aten.view.default,
    _aten._unsafe_view.default, _aten.reshape.default, _aten.permute.default,
    _aten.transpose.int, _aten.t.default, _aten.expand.default, _aten.alias.default,
    _aten.detach.default, _aten.contiguous.default, _aten.clamp.default,
    _aten.mul.Tensor, _aten.squeeze.dim, _aten.unsqueeze.default, _aten.flip.default,
}


class _OpCounter(TorchDispatchMode):
    """``rows``: ``(macs, label, kind)`` of each conv and matmul, labelled
    by the tensors of ``named`` (name -> tensor; ``names`` maps the ``id``
    of each named tensor to (the tensor, its name), the tensor kept so
    that its id is not reused); ``conv_acts``: the convs' output numels."""

    def __init__(self, named: Dict[str, torch.Tensor]):
        super().__init__()
        self.names = {id(t): (t, k) for k, t in named.items()}
        self.rows: List[Tuple[int, str, str]] = []
        self.conv_acts = 0

    def _name(self, t):
        entry = self.names.get(id(t)) if isinstance(t, torch.Tensor) else None
        return entry[1] if entry is not None else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _PASSTHROUGH:
            name = self._name(args[0])
            if name is not None and isinstance(out, torch.Tensor):
                self.names[id(out)] = (out, name)
        elif func is _aten.convolution.default:
            w, transposed, groups = args[1], args[6], args[8]
            ipg = w.shape[0] // groups if transposed else w.shape[1]
            oc = w.shape[1] * groups if transposed else w.shape[0]
            kh, kw = w.shape[2], w.shape[3]
            label = self._name(w) or "<activation>"
            self.conv_acts += out.numel()
            self.rows.append((out.numel() * ipg * kh * kw,
                              f"{label}  (conv {kh}x{kw} x{ipg}->{oc})", "conv"))
        elif func in (_aten.mm.default, _aten.bmm.default, _aten.addmm.default):
            lhs, rhs = args[-2], args[-1]
            k = lhs.shape[-1]
            label = self._name(rhs) or self._name(lhs) or "<attention/matmul>"
            self.rows.append((out.numel() * k, f"{label}  (dot k={k} -> {tuple(out.shape)})",
                              "dot"))
        return out


def per_layer_macs(model: nn.Module, input_hw: Tuple[int, int] = (256, 256)
                   ) -> List[Tuple[int, str, str]]:
    """``(macs, label, kind)`` of every conv (``kind`` "conv") and matmul
    ("dot") of one forward on a (1, H, W, 3) input, sorted by MACs,
    largest first (ties in the order they ran). The label is the weight's
    parameter name (``B1.c2_r.weight  (conv 3x3 x48->48)``), in the JAX
    package's format; the count runs on a CPU copy of ``model``."""
    counter = _run_counted(model, input_hw)
    return sorted(counter.rows, key=lambda r: r[0], reverse=True)


def _run_counted(model: nn.Module, input_hw: Tuple[int, int]) -> "_OpCounter":
    """One forward of a CPU copy of ``model`` on a (1, H, W, 3) input under
    an :class:`_OpCounter` of the model's parameters and buffers."""
    if any(t.device.type != "cpu" for t in model.state_dict().values()):
        model = copy.deepcopy(model).to("cpu")
    h, w = input_hw
    counter = _OpCounter(model.state_dict(keep_vars=True))
    with torch.no_grad(), counter:
        model(torch.zeros((1, h, w, 3), dtype=torch.float32))
    return counter


def per_layer_report(model: nn.Module, input_hw: Tuple[int, int] = (256, 256),
                     top: int = 0) -> str:
    """:func:`per_layer_macs` as a table: MACs, share of the total, layer
    (the ``top`` largest where ``top`` is set)."""
    rows = per_layer_macs(model, input_hw)
    total = sum(r[0] for r in rows) or 1
    if top:
        rows = rows[:top]
    lines = [f"{'MACs':>14}  {'share':>6}  layer"]
    for macs, desc, _kind in rows:
        lines.append(f"{macs:14,d}  {100 * macs / total:5.1f}%  {desc}")
    return "\n".join(lines)
