"""Stage-split dispatch (counterpart of ``ntire2022_esr_tpu/harness/stagesplit.py``):
the low-resolution body at the full batch, then the x4 tail over chunks.

Six models expose the seam as two methods: ``<prefix>_body(x)`` (NCHW in)
and ``<prefix>_tail(h, x_lr)``, and their ``forward`` is the tail of the
body, so the split computes the whole model's function. The tail runs at
the full output resolution, where a model's activations are 16 times as
large as the body's: a server that runs the body at a large batch and the
tail a few images at a time holds the tail's activations for a chunk
only. On the card the kernels and cuDNN may pick another algorithm for
another batch, so the split need not equal the whole forward bit for bit.

:data:`SHIPPED` is the JAX package's schedule, chosen from its own
measurements (``results/protocol/zoo_sustained_gated.json``); the card's
plans (``harness/envelope.py``) come from the port's own sweep, whose
``split`` rows run this schedule.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ntire2022_esr_tpu_torch import ops
from ntire2022_esr_tpu_torch.harness.profiling import chain_timer


class Split(NamedTuple):
    body: Callable[[nn.Module, torch.Tensor], torch.Tensor]                # (model, x) -> h
    tail: Callable[[nn.Module, torch.Tensor, torch.Tensor], torch.Tensor]  # (model, h, x) -> y


def _split(prefix: str, nchw_tail: bool) -> Split:
    """The pair over NHWC ``x`` and NHWC ``y``, from the model's methods;
    ``nchw_tail``: the tail returns NCHW (LWFANet, NASNetBN, m_RFDN)."""
    def body(model, x):
        return getattr(model, f"{prefix}_body")(ops.from_nhwc(x))

    def tail(model, h, x):
        y = getattr(model, f"{prefix}_tail")(h, ops.from_nhwc(x))
        return ops.to_nhwc(y) if nchw_tail else y

    return Split(body, tail)


_SPLITS: Dict[int, Split] = {
    9: _split("imdtn", False),
    20: _split("mobilesr", False),
    27: _split("lwfanet", True),
    28: _split("nasnetbn", True),
    30: _split("scet", False),
    33: _split("m_rfdn", True),
}

# model_id -> (body batch, tail chunk): the JAX package's shipped schedule
SHIPPED: Dict[int, Tuple[int, int]] = {
    27: (128, 8),  # LWFANet
    28: (128, 8),  # NASNetBN
}


def get_split(model_id: int) -> Optional[Split]:
    """The (body, tail) pair of a split-capable model, else None."""
    return _SPLITS.get(model_id)


def split_ids():
    return sorted(_SPLITS)


def _check_batch(n: int, chunk: int) -> None:
    if n % chunk:
        raise ValueError(f"batch {n} not a multiple of tail chunk {chunk}")


def split_apply(model_id: int, chunk: int,
                split: Optional[Split] = None) -> Callable[[nn.Module, torch.Tensor], torch.Tensor]:
    """``run(model, x)``: the body once on the whole batch ``x`` (NHWC),
    the tail on each ``chunk`` of it, the outputs concatenated. The batch
    must be a multiple of ``chunk``."""
    sp = split or get_split(model_id)
    if sp is None:
        raise KeyError(f"model {model_id} has no registered stage split "
                       f"(available: {split_ids()})")

    def run(model, x):
        _check_batch(x.shape[0], chunk)
        h = sp.body(model, x)
        return torch.cat([sp.tail(model, h[c:c + chunk], x[c:c + chunk])
                          for c in range(0, x.shape[0], chunk)])

    return run


def split_chain_timer(body: Callable, tail: Callable, model: nn.Module, x: torch.Tensor,
                      chunk: int, reps: int = 8, iters: int = 3) -> float:
    """``profiling.chain_timer`` of the split schedule, median seconds a
    chain: each forward runs the body on the whole (varied) batch and the
    tail on each chunk of it, and each tail's output is summed on its own,
    as the JAX tool sums each tail executable's."""
    _check_batch(x.shape[0], chunk)

    def split_forward(v):
        h = body(model, v)
        return torch.stack([tail(model, h[c:c + chunk], v[c:c + chunk]).sum()
                            for c in range(0, v.shape[0], chunk)])

    return chain_timer(split_forward, x, reps, iters)
