"""PyTorch/CUDA port of ``ntire2022_esr_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module
layout and names so each counterpart is easy to find:

- ``config``   : numerics tiers (parity/high/fasthi/fasthi16) and device choice
- ``porter``   : npz weight cache -> torch tensors (HWIO -> OIHW)
- ``ops``      : conv / activation / pool / resize primitives, plus the
  hand-written CUDA kernels under ``ops.kernels`` (sources in ``csrc/``)
- ``models``   : the RLFN graph (model 04)
- ``harness``  : model registry and the uint8 serving pipeline

Public tensors are NHWC like the JAX package's; inside, activations are
NCHW-shaped tensors in ``torch.channels_last`` memory (NHWC bytes).
Nothing here imports JAX or the JAX package.
"""

__version__ = "0.1.0"

from ntire2022_esr_tpu_torch import config  # noqa: F401
