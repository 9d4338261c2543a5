"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Importing this package compiles nothing; ``build.load`` compiles a
kernel's library the first time a CUDA tensor reaches its wrapper.
"""

from ntire2022_esr_tpu_torch.ops.kernels.conv_chain import (  # noqa: F401
    conv3x3_chain_plain,
    fused_conv3x3_chain,
)
from ntire2022_esr_tpu_torch.ops.kernels.tail import (  # noqa: F401
    conv3x3_pixelshuffle_plain,
    fused_conv3x3_pixelshuffle,
)
