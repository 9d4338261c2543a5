from ntire2022_esr_tpu_torch.ops import nn  # noqa: F401
from ntire2022_esr_tpu_torch.ops.nn import (  # noqa: F401
    cast_compute,
    cat,
    conv,
    conv2d,
    from_nhwc,
    leaky_relu,
    max_pool2d,
    pixel_shuffle,
    pixel_unshuffle,
    prelu,
    relu,
    saturate_f16,
    sigmoid,
    store_out,
    to_nhwc,
)
from ntire2022_esr_tpu_torch.ops.resize import interpolate  # noqa: F401
