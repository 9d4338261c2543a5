from ntire2022_esr_tpu_torch.porter.convert import (  # noqa: F401
    flatten,
    load_params,
    nest,
    to_torch,
)
from ntire2022_esr_tpu_torch.porter.quant import (  # noqa: F401
    SKIP_KEYS,
    dequantize_params,
    quantize_array_int8,
    quantize_params_int8,
)
