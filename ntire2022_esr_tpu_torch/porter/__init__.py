from ntire2022_esr_tpu_torch.porter.convert import (  # noqa: F401
    flatten,
    fold_weight_norm,
    load_params,
    nest,
    port_state_dict,
    reference_state_dict,
    save_params,
    to_torch,
)
from ntire2022_esr_tpu_torch.porter.quant import (  # noqa: F401
    SKIP_KEYS,
    dequantize_params,
    quantize_array_int8,
    quantize_params_int8,
)
from ntire2022_esr_tpu_torch.porter.reader import read_torch_checkpoint  # noqa: F401
from ntire2022_esr_tpu_torch.porter.reparam import (  # noqa: F401
    fold_linear_block,
    fold_linear_block_tree,
)
