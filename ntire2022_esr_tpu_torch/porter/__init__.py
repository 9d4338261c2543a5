from ntire2022_esr_tpu_torch.porter.convert import (  # noqa: F401
    flatten,
    load_params,
    nest,
    to_torch,
)
