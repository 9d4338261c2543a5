"""Multi-device paths (counterpart of ``ntire2022_esr_tpu/parallel/``): one
process drives a list of devices, with no process group (mesh.py)."""

from ntire2022_esr_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_mesh,
    data_space_mesh,
    make_mesh,
)
from ntire2022_esr_tpu_torch.parallel.eval import (  # noqa: F401
    sharded_batch_apply,
    sharded_eval_step,
)
from ntire2022_esr_tpu_torch.parallel.pipeline import PipelinedSR  # noqa: F401
from ntire2022_esr_tpu_torch.parallel.spatial import (  # noqa: F401
    SpatialShardUnavailable,
    make_spatial_apply,
    spatial_shard_apply,
)
