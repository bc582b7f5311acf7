"""Multi-device runs: the `data` x `model` process grid and the tensor-parallel
rules (counterpart of `camouflaged_vlm_tpu/parallel/`)."""

from .mesh import Mesh, batch_rows, init_distributed, make_mesh
from .sharding import (
    check_tp_config,
    gather_optimizer_state,
    gather_state_dict,
    param_partition_kind,
    shard_model_,
    shard_optimizer_state,
    shard_state_dict,
)
