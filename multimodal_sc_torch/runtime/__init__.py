from multimodal_sc_torch.runtime.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    local_batch_size,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from multimodal_sc_torch.runtime.prefetch import prefetch_to_device
from multimodal_sc_torch.runtime.tp import apply_tp, tp_param_shardings
