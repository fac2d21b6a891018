from .mesh import (
    aug_sharding,
    data_sharding,
    host_local_batch_to_global,
    initialize_distributed,
    make_mesh,
    make_multihost_mesh,
    multihost_mesh_shape,
    replicated,
)
from .sharded import (
    make_asr_batch_fn,
    make_sharded_train_step,
    padded_aug_count,
    padded_sr_cfg,
    shard_batch,
    shard_batch_multihost,
    shard_train_batch,
)

__all__ = [
    "aug_sharding",
    "data_sharding",
    "host_local_batch_to_global",
    "initialize_distributed",
    "make_mesh",
    "make_multihost_mesh",
    "multihost_mesh_shape",
    "replicated",
    "make_asr_batch_fn",
    "make_sharded_train_step",
    "padded_aug_count",
    "padded_sr_cfg",
    "shard_batch",
    "shard_batch_multihost",
    "shard_train_batch",
]
