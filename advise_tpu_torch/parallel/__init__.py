"""Process layout and collectives (counterpart of
``advise_tpu/parallel/__init__.py``); the model-parallel modules are
``ring_attention``, ``pipeline`` and ``auto_shard``."""

from advise_tpu_torch.parallel.collectives import (
    all_gather_cat,
    batch_shuffle,
    batch_unshuffle,
    pmean_tree,
    psum_tree,
    replica_index,
    world_size,
)
from advise_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    SYNC_AXIS,
    batch_device_count,
    bn_axis_names,
    distributed_init,
    local_batch_size,
    mesh_shape,
)

__all__ = [
    "BATCH_AXES",
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "SYNC_AXIS",
    "batch_device_count",
    "bn_axis_names",
    "distributed_init",
    "local_batch_size",
    "mesh_shape",
    "all_gather_cat",
    "batch_shuffle",
    "batch_unshuffle",
    "pmean_tree",
    "psum_tree",
    "replica_index",
    "world_size",
]
