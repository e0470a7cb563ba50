"""Data-parallel layout and collectives (counterpart of
``advise_tpu/parallel/__init__.py`` without its model-parallel names: the
auto partition mode, sequence and pipeline axes are not ported)."""

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
