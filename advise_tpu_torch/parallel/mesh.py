"""The process layout of data-parallel training (counterpart of
``advise_tpu/parallel/mesh.py``): one process per card, and one rank in the
place of one device of the JAX package's ``('data', 'sync')`` mesh.

The JAX package runs one program over a mesh; the port runs one process a
card, the reference's own idiom, launched by ``torch.distributed.run``
(torchrun), which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``. Rank r stands for
the mesh device at (data r // sync, sync r % sync): the BN sync groups are
contiguous runs of ``sync`` ranks, as ``devs.reshape(data, sync)`` puts
adjacent devices in one group. Gradients, stats and running statistics
average over the world; BN statistics over the rank's sync group (the
world under BN.GLOBAL_SYNC).

Without a process group there is one rank, world 1, and no collective:
every helper of ``parallel/collectives.py`` is then the identity. The
backend is chosen by rule, never by catching a failure: NCCL where each
rank has a card of its own, gloo on the CPU and where ranks share a card
(NCCL refuses two ranks on one device).

The model-parallel half of the JAX module (TPU.PARTITION_MODE 'auto',
TPU.MESH_SEQ and TPU.MESH_PIPE) is not ported: :func:`check_data_parallel`
raises for it (ROADMAP A 16).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
SYNC_AXIS = "sync"
BATCH_AXES = (DATA_AXIS, SYNC_AXIS)
# a collective that waits longer than this fails the run instead of hanging it
PROCESS_GROUP_TIMEOUT = datetime.timedelta(minutes=10)

# this process's groups, set by :func:`init_groups`: {axes: (group, size, index)}
_GROUPS: Dict[Tuple[str, ...], Tuple[Any, int, int]] = {}


def check_data_parallel(cfg) -> None:
    """Raise for the model-parallel layouts the port does not carry yet."""
    if getattr(cfg.TPU, "PARTITION_MODE", "shard_map") == "auto":
        raise NotImplementedError("TPU.PARTITION_MODE 'auto' is not ported yet (ROADMAP A 16)")
    if int(getattr(cfg.TPU, "MESH_SEQ", 1) or 1) > 1:
        raise NotImplementedError("not ported yet: TPU.MESH_SEQ (ring attention) (ROADMAP A 16)")
    if int(getattr(cfg.TPU, "MESH_PIPE", 1) or 1) > 1:
        raise NotImplementedError("not ported yet: TPU.MESH_PIPE (GPipe) (ROADMAP A 16)")


def mesh_shape(cfg, n_devices: int) -> Tuple[int, int]:
    """(data, sync) axis sizes for ``n_devices`` ranks: the sync axis is
    BN.NUM_SYNC_DEVICES (TPU.MESH_SYNC when > 0; all under BN.GLOBAL_SYNC),
    cut to the largest divisor of the count; TPU.MESH_DATA, when > 0, must
    agree. A MESH_SEQ or MESH_PIPE axis is carved off first."""
    n = n_devices
    seq = max(int(getattr(cfg.TPU, "MESH_SEQ", 1) or 1), 1)
    if seq > 1:
        assert n % seq == 0, (n, seq)
        n = n // seq
    pipe = max(int(getattr(cfg.TPU, "MESH_PIPE", 1) or 1), 1)
    if pipe > 1:
        assert n % pipe == 0, (n, pipe)
        n = n // pipe
    if cfg.BN.GLOBAL_SYNC:
        sync = n
    else:
        sync = int(cfg.TPU.MESH_SYNC)
        if sync <= 0:
            sync = min(int(cfg.BN.NUM_SYNC_DEVICES or 1), n)
        sync = min(sync, n)
    while n % sync != 0:
        sync -= 1
    data = n // sync
    want_data = int(getattr(cfg.TPU, "MESH_DATA", -1) or -1)
    if want_data > 0 and want_data != data:
        raise ValueError(
            f"TPU.MESH_DATA={want_data} but {n} batch devices with sync={sync} give data={data}; "
            "set MESH_DATA -1 to infer or make data*sync match the device count")
    return data, sync


def bn_axis_names(cfg) -> Tuple[str, ...]:
    """The axes over which BatchNorm statistics are synchronized."""
    if getattr(cfg.TPU, "PARTITION_MODE", "shard_map") == "auto":
        return ()
    if cfg.BN.NORM_TYPE != "sync_batchnorm":
        return ()
    if cfg.BN.GLOBAL_SYNC:
        return (DATA_AXIS, SYNC_AXIS)
    return (SYNC_AXIS,)


def batch_device_count(cfg, n_devices: int) -> int:
    """The ranks that carry distinct batch shards: ``n_devices`` over the
    batch-replicating axes (MESH_MODEL under 'auto', MESH_SEQ x MESH_PIPE
    otherwise); the reference's NUM_WORLDS."""
    if getattr(cfg.TPU, "PARTITION_MODE", "shard_map") == "auto":
        rep = max(int(getattr(cfg.TPU, "MESH_MODEL", 1) or 1), 1)
    else:
        rep = max(int(getattr(cfg.TPU, "MESH_SEQ", 1) or 1), 1) * max(int(getattr(cfg.TPU, "MESH_PIPE", 1) or 1), 1)
    assert n_devices % rep == 0, (n_devices, rep)
    return n_devices // rep


def local_batch_size(cfg, n_devices: int) -> int:
    """Each rank's share of the global batch DATA.BATCHSIZE_PER_GPU x
    ``n_devices``."""
    global_batch = cfg.DATA.BATCHSIZE_PER_GPU * n_devices
    assert global_batch % n_devices == 0
    return global_batch // n_devices


def sync_groups(cfg, n_devices: int) -> List[List[int]]:
    """The BN sync groups of ``n_devices`` ranks: contiguous runs of the
    sync axis's size, the rows of ``devs.reshape(data, sync)``."""
    _, sync = mesh_shape(cfg, n_devices)
    return [list(range(first, first + sync)) for first in range(0, n_devices, sync)]


def choose_backend(device_type: str, local_world: int) -> str:
    """gloo on the CPU and where the node's ranks outnumber its cards, else
    NCCL."""
    if device_type != "cuda" or local_world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_groups(cfg) -> None:
    """Create this process's groups over the initialized default group: one
    ``new_group`` a sync group, all made in the same order on every rank
    (once a process). Without a process group: none (world 1)."""
    if not dist.is_initialized():
        _GROUPS.clear()
        return
    world, rank = dist.get_world_size(), dist.get_rank()
    groups = sync_groups(cfg, world)
    sync = len(groups[0])
    if _GROUPS and _GROUPS[(SYNC_AXIS,)][1] == sync:
        return  # made by an earlier call of this process
    _GROUPS.clear()
    mine = None
    for ranks in groups:
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    _GROUPS[BATCH_AXES] = (dist.group.WORLD, world, rank)
    _GROUPS[(SYNC_AXIS,)] = (mine, sync, rank % sync)
    logger.info("process groups: rank %d of %d, sync groups of %d (%s backend)", rank, world, sync,
                dist.get_backend())


def axis_group(axes) -> Optional[Tuple[Any, int, int]]:
    """(group, size, this rank's index) of the ranks spanning ``axes``, or
    None without a process group (or with no axes)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if not axes or not _GROUPS:
        return None
    if axes not in _GROUPS:
        raise ValueError(f"no process group over the axes {axes}")
    return _GROUPS[axes]


def world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def distributed_init(cfg, device="cuda") -> torch.device:
    """Join the job torchrun launched (``RANK`` and ``WORLD_SIZE`` in the
    environment; the counterpart of ``jax.distributed.initialize``), make
    the sync groups and set cfg.RANK, cfg.LOCAL_RANK and cfg.NUM_WORLDS
    (the batch-carrying ranks). Returns this rank's device: on the card
    ``cuda:LOCAL_RANK`` (ranks that share a node's cards take them in
    turn). A process group initialized before the call is used as it is;
    without one, and outside torchrun, this is rank 0 of a world of 1 and
    no group is made."""
    check_data_parallel(cfg)
    device = torch.device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if not dist.is_initialized() and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        backend = choose_backend(device.type, local_world)
        if device.type == "cuda":
            torch.cuda.set_device(local_rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), timeout=PROCESS_GROUP_TIMEOUT)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    init_groups(cfg)
    rank, n = world()
    cfg.RANK = rank
    cfg.LOCAL_RANK = local_rank if dist.is_initialized() else 0
    cfg.NUM_WORLDS = batch_device_count(cfg, n)
    return device
