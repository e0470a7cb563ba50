"""The process layout (counterpart of ``advise_tpu/parallel/mesh.py``): one
process per card, and one rank in the place of one device of the JAX
package's mesh, ``('data', 'sync')``, ``('data', 'sync', 'seq')`` under
TPU.MESH_SEQ, ``('data', 'sync', 'pipe')`` under TPU.MESH_PIPE and
``('data', 'model')`` under TPU.PARTITION_MODE 'auto'.

The JAX package runs one program over a mesh; the port runs one process a
card, the reference's own idiom, launched by ``torch.distributed.run``
(torchrun), which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``. Rank r stands for
the mesh device at the coordinates of r in the row-major order of the mesh's
axes (:func:`mesh_axes`), as ``devs.reshape(...)`` lays the devices out: the
innermost axis ('sync', or 'seq', 'pipe' or 'model' where there is one) runs
over adjacent ranks. The group over some axes holds the ranks that share
every other coordinate (:func:`axis_group`). The batch axes ``('data',
'sync')`` name the ranks that carry distinct batch shards: the group of
ranks that share this rank's 'seq', 'pipe' or 'model' coordinate (under
'auto' the 'data' axis alone). Batch gathers, stats and running statistics
average over it, BN statistics over the rank's sync group (the batch group
under BN.GLOBAL_SYNC, and under 'auto', where the JAX package's GSPMD
reduces over the whole batch). Gradients average over the world
(``WORLD_AXES``) in the shard_map layouts: seq and pipe ranks hold
replicated parameters, and their gradients agree only in their sum.

Without a process group there is one rank, world 1, and no collective:
every helper of ``parallel/collectives.py`` is then the identity. The
backend is chosen by rule, never by catching a failure: NCCL where each
rank has a card of its own, gloo on the CPU and where ranks share a card
(NCCL refuses two ranks on one device).

P2P peers (ring attention's and the pipeline's hand-offs) are global
ranks: :func:`axis_ranks` lists a group's members in the order of its
axis.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
SYNC_AXIS = "sync"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"
BATCH_AXES = (DATA_AXIS, SYNC_AXIS)
WORLD_AXES = ("world",)
# a collective that waits longer than this fails the run instead of hanging it
PROCESS_GROUP_TIMEOUT = datetime.timedelta(minutes=10)

# this process's groups, set by :func:`init_groups`: {axes: (group, size, index)}
_GROUPS: Dict[Tuple[str, ...], Tuple[Any, int, int]] = {}
# {axes: the global ranks of this process's group over them, in axis order}
_RANKS: Dict[Tuple[str, ...], List[int]] = {}
_LAYOUT: List[Any] = []  # the (axes, world) the groups were made for


def is_auto(cfg) -> bool:
    return getattr(cfg.TPU, "PARTITION_MODE", "shard_map") == "auto"


def axis_size(cfg, name: str) -> int:
    """TPU.MESH_SEQ, MESH_PIPE or MESH_MODEL, at least 1."""
    return max(int(getattr(cfg.TPU, f"MESH_{name.upper()}", 1) or 1), 1)


def mesh_shape(cfg, n_devices: int) -> Tuple[int, int]:
    """(data, sync) axis sizes for ``n_devices`` ranks: the sync axis is
    BN.NUM_SYNC_DEVICES (TPU.MESH_SYNC when > 0; all under BN.GLOBAL_SYNC),
    cut to the largest divisor of the count; TPU.MESH_DATA, when > 0, must
    agree. A MESH_SEQ or MESH_PIPE axis is carved off first."""
    n = n_devices
    seq = axis_size(cfg, SEQ_AXIS)
    if seq > 1:
        assert n % seq == 0, (n, seq)
        n = n // seq
    pipe = axis_size(cfg, PIPE_AXIS)
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
    if is_auto(cfg):
        rep = axis_size(cfg, MODEL_AXIS)
    else:
        rep = axis_size(cfg, SEQ_AXIS) * axis_size(cfg, PIPE_AXIS)
    assert n_devices % rep == 0, (n_devices, rep)
    return n_devices // rep


def mesh_axes(cfg, n_devices: int) -> Tuple[Tuple[str, int], ...]:
    """((axis, size), ...) of the JAX package's ``build_mesh`` for
    ``n_devices``, outermost first: ('data', 'model') under 'auto', else
    ('data', 'sync') with 'seq' or 'pipe' innermost when set (MESH_SEQ
    wins, as in JAX; the config rejects both)."""
    if is_auto(cfg):
        model = axis_size(cfg, MODEL_AXIS)
        assert n_devices % model == 0, (n_devices, model)
        return ((DATA_AXIS, n_devices // model), (MODEL_AXIS, model))
    data, sync = mesh_shape(cfg, n_devices)
    axes = ((DATA_AXIS, data), (SYNC_AXIS, sync))
    for name in (SEQ_AXIS, PIPE_AXIS):
        if axis_size(cfg, name) > 1:
            return axes + ((name, axis_size(cfg, name)),)
    return axes


def mesh_batch_axes(cfg) -> Tuple[str, ...]:
    """The mesh axes that carry the batch: 'data' plus 'sync' where there is
    one (JAX's ``mesh_batch_axes``)."""
    return (DATA_AXIS,) if is_auto(cfg) else BATCH_AXES


def layout_groups(cfg, n_devices: int) -> Dict[Tuple[str, ...], List[List[int]]]:
    """{axes: the partition of the ranks into the groups over those axes}:
    the batch axes, 'sync', and 'seq', 'pipe', 'model' where the mesh has
    them ('data' too under 'auto', FSDP's axis), each group listing its
    ranks in the order of its axes."""
    axes = mesh_axes(cfg, n_devices)
    names = [a for a, _ in axes]
    coords = np.indices([s for _, s in axes]).reshape(len(axes), -1).T  # rank -> coordinates

    def partition(over):
        keep = [i for i, a in enumerate(names) if a not in over]
        groups: Dict[tuple, List[int]] = {}
        for r, c in enumerate(coords):
            groups.setdefault(tuple(c[keep]), []).append(r)
        return list(groups.values())

    out = {BATCH_AXES: partition(mesh_batch_axes(cfg)),
           (SYNC_AXIS,): partition(mesh_batch_axes(cfg) if is_auto(cfg) or cfg.BN.GLOBAL_SYNC else (SYNC_AXIS,))}
    for name in names:
        if name in (SEQ_AXIS, PIPE_AXIS, MODEL_AXIS) or (name == DATA_AXIS and is_auto(cfg)):
            out[(name,)] = partition((name,))
    return out


def batch_index(cfg, rank: int, n_devices: int) -> Tuple[int, int]:
    """(rank's index among the ranks that carry distinct batches, their
    count): its place in its group over the batch axes."""
    for group in layout_groups(cfg, n_devices)[BATCH_AXES]:
        if rank in group:
            return group.index(rank), len(group)
    raise ValueError(f"rank {rank} is not among {n_devices}")


def local_batch_size(cfg, n_devices: int) -> int:
    """Each rank's share of the global batch DATA.BATCHSIZE_PER_GPU x
    ``n_devices``."""
    global_batch = cfg.DATA.BATCHSIZE_PER_GPU * n_devices
    assert global_batch % n_devices == 0
    return global_batch // n_devices


def sync_groups(cfg, n_devices: int) -> List[List[int]]:
    """The BN sync groups of ``n_devices`` ranks: contiguous runs of the
    sync axis's size, the rows of ``devs.reshape(data, sync)``, without a
    seq, pipe or model axis (with one, :func:`layout_groups`)."""
    _, sync = mesh_shape(cfg, n_devices)
    return [list(range(first, first + sync)) for first in range(0, n_devices, sync)]


def choose_backend(device_type: str, local_world: int) -> str:
    """gloo on the CPU and where the node's ranks outnumber its cards, else
    NCCL."""
    if device_type != "cuda" or local_world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_groups(cfg) -> None:
    """Create this process's groups over the initialized default group (one
    ``new_group`` a group of :func:`layout_groups` whose ranks are not the
    world's, all made in the same order on every rank; once a process and
    layout). Without a process group: none (world 1)."""
    if not dist.is_initialized():
        _GROUPS.clear()
        _RANKS.clear()
        _LAYOUT.clear()
        return
    world, rank = dist.get_world_size(), dist.get_rank()
    layout = (mesh_axes(cfg, world), world)
    if _LAYOUT == [layout]:
        return  # made by an earlier call of this process
    _GROUPS.clear()
    _RANKS.clear()
    made: Dict[Tuple[int, ...], Any] = {tuple(range(world)): dist.group.WORLD}
    for axes, partition in layout_groups(cfg, world).items():
        for ranks in partition:
            key = tuple(sorted(ranks))
            if key not in made:
                made[key] = dist.new_group(list(key))
            if rank in ranks:
                _GROUPS[axes] = (made[key], len(ranks), ranks.index(rank))
                _RANKS[axes] = list(ranks)
    _GROUPS[WORLD_AXES] = (dist.group.WORLD, world, rank)
    _RANKS[WORLD_AXES] = list(range(world))
    _LAYOUT[:] = [layout]
    logger.info("process groups: rank %d of %d, mesh %s (%s backend)", rank, world,
                dict(layout[0]), dist.get_backend())


def axis_group(axes) -> Optional[Tuple[Any, int, int]]:
    """(group, size, this rank's index) of the ranks spanning ``axes``, or
    None without a process group (or with no axes)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if not axes or not _GROUPS:
        return None
    if axes not in _GROUPS:
        if set(axes) <= {SEQ_AXIS, PIPE_AXIS, MODEL_AXIS}:
            return None  # an axis this layout does not have: size 1
        raise ValueError(f"no process group over the axes {axes}")
    return _GROUPS[axes]


def axis_ranks(axes) -> List[int]:
    """The global ranks of this rank's group over ``axes`` in axis order
    ([0] without a process group)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return _RANKS.get(axes, [0]) if _GROUPS else [0]


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
