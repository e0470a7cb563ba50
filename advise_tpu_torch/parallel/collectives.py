"""Collectives of the data-parallel steps (counterpart of
``advise_tpu/parallel/collectives.py``) over the groups of
``parallel/mesh.py``: ``axes`` names mesh axes, ``('data', 'sync')`` (the
default) the world, ``'sync'`` this rank's BN sync group. Without a process
group every helper is the identity (world 1, index 0).

| JAX                                  | here                                   |
|--------------------------------------|----------------------------------------|
| ``pmean``/``psum`` of a pytree       | one all-reduce over each dtype's flat   |
|                                      | bucket (:func:`pmean_tree`)            |
| ``lax.all_gather(tiled)``            | :func:`all_gather_cat`: all-gather as a |
|                                      | list, concatenated in rank order; its  |
|                                      | backward all-reduces the cotangent and |
|                                      | keeps this rank's rows (the transpose  |
|                                      | JAX takes, a reduce-scatter)           |
| ``psum`` inside a differentiated fn  | :func:`psum` (its backward a psum)     |
| shuffle-BN's shared key              | a permutation every rank of the group  |
|                                      | draws from an identically seeded       |
|                                      | generator: nothing is broadcast        |
| ``lax.ppermute`` (a ring shift)      | :func:`ppermute`: ``batch_isend_irecv``|
|                                      | under NCCL and on the CPU; an          |
|                                      | all-gather under gloo on CUDA tensors  |
|                                      | (gloo's P2P hands the device pointer to|
|                                      | its TCP socket and fails); its backward|
|                                      | the reverse shift                      |
| GSPMD's all-reduce after a row-      | :func:`reduce_from`: all-reduce ahead, |
| parallel layer, and its transpose    | identity back; :func:`copy_to`: the    |
|                                      | converse, at a column-parallel input   |

Besides P2P on the CPU and NCCL, only all-reduce, all-gather (as a list),
broadcast and barrier are used: the collectives gloo takes on CUDA tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from advise_tpu_torch.parallel.mesh import BATCH_AXES, SYNC_AXIS, WORLD_AXES, axis_group, axis_ranks


def world_size(axes=BATCH_AXES) -> int:
    g = axis_group(axes)
    return 1 if g is None else g[1]


def replica_index(axes=BATCH_AXES) -> int:
    """This rank's index within the ranks spanning ``axes`` (rank order)."""
    g = axis_group(axes)
    return 0 if g is None else g[2]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def psum(x: torch.Tensor, axes=BATCH_AXES) -> torch.Tensor:
    """The sum of ``x`` over the ranks spanning ``axes``, differentiable:
    the gradient is the sum of the ranks' cotangents, as JAX's psum
    transposes."""
    g = axis_group(axes)
    return x if g is None else _AllReduceSum.apply(x, g[0])


def pmean(x: torch.Tensor, axes=BATCH_AXES) -> torch.Tensor:
    g = axis_group(axes)
    return x if g is None else _AllReduceSum.apply(x, g[0]) / g[1]


def _reduce_tensors(tensors: Sequence[torch.Tensor], axes, mean: bool):
    g = axis_group(axes)
    if g is None or not tensors:
        return list(tensors)
    group, size, _ = g
    out = list(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        if mean:
            flat = flat / size
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out


def pmean_tree(tree: Dict[str, torch.Tensor], axes=BATCH_AXES) -> Dict[str, torch.Tensor]:
    """{name: the tensor's mean over the ranks}: one all-reduce per dtype
    over the tensors flattened into one bucket (no gradient)."""
    return dict(zip(tree, _reduce_tensors(list(tree.values()), axes, mean=True)))


def psum_tree(tree: Dict[str, torch.Tensor], axes=BATCH_AXES) -> Dict[str, torch.Tensor]:
    return dict(zip(tree, _reduce_tensors(list(tree.values()), axes, mean=False)))


@torch.no_grad()
def pmean_(tensors: Sequence[torch.Tensor], axes=BATCH_AXES) -> None:
    """In place: each of ``tensors`` (buffers) set to its mean over the ranks."""
    if axis_group(axes) is None:
        return
    for t, m in zip(tensors, _reduce_tensors(list(tensors), axes, mean=True)):
        t.copy_(m)


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.index, ctx.rows = group, index, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None, None


def all_gather_cat(x: torch.Tensor, axes=BATCH_AXES) -> torch.Tensor:
    """Every rank's ``x`` [n, ...] over ``axes``, concatenated on dim 0 in
    rank order ([size * n, ...]); differentiable."""
    g = axis_group(axes)
    if g is None:
        return x
    return _GatherCat.apply(x, *g)


def batch_shuffle(x: torch.Tensor, generator: Optional[torch.Generator], axes=SYNC_AXIS,
                  perm: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoCo's shuffle-BN: ``x`` [n, ...] of every rank over ``axes``
    gathered, put in the order of ``perm`` (drawn from ``generator``, on its
    device, when not given: a generator seeded alike on every rank of the
    group, so every rank draws the same permutation), and this rank's n rows
    of it; returns them and the permutation that :func:`batch_unshuffle`
    undoes. Without a process group the rank's own batch is permuted."""
    gathered = all_gather_cat(x, axes)
    if perm is None:
        if generator is None:
            raise ValueError("shuffle-BN needs a torch.Generator")
        perm = torch.randperm(gathered.shape[0], generator=generator, device=generator.device)
    perm = perm.to(x.device)
    my = replica_index(axes)
    n = x.shape[0]
    return gathered[perm[my * n:(my + 1) * n]], perm


def batch_unshuffle(x: torch.Tensor, perm: torch.Tensor, axes=SYNC_AXIS) -> torch.Tensor:
    """Undo :func:`batch_shuffle`: this rank's rows of the group's batch in
    its original order."""
    gathered = all_gather_cat(x, axes)
    my = replica_index(axes)
    n = x.shape[0]
    return gathered[torch.argsort(perm)[my * n:(my + 1) * n]]


def check_same_on_every_rank(digest: str, device, what: str) -> None:
    """Raise unless every rank of the world holds the same sha256 hex
    ``digest``."""
    g = axis_group(WORLD_AXES)
    if g is None:
        return
    mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.int64, device=device)
    parts = [torch.empty_like(mine) for _ in range(g[1])]
    dist.all_gather(parts, mine, group=g[0])
    differ = [r for r, p in enumerate(parts) if not torch.equal(p, mine)]
    if differ:
        raise RuntimeError(f"{what} differs between rank {g[2]} and ranks {differ}")


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _p2p_takes(x: torch.Tensor) -> bool:
    """Whether the backend's P2P takes ``x``: NCCL, and gloo on CPU tensors."""
    return x.device.type == "cpu" or dist.get_backend() == "nccl"


def shift(x: torch.Tensor, axes, offset: int = 1) -> torch.Tensor:
    """``x`` of the rank ``offset`` places before this one in the group over
    ``axes`` (ring order): each rank's ``x`` goes ``offset`` places on, as
    ``lax.ppermute`` with ``perm = [(j, (j + offset) % n)]``. No gradient."""
    g = axis_group(axes)
    if g is None or g[1] == 1:
        return x
    group, size, index = g
    ranks = axis_ranks(axes)
    x = x.contiguous()
    if _p2p_takes(x):
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, ranks[(index + offset) % size], group),
               dist.P2POp(dist.irecv, out, ranks[(index - offset) % size], group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return parts[(index - offset) % size]


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, offset):
        ctx.axes, ctx.offset = axes, offset
        return shift(x, axes, offset)

    @staticmethod
    def backward(ctx, grad):
        return shift(grad, ctx.axes, -ctx.offset), None, None


def ppermute(x: torch.Tensor, axes, offset: int = 1) -> torch.Tensor:
    """:func:`shift`, differentiable: the cotangent travels back the other
    way, as JAX transposes ``ppermute``."""
    if axis_group(axes) is None:
        return x
    return _Shift.apply(x, axes, offset)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def reduce_from(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``axes``, its cotangent passed back
    as it is: the all-reduce after a row-parallel layer, whose output every
    rank of the group then uses alike."""
    g = axis_group(axes)
    return x if g is None or g[1] == 1 else _ReduceFrom.apply(x, g[0])


def copy_to(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` as it is, its cotangent summed over ``axes``: where a tensor
    every rank of the group holds alike enters work split over the group (a
    column-parallel layer's input, a weight shared by the heads a rank
    holds)."""
    g = axis_group(axes)
    return x if g is None or g[1] == 1 else _CopyTo.apply(x, g[0])


def all_gather_dim(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """:func:`all_gather_cat` along ``dim``: every rank's ``x`` over
    ``axes`` concatenated there in rank order (``all_gather(tiled=True)``),
    its backward the sum of the cotangents, this rank's part kept."""
    if axis_group(axes) is None:
        return x
    return all_gather_cat(x.movedim(dim, 0), axes).movedim(0, dim)
