"""GPipe over the 'pipe' axis (counterpart of ``advise_tpu/parallel/pipeline.py``):
the reversible MViT's uniform segments, stage ``s`` of ``P`` running blocks
``[s L / P, (s + 1) L / P)`` while microbatches stream from stage to stage.

As in the JAX package, parameters and the batch are replicated along
'pipe', and each stage takes its block range of the replicated stack
(:func:`stage_slice`). The schedule is ``M + P - 1`` ticks: stage 0 takes
microbatch ``t`` while ``t < M``; every stage runs its blocks on what it
holds every tick, the fill and drain ticks included, as JAX's ``lax.scan``
does; the result goes to the next stage (``parallel/collectives.py
ppermute``, JAX's ``ppermute``); the last stage keeps the finished
microbatches, and a masked sum over 'pipe' hands the segment's output to
every stage.

Gradients: autograd through the hand-offs and the sum gives the right
totals spread unevenly over the stages (the input's cotangent lands on
stage 0, each stage holds its own blocks' gradients).
:func:`sync_cotangents`, the identity whose backward sums the cotangents
over 'pipe', takes every input of the region, so the gradients leave it
replicated; the sum's transpose is another sum, so the output's cotangent
is scaled by ``1 / P`` first (:func:`scale_bwd`).

Every rank builds the same autograd graph: stage 0's choice between its
microbatch and what it received, and the last stage's choice of what to
keep, are ``torch.where`` on a flag (JAX's ``jnp.where``), never a Python
branch, so each collective of the backward runs on every stage in the same
order.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from advise_tpu_torch.parallel.collectives import ppermute, psum, psum_tree, replica_index
from advise_tpu_torch.parallel.mesh import PIPE_AXIS, axis_group

Tensors = Tuple[torch.Tensor, ...]


class _SyncCotangents(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axes, *tensors):
        ctx.axes = axes
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        summed = psum_tree({str(i): g.contiguous() for i, g in enumerate(grads)}, ctx.axes)
        return (None, *summed.values())


def sync_cotangents(tensors: Sequence[torch.Tensor], axes=PIPE_AXIS) -> List[torch.Tensor]:
    """``tensors`` as they are; backward, each cotangent summed over
    ``axes`` (one all-reduce a dtype), an unused output's counting as
    zeros."""
    if axis_group(axes) is None:
        return list(tensors)
    return list(_SyncCotangents.apply(axes, *tensors))


class _ScaleBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad * torch.as_tensor(ctx.factor, dtype=grad.dtype)).to(grad.dtype), None


def scale_bwd(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Identity forward; the cotangent times ``factor`` backward."""
    return _ScaleBwd.apply(x, factor)


def stage_slice(items: Sequence, n_stage: int, axes=PIPE_AXIS) -> Tuple[int, int]:
    """(first, end) of this stage's contiguous range of ``len(items)``
    blocks, which ``n_stage`` must divide."""
    total = len(items)
    assert total % n_stage == 0, f"stacked length {total} not divisible by pipe={n_stage}"
    local = total // n_stage
    s = replica_index(axes)
    return s * local, (s + 1) * local


def resolve_microbatches(n_micro: int, rows: int, pipe: int) -> int:
    """``n_micro`` (TPU.PIPE_MICROBATCH), or when 0 the smallest divisor of
    ``rows`` no smaller than ``pipe`` (every stage fills), else its largest
    divisor."""
    if n_micro > 0:
        return n_micro
    divs = [d for d in range(1, rows + 1) if rows % d == 0]
    at_least = [d for d in divs if d >= pipe]
    return at_least[0] if at_least else divs[-1]


def gpipe(stage_fn: Callable[[Tensors, int], Tensors], xs: Sequence[torch.Tensor], *, n_stage: int,
          n_micro: int, axes=PIPE_AXIS) -> Tensors:
    """Stream ``n_micro`` microbatches of ``xs`` (tensors sharing their
    leading batch dim, replicated along ``axes``) through ``n_stage``
    stages, each applying ``stage_fn(microbatch, m)`` (shape-preserving),
    ``m`` the index of the microbatch the stage holds, which stochastic
    layers fold into their draws. Returns the whole batch's output,
    replicated along ``axes``; differentiable (pair with
    :func:`sync_cotangents` on the inputs)."""
    assert n_stage > 1, "gpipe needs n_stage > 1 (use stage_fn directly)"
    s = replica_index(axes)
    b = xs[0].shape[0]
    assert b % n_micro == 0, (
        f"pipeline microbatching: batch {b} not divisible by TPU.PIPE_MICROBATCH={n_micro}")
    bm = b // n_micro
    micro = [tuple(x[m * bm:(m + 1) * bm] for x in xs) for m in range(n_micro)]
    cur: Tensors = tuple(torch.zeros_like(x[:bm]) for x in xs)
    n_tick = n_micro + n_stage - 1
    done: List[Tensors] = []
    for t in range(n_tick):
        inject = torch.tensor(s == 0 and t < n_micro, device=xs[0].device)
        cur = tuple(torch.where(inject, a, c) for a, c in zip(micro[min(t, n_micro - 1)], cur))
        y = stage_fn(cur, min(max(t - s, 0), n_micro - 1))
        if t >= n_stage - 1:
            done.append(y)  # the last stage's microbatch t - (P - 1)
        if t < n_tick - 1:
            cur = tuple(ppermute(a, axes) for a in y)
    last = torch.tensor(s == n_stage - 1, device=xs[0].device)
    out = []
    for parts in zip(*done):
        acc = torch.cat(parts)
        out.append(scale_bwd(psum(torch.where(last, acc, torch.zeros_like(acc)), axes), 1.0 / n_stage))
    return tuple(out)
