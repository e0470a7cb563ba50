"""Batch normalization with per-split statistics synchronized over a group
of ranks (counterpart of ``advise_tpu/models/layers/norm.py`` SyncBatchNorm).

What it keeps from the JAX module:

- ``sync_axes`` (``parallel/mesh.py bn_axis_names``): in training the
  float32 mean and mean of squares of each split are averaged over the
  ranks of this rank's sync group (the world under BN.GLOBAL_SYNC), one
  all-reduce a forward, differentiable (``parallel/collectives.py pmean``),
  and the unbiased variance counts the group's elements. Without a process
  group, or with no axes, the statistics are the rank's own;
- the statistics in float32, and the normalize + affine as ONE per-channel
  FMA in the input dtype (``y = x * w + b`` with ``w = scale * rsqrt(var +
  eps)``, ``b = bias - mean * w``);
- torch momentum 0.1 and the unbiased variance in the running buffer;
- ``num_splits`` (SubBatchNorm): training statistics per contiguous slice
  of the batch, running statistics averaged over the slices.

Two differences of form, both forced by PyTorch:

- **Per-view BN.** The JAX step vmaps the two BYOL views, so each view's BN
  uses its own batch statistics and the running updates are averaged over
  views. The port runs the views as one ``[V*B, ...]`` batch and passes
  ``views=V``; the module then reduces over ``V * num_splits`` slices, which
  is the same normalization and the same averaged running update. Without
  it a concatenated batch would pool the views' statistics silently.
- **Running statistics move after the step's backward.** A forward in
  train mode does not touch the buffers: it records its batch statistics,
  and :func:`commit_bn_stats` folds the records into the running buffers in
  call order. A BN that the step calls twice (the AdViSe BYOL heads, once a
  view) thus moves twice, the second update on top of the first, as the
  JAX step threads its ``batch_stats`` through both applies. Under
  ``torch.utils.checkpoint`` (TPU.REMAT) the forward is recomputed inside
  the backward; a forward run there records nothing, so a recomputation
  never counts as a call; it issues its all-reduce again, in the same
  order on every rank, as JAX's remat does.

In training the module runs one ``torch.autograd.Function`` on both devices
(``ops/batch_norm.py``: its CUDA kernels on the card, their plain versions
on the CPU): the statistics, their average over the sync group, the fold;
the backward in closed form, ``dx = scale * r * (g - mean(g) - xh *
mean(g * xh))`` with the two means averaged over the group as SyncBN's
backward does (``pmean``'s backward did the same for the chain it
replaced). It saves x as it came and the float32 statistics, no float32
copy of x. The fold's w and b stay rounded to x's dtype; y is computed from
them in float32 and rounded once. On the card an input (or a gradient)
whose channel dim is not innermost in memory is first copied so
(``ops/batch_norm.py channels_last``, counted); on the CPU y keeps x's
layout.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch import nn

from advise_tpu_torch.ops import batch_norm as bn
from advise_tpu_torch.parallel.collectives import pmean, world_size
from advise_tpu_torch.parallel.mesh import BATCH_AXES, bn_axis_names, is_auto


class SyncBatchNorm(nn.Module):
    """BatchNorm over every dim but the channel dim (dim 1)."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5,
                 num_splits: int = 1, zero_init_scale: bool = False,
                 sync_axes: Tuple[str, ...] = ()):
        super().__init__()
        self.sync_axes = tuple(sync_axes)
        self.momentum = momentum
        self.eps = eps
        self.num_splits = num_splits
        self.zero_init_scale = zero_init_scale
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.pending = []  # (batch mean, unbiased batch var) of each forward, in call order
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(0.0 if self.zero_init_scale else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _fold(self, x, mean, var, shape):
        """The normalize + affine FMA; only the [C]-sized w/b round to x.dtype."""
        w, b = bn.fold(mean, var, self.weight, self.bias, self.eps, x.dtype)
        return x * w.view(shape) + b.view(shape)

    def forward(self, x: torch.Tensor, views: int = 1) -> torch.Tensor:
        c = x.shape[1]
        tail = (1,) * (x.ndim - 2)
        if not self.training:
            return self._fold(x, self.running_mean, self.running_var, (1, c) + tail)
        splits = views * self.num_splits
        if x.shape[0] % splits:
            raise ValueError(f"batch {x.shape[0]} does not split into {splits}")
        count = x.numel() // splits // c
        if self.sync_axes:
            count *= world_size(self.sync_axes)
        y, (mean, meansq) = _TrainNorm.apply(bn.channels_last(x), self.weight, self.bias, self.eps,
                                             splits, self.sync_axes)
        if not _in_backward():
            with torch.no_grad():
                var = meansq - torch.square(mean)
                unbiased = var.mean(0) * (count / max(count - 1, 1))
                self.pending.append((mean.mean(0), unbiased))
        return y


class _TrainNorm(torch.autograd.Function):
    """A train-mode BN of x [N, C, ...], channel dim innermost in memory:
    returns y and the float32 (mean, mean of squares) [2, splits, C] it
    normalized with (averaged over ``sync_axes``; not differentiable)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, splits, sync_axes):
        # mean and mean of squares in float32, as the JAX module reduces them
        stats = bn.bn_stats(x, splits)
        if sync_axes:
            stats = pmean(stats, sync_axes)
        y = bn.bn_apply(x, stats, weight, bias, eps)
        ctx.save_for_backward(x, stats, weight)
        ctx.eps, ctx.sync_axes = eps, sync_axes
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, gy, _):
        x, stats, weight = ctx.saved_tensors
        gy = bn.channels_last(gy)
        means, totals = bn.bn_grad_stats(gy, x, stats, ctx.eps)
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.sync_axes:
                means = pmean(means, ctx.sync_axes)
            dx = bn.bn_dx(gy, x, stats, means, weight, ctx.eps)
        return dx, totals[1].to(weight.dtype), totals[0].to(weight.dtype), None, None, None


def _in_backward() -> bool:
    """True while autograd runs a backward pass: where a checkpointed forward
    is recomputed."""
    return torch._C._current_graph_task_id() != -1


@torch.no_grad()
def commit_bn_stats(model: nn.Module) -> None:
    """Fold every BN's recorded batch statistics into its running buffers in
    call order (``new = (1 - m) * old + m * batch`` per record) and clear
    them."""
    for m in model.modules():
        if isinstance(m, SyncBatchNorm):
            for mean, var in m.pending:
                m.running_mean.mul_(1 - m.momentum).add_(m.momentum * mean)
                m.running_var.mul_(1 - m.momentum).add_(m.momentum * var)
            m.pending = []


def drop_bn_records(model: nn.Module) -> None:
    """Forget every BN's recorded batch statistics: a forward whose running
    statistics must not move (the kNN probe on batch statistics)."""
    for m in model.modules():
        if isinstance(m, SyncBatchNorm):
            m.pending = []


def head_sync_axes(norm, sync_mlp: bool) -> Tuple[str, ...]:
    """The sync axes of a contrastive head's BN: the norm's own when
    CONTRASTIVE.BN_SYNC_MLP (``sync_mlp``), else none; under
    TPU.PARTITION_MODE 'auto' always the batch's (GSPMD reduces every BN
    over the whole batch)."""
    if getattr(norm, "global_batch", False):
        return BATCH_AXES
    return tuple(getattr(norm, "keywords", {}).get("sync_axes", ())) if sync_mlp else ()


def get_norm(cfg):
    """Norm factory (``advise_tpu/models/layers/norm.py get_norm``):
    'sync_batchnorm' syncs over ``bn_axis_names(cfg)``, 'batchnorm' and
    'sub_batchnorm' over nothing; under TPU.PARTITION_MODE 'auto'
    'batchnorm' and 'sync_batchnorm' over the whole batch, the ranks of the
    'data' axis (the JAX step's BN reduces over the global batch GSPMD
    shards)."""
    if is_auto(cfg) and cfg.BN.NORM_TYPE in ("batchnorm", "sync_batchnorm"):
        norm = functools.partial(SyncBatchNorm, sync_axes=BATCH_AXES)
        norm.global_batch = True
        return norm
    if cfg.BN.NORM_TYPE == "batchnorm":
        return functools.partial(SyncBatchNorm, sync_axes=())
    if cfg.BN.NORM_TYPE == "sync_batchnorm":
        return functools.partial(SyncBatchNorm, sync_axes=bn_axis_names(cfg))
    if cfg.BN.NORM_TYPE == "sub_batchnorm":
        return functools.partial(SyncBatchNorm, num_splits=cfg.BN.NUM_SPLITS)
    raise NotImplementedError(f"BN.NORM_TYPE={cfg.BN.NORM_TYPE}")
