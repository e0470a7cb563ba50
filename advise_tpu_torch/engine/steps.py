"""The train and eval steps (counterpart of ``advise_tpu/engine/steps.py``)
on one device: the contrastive step, the task step (TASK speed and
action_recog; MaskMViT's masked step), the AdViSe step and the eval step of
speed_val and inference.

Order inside the contrastive step, as in the JAX package: augmentation ->
cast to TPU.COMPUTE_DTYPE -> EMA update (BYOL, MoCo) -> the algorithm's loss
(BYOL: online views with per-view BN, momentum-encoder keys, kNN scatter;
MoCo: the online view 0, shuffle-BN keys of the other views, the queue's
negatives, the queue update, kNN scatter; SimCLR: NT-Xent over two views;
SwAV: prototype scores, Sinkhorn codes and the feature queue; mem: the
memory bank's NCE and its momentum update) -> backward -> BN running
statistics committed once -> global grad norm -> the optimizer's direction
-> parameters updated. With CONTRASTIVE.SEQUENTIAL the loss and backward
run per clip (:func:`advise_tpu_torch.engine.contrastive.sequential_contrastive_grads`).
The task step: augmentation -> cast -> forward (all B*K clips as one
batch, head dropout; with TRAIN.SEQUENTIAL one clip of each video at a
time, the gradients summed and divided by K) -> task loss -> backward -> BN
commit -> global grad norm -> the optimizer's direction -> update;
MaskMViT's task step runs
the masked MSE over the pretrain depths plus, with MASK.JOINT_CONTRASTIVE,
the NT-Xent between the two views' projections, then AdamW. The AdViSe
step (TemporalModel): augmentation -> cast -> the BYOL twins' EMA update
from the pre-step parameters -> the tower's tokens (no gradient unless
TM.FROM_SCRATCH) -> temporal head -> speed CE and/or BYOL against the twins
-> backward (zeros for the frozen tower) -> BN commit -> global grad norm ->
the optimizer's direction -> update. The steps run eagerly and update
``state`` in place.

Each rank runs the step on its share of the global batch with the JAX
step's collectives (``parallel/collectives.py``; identities without a
process group): SyncBatchNorm's statistics over the sync group inside the
forwards; after the backward the gradients and the stats averaged over the
world (one all-reduce a dtype, :func:`average_over_world`), and after the BN
commit the running statistics of the model (and of the momentum encoder)
averaged too, so that weights, buffers and SSL state stay the same on every
rank. Each rank draws its own augmentation and dropout from its own
generator.

The model-parallel layouts (``parallel/mesh.py``): ranks that differ in
'seq' or 'pipe' hold the same batch and parameters, and their gradients
agree only in their mean, so gradients average over the world; under
TPU.PARTITION_MODE 'auto' (``parallel/auto_shard.py``) the step first
gathers the FSDP parameters of the model (and momentum encoder), averages
the gradients over the 'data' ranks, keeps each FSDP gradient's slice and
releases the whole parameters before the optimizer updates the slices
(:func:`finish_step`), and the eval and kNN-probe forwards gather and
release alike. JAX's auto step rejects TRAIN.SEQUENTIAL and
CONTRASTIVE.SEQUENTIAL; so does this one.

Every train step runs in the spans of ``utils/host_times.py HOST_TIMES``:
``step`` around one call (its step id ``state.step``), and inside it
``step.aug`` (the device aug), ``step.forward`` (the forward and the loss
under autocast; one per clip on the sequential paths, and one for the
momentum keys under CONTRASTIVE.SEQUENTIAL), ``step.backward`` (the autograd
call, any recompute inside it), ``step.bn_commit`` and ``step.optimizer``
(:func:`finish_step`). What none of them covers (the cast, the EMA updates,
the FSDP gather) is the root's own time.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.engine.contrastive import (
    CONTRASTIVE_LOSSES,
    loss_grads,
    momentum_at,
    per_clip_grads,
    sequential_contrastive_grads,
    update_ema,
)
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.models import compute_dtype as cfg_compute_dtype
from advise_tpu_torch.models import losses as L
from advise_tpu_torch.models.layers.norm import SyncBatchNorm, commit_bn_stats, drop_bn_records
from advise_tpu_torch.parallel.auto_shard import gather_step, grads_axes, layout_of
from advise_tpu_torch.parallel.collectives import all_gather_cat, pmean, pmean_, pmean_tree
from advise_tpu_torch.parallel.mesh import BATCH_AXES, WORLD_AXES, is_auto
from advise_tpu_torch.solver.optimizer import (
    OptimizerBundle,
    apply_direction,
    global_grad_norm,
)
from advise_tpu_torch.utils.host_times import HOST_TIMES


def average_over_world(grads: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
                       *models: nn.Module, grad_axes=BATCH_AXES
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The gradients averaged over ``grad_axes`` and the stats over the
    batch's ranks, and in place every SyncBatchNorm running buffer of
    ``models`` over the world (called after the BN commit; ranks that hold
    the same batch hold the same buffers): the JAX step's ``pmean`` of
    grads, stats and batch_stats."""
    buffers = [b for model in models for m in model.modules() if isinstance(m, SyncBatchNorm)
               for b in (m.running_mean, m.running_var)]
    pmean_(buffers, WORLD_AXES)
    return pmean_tree(grads, grad_axes), pmean_tree(stats)


def check_auto(cfg) -> None:
    """JAX's auto step's assertions (``advise_tpu/engine/steps.py:328-335``)."""
    if not is_auto(cfg):
        return
    assert not cfg.TRAIN.SEQUENTIAL, (
        "TRAIN.SEQUENTIAL clip micro-batching is a shard_map-path memory lever; use TPU.REMAT / "
        "TPU.FSDP in auto mode")
    assert not cfg.CONTRASTIVE.SEQUENTIAL, (
        "CONTRASTIVE.SEQUENTIAL is a shard_map-path memory lever; use TPU.REMAT / TPU.FSDP in auto mode")


def finish_step(cfg, state: TrainState, bundle: OptimizerBundle, grads: Dict[str, torch.Tensor],
                stats: Dict[str, torch.Tensor], lr: float, *models: nn.Module) -> Dict[str, torch.Tensor]:
    """The steps' common end, after the BN commit: gradients, stats and BN
    buffers averaged (:func:`average_over_world`); under 'auto' each FSDP
    gradient cut to its slice and every gathered parameter released; the
    global gradient norm, the optimizer's direction and the update of
    ``state.model``'s parameters; the step counted. The span
    ``step.optimizer``."""
    with HOST_TIMES("step.optimizer"):
        grads, stats = average_over_world(grads, stats, *models, grad_axes=grads_axes(cfg))
        layout = layout_of(state.model)
        if layout is not None:
            grads = layout.shard_grads(grads)
        for model in models:
            if layout_of(model) is not None:
                layout_of(model).release()
        params = dict(state.model.named_parameters())
        stats["grad_norm"] = global_grad_norm(grads, getattr(bundle.tx, "reduce_sq", None))
        direction, state.opt_state = bundle.tx.update(grads, state.opt_state, params)
        apply_direction(params, direction, lr, bundle.lr_scales)
        state.step += 1
    return stats


def spanned(step: Callable) -> Callable:
    """``step(state, ...)`` inside the root span ``step``, whose step id is
    ``state.step`` before the call: the spans of one call share it
    (``utils/host_times.py``)."""

    @functools.wraps(step)
    def run(state: TrainState, *args, **kwargs):
        with HOST_TIMES("step", step=state.step):
            return step(state, *args, **kwargs)

    return run


def augment(device_aug: Optional[Callable], clips_u8: torch.Tensor, generator: Optional[torch.Generator],
            dtype: torch.dtype) -> torch.Tensor:
    """The train steps' clips: ``device_aug`` in the span ``step.aug`` (the
    clips as they are without it), cast to ``dtype``."""
    if device_aug is None:
        return clips_u8.to(dtype)
    with HOST_TIMES("step.aug"):
        clips = device_aug(clips_u8, generator)
    return clips.to(dtype)


def commit_bn(*models: nn.Module) -> None:
    """:func:`commit_bn_stats` of each model, in the span ``step.bn_commit``."""
    with HOST_TIMES("step.bn_commit"):
        for model in models:
            commit_bn_stats(model)


def make_contrastive_train_step(cfg, bundle: OptimizerBundle,
                                device_aug: Optional[Callable]):
    """Returns ``step(state, clips_u8, infos, generator, lr, epoch_exact,
    shared=None) -> stats``: ``clips_u8`` [B, K, T, H, W, 3] uint8 at ingest
    geometry (or already-augmented float clips when ``device_aug`` is
    None), ``infos`` with ``item_id`` [B] (and for mem ``time_idx`` [B]),
    ``generator`` drawing the augmentation on the clips' device and then
    the dropout masks, MoCo's shuffle-BN permutations (``shared``, a
    generator seeded alike on every rank, draws them instead when given)
    and mem's random rows. ``epoch_exact`` sets the momentum and opens
    SwAV's queue."""
    ctype = cfg.CONTRASTIVE.TYPE
    if ctype not in CONTRASTIVE_LOSSES:
        raise KeyError(f"CONTRASTIVE.TYPE={ctype!r}: one of {sorted(CONTRASTIVE_LOSSES)}")
    sequential = bool(cfg.CONTRASTIVE.SEQUENTIAL)
    if sequential and ctype not in ("byol", "moco"):
        raise ValueError(f"CONTRASTIVE.SEQUENTIAL supports byol and moco only, not {ctype!r}")
    algo = CONTRASTIVE_LOSSES[ctype]
    dtype = cfg_compute_dtype(cfg)
    check_auto(cfg)

    def step(state: TrainState, clips_u8: torch.Tensor, infos: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator], lr: float,
             epoch_exact: float, shared: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        gather_step(model, state.ssl.get("ema_model"))
        clips = augment(device_aug, clips_u8, generator, dtype)
        views = clips.transpose(0, 1)  # [K, B, T, H, W, C], view-major
        ssl = state.ssl
        if "ema_model" in ssl:
            ssl["ema_model"].train()
            update_ema(ssl, model, momentum_at(cfg, epoch_exact))
        infos = dict(infos, epoch_exact=epoch_exact)
        if shared is not None:
            infos["shared_generator"] = shared
        params = dict(model.named_parameters())
        with torch.autocast(clips.device.type, dtype=dtype, enabled=dtype != torch.float32):
            if sequential:
                grads, ssl, stats = sequential_contrastive_grads(cfg, model, ssl, views, infos, generator)
            else:
                with HOST_TIMES("step.forward"):
                    loss, ssl, stats = algo(cfg, model, ssl, views, infos, generator)
        if not sequential:
            with HOST_TIMES("step.backward"):
                grads = loss_grads(loss, params)
        ema = [ssl["ema_model"]] if "ema_model" in ssl else []
        commit_bn(model, *ema)
        state.ssl = ssl
        return finish_step(cfg, state, bundle, grads, stats, lr, model, *ema)

    return spanned(step)


def speed_task_loss(cfg, model: nn.Module, clips: torch.Tensor,
                    infos: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Speed-pretext loss: clips [B, K, T, H, W, C] run as one [B*K] batch,
    speed labels ``infos['spd_label']`` [B, K]. One statistic per (SSL.STAT,
    SSL.METRIC) pair, keyed by the STAT name; the loss is the one named
    ``loss_spd``. ``generator`` draws the head's dropout mask."""
    b, k = clips.shape[:2]
    labels = infos["spd_label"].reshape(b * k).long()
    logits = model(clips.reshape(b * k, *clips.shape[2:]), generator=generator)
    stats: Dict[str, torch.Tensor] = {}
    for stat, met in zip(cfg.SSL.STAT, cfg.SSL.METRIC):
        if met == "ce":
            if cfg.SSL.SMOOTHING > 0:
                c = logits.shape[-1]
                soft = F.one_hot(labels, c).float() * (1.0 - cfg.SSL.SMOOTHING) + cfg.SSL.SMOOTHING / c
                stats[stat] = L.soft_cross_entropy(logits, soft)
            else:
                stats[stat] = L.cross_entropy(logits, labels)
        elif met in ("bce_logit", "smoothing_bce_logit"):
            onehot = F.one_hot(labels, logits.shape[-1]).float()
            smoothing = cfg.SSL.SMOOTHING if met == "smoothing_bce_logit" else 0.0
            stats[stat] = L.bce_logit(logits, onehot, smoothing=smoothing)
        elif met == "margin":
            stats[stat] = L.margin_ranking_intra(
                logits.reshape(b, k, -1), infos["spd_label"].reshape(b, k), cfg.SSL.MARGIN)
        elif met == "acc@1":
            stats[stat] = L.top_k_accuracy(logits, labels, k=1)
        elif met == "acc@5":
            stats[stat] = L.top_k_accuracy(logits, labels, k=5)
        else:
            raise NotImplementedError(f"SSL.METRIC={met!r} for TASK=speed")
    return stats["loss_spd"], stats


def masked_task_loss(cfg, model: nn.Module, clips: torch.Tensor,
                     infos: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The masked loss (MaskFeat or MAE): the weighted masked MSE over
    MASK.PRETRAIN_DEPTH, with the loader's block masks ``infos['mask']`` [B,
    K, t, h, w] when the loader draws them (MASK.MAE_RND_MASK False), else
    the model's random masks; with MASK.JOINT_CONTRASTIVE plus JOINT_WEIGHT
    times the NT-Xent between the l2-normalized projections of views 0 and 1
    (temperature CONTRASTIVE.T, negatives: every other projection of the
    world's batch, gathered with their gradient; with one video in all the
    only other projection is the positive, and the term is identically 0);
    under VIS_MASK the model's videos are
    dropped. ``generator`` draws the random masks, then the drop-path
    masks."""
    from advise_tpu_torch.engine.contrastive import l2_normalize
    from advise_tpu_torch.models.masked import masked_mse

    b, k = clips.shape[:2]
    loader_mask = infos.get("mask")
    if loader_mask is not None:
        loader_mask = loader_mask.reshape(b * k, -1)
    out = model(clips.reshape(b * k, *clips.shape[2:]), loader_mask=loader_mask, generator=generator)
    joint = cfg.MASK.JOINT_CONTRASTIVE
    preds, labels, masks, weights = out[:4]
    loss = 0.0
    axes = BATCH_AXES if is_auto(cfg) else None  # JAX's auto step counts the whole batch's tokens
    for p, lab, m, w in zip(preds, labels, masks, weights):
        loss = loss + w * masked_mse(p, lab, m, axes)
    stats = {"loss_mask": loss}
    if joint:
        if k < 2:
            raise ValueError("MASK.JOINT_CONTRASTIVE needs DATA.NUM_CLIP >= 2")
        proj = out[4].reshape(b, k, -1)
        with torch.autocast(clips.device.type, enabled=False):  # float32, as JAX casts
            q1 = all_gather_cat(l2_normalize(proj[:, 0].float()))
            q2 = all_gather_cat(l2_normalize(proj[:, 1].float()))
            t = cfg.CONTRASTIVE.T
            cat = torch.cat([q1, q2], dim=0)
            sim = torch.exp(cat @ cat.T / t)
            off_diag = 1.0 - torch.eye(sim.shape[0], dtype=sim.dtype, device=sim.device)
            denom = torch.sum(sim * off_diag, dim=-1)
            pos = torch.exp(torch.sum(q1 * q2, dim=-1) / t)
            pos = torch.cat([pos, pos], dim=0)
            loss_nce = (-torch.log(pos / denom)).mean()
        loss = loss + cfg.MASK.JOINT_WEIGHT * loss_nce
        stats = {"loss_mask": stats["loss_mask"], "loss_nce": loss_nce, "loss_total": loss}
    return loss, stats


def action_task_loss(cfg, model: nn.Module, clips: torch.Tensor,
                     infos: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Action recognition and the linear probe: clips [B, K, T, H, W, C] run
    as one [B*K] batch against ``infos['cls_id']`` [B] repeated over the K
    clips of a video; CE, plus acc@1 and acc@5. ``generator`` draws the
    head's dropout mask."""
    b, k = clips.shape[:2]
    labels = torch.repeat_interleave(infos["cls_id"].reshape(b).long(), k)
    logits = model(clips.reshape(b * k, *clips.shape[2:]), generator=generator)
    loss = L.cross_entropy(logits, labels)
    return loss, {"loss_cls": loss, "acc@1": L.top_k_accuracy(logits, labels, 1),
                  "acc@5": L.top_k_accuracy(logits, labels, 5)}


TASK_LOSSES = {"speed": speed_task_loss, "action_recog": action_task_loss,
               "masked": masked_task_loss}


def make_task_train_step(cfg, bundle: OptimizerBundle, device_aug: Optional[Callable]):
    """Returns ``step(state, clips_u8, infos, generator, lr) -> stats`` for
    cfg.TASK (MaskMViT: the masked loss, whatever TASK says): ``clips_u8``
    [B, K, T, H, W, 3] uint8 at ingest geometry (or already-augmented float
    clips when ``device_aug`` is None), ``generator`` drawing the
    augmentation and then the dropout mask on the clips' device (the masked
    step: the drop-path masks). ``state.ssl`` stays {}.

    TRAIN.SEQUENTIAL with K > 1 (``advise_tpu/engine/steps.py``'s scan):
    the augmentation runs once, then clip i of every video [B, 1, ...] goes
    through the loss and its backward alone, with the [B, K, ...] infos
    sliced to [B, 1, ...]; the gradients are summed and divided by K, the
    BN running statistics chain from clip to clip, every clip draws the same
    dropout masks (JAX reuses one key), and each statistic is its mean over
    the clips."""
    task = "masked" if cfg.MODEL.MODEL_NAME == "MaskMViT" else cfg.TASK
    if task not in TASK_LOSSES:
        raise NotImplementedError(f"TASK={task} train step is not ported yet")
    task_loss = TASK_LOSSES[task]
    dtype = cfg_compute_dtype(cfg)
    autocast = dtype != torch.float32
    check_auto(cfg)

    def loss_and_grads(model, clips, infos, generator):
        params = dict(model.named_parameters())
        with HOST_TIMES("step.forward"), torch.autocast(clips.device.type, dtype=dtype, enabled=autocast):
            loss, stats = task_loss(cfg, model, clips, infos, generator)
        with HOST_TIMES("step.backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
        return dict(zip(params, grads)), {name: v.detach() for name, v in stats.items()}

    def sequential_grads(model, clips, infos, generator):
        k = clips.shape[1]

        def clip_grads(i):
            infos_i = {name: v[:, i:i + 1] if v.ndim >= 2 else v for name, v in infos.items()}
            return loss_and_grads(model, clips[:, i:i + 1], infos_i, generator)

        grads, per_clip = per_clip_grads(k, generator, clip_grads)
        stats = {name: torch.stack([st[name].float() for st in per_clip]).mean() for name in per_clip[0]}
        return {n: g / k for n, g in grads.items()}, stats

    def step(state: TrainState, clips_u8: torch.Tensor, infos: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator], lr: float) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        gather_step(model)
        clips = augment(device_aug, clips_u8, generator, dtype)
        if cfg.TRAIN.SEQUENTIAL and clips.shape[1] > 1:
            grads, stats = sequential_grads(model, clips, infos, generator)
        else:
            grads, stats = loss_and_grads(model, clips, infos, generator)
        commit_bn(model)
        return finish_step(cfg, state, bundle, grads, stats, lr, model)

    return spanned(step)


# the AdViSe BYOL twins: state.ssl key -> the TemporalModel submodule they copy
_TWINS = {"ema_temporal": "temporal_encoder", "ema_projector": "head_projector"}


def init_tmodeling_ssl(cfg, model: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """The AdViSe BYOL twins (``advise_tpu/engine/steps.py init_tmodeling_ssl``):
    copies of the temporal encoder's and the projector's parameters,
    {name: tensor} relative to each module; {} without BYOL in SSL.TASK."""
    if "byol" not in cfg.SSL.TASK:
        return {}
    if cfg.TM.SKIP_TM:
        raise ValueError("the BYOL twins need a temporal encoder (TM.SKIP_TM is set)")
    return {twin: {n: p.detach().clone() for n, p in getattr(model, name).named_parameters()}
            for twin, name in _TWINS.items()}


@torch.no_grad()
def update_tmodeling_ema(cfg, ssl: Dict[str, Dict[str, torch.Tensor]], model: nn.Module) -> None:
    """In place: twin = twin * m + online * (1 - m), m = CONTRASTIVE.MOMENTUM."""
    m = cfg.CONTRASTIVE.MOMENTUM
    for twin, name in _TWINS.items():
        online = dict(getattr(model, name).named_parameters())
        ema = list(ssl[twin].values())
        torch._foreach_mul_(ema, m)
        torch._foreach_add_(ema, torch._foreach_mul([online[n] for n in ssl[twin]], 1.0 - m))


def tmodeling_loss(cfg, model: nn.Module, ssl: Dict[str, Dict[str, torch.Tensor]],
                   clips: torch.Tensor, infos: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The AdViSe loss (``advise_tpu/engine/steps.py tmodeling_loss``) on
    clips [B, K, T, H, W, C], in float32:

    - speed (or action) in SSL.TASK: the CE of head_cls's logits against
      ``infos['spd_label']`` [B, K] (no SSL.SMOOTHING, as in JAX), and
      acc_spd;
    - BYOL: keys from the twin temporal encoder on the same tokens, in eval
      mode (the online model's running statistics from before the step);
      per view i the online projection and prediction of clip i against
      the twin projector's eval projection of clip 1 - i, l2-normalized;
      -mean(q . k / T) averaged over the two views, plus 1 / T.

    The tower runs once: the key path takes its tokens detached (JAX applies
    it again to the same clips, which gives the same tokens). Every head
    call in train mode records its BN statistics, committed after the
    backward in this order: features, classify, then project and predict of
    view 0, then of view 1."""
    from advise_tpu_torch.engine.contrastive import l2_normalize
    from advise_tpu_torch.models.temporal_model import eval_mode

    use_byol = "byol" in cfg.SSL.TASK
    use_speed = "speed" in cfg.SSL.TASK or "action" in cfg.SSL.TASK
    t_temp = cfg.CONTRASTIVE.T
    b, k = clips.shape[:2]
    grid = model.tokens(clips.reshape(b * k, *clips.shape[2:]))
    feats = model.temporal_forward(grid)
    loss = torch.zeros((), device=clips.device)
    stats: Dict[str, torch.Tensor] = {}
    if use_speed:
        logits = model.classify(feats, generator)
        labels = infos["spd_label"].reshape(b * k).long()
        loss_spd = L.cross_entropy(logits, labels)
        loss = loss + loss_spd
        stats["loss_spd"] = loss_spd
        stats["acc_spd"] = L.top_k_accuracy(logits, labels, 1)
    if use_byol:
        if k < 2:
            raise ValueError("BYOL tmodeling needs DATA.NUM_CLIP >= 2")
        with torch.no_grad(), eval_mode(model.temporal_encoder):
            keys = model.temporal_forward(grid.detach(), ssl["ema_temporal"]).reshape(b, k, -1)
        feats_bk = feats.reshape(b, k, -1)
        loss_byol = torch.zeros((), device=clips.device)
        for i in range(2):
            q = model.predict(model.project(feats_bk[:, i], generator), generator)
            with torch.no_grad(), eval_mode(model.head_projector):
                key = model.project(keys[:, 1 - i], projector_params=ssl["ema_projector"])
            q, key = l2_normalize(q.float()), l2_normalize(key.float())
            loss_byol = loss_byol - (torch.sum(q * key, dim=-1) / t_temp).mean()
        loss_byol = loss_byol / 2.0 + 1.0 / t_temp
        loss = loss + loss_byol
        stats["loss_byol"] = loss_byol
    return loss, stats


def make_tmodeling_train_step(cfg, bundle: OptimizerBundle, device_aug: Optional[Callable]):
    """Returns ``step(state, clips_u8, infos, generator, lr) -> stats`` for the
    TemporalModel (the task step's signature): ``state.ssl`` holds the BYOL
    twins (:func:`init_tmodeling_ssl`), updated before the loss from the
    pre-step parameters. Parameters outside the graph (the frozen tower)
    get zero gradients, as JAX's ``stop_gradient`` gives them; their lr
    scale is 0, so they come out of the step unchanged."""
    dtype = cfg_compute_dtype(cfg)
    use_byol = "byol" in cfg.SSL.TASK
    check_auto(cfg)

    def step(state: TrainState, clips_u8: torch.Tensor, infos: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator], lr: float) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        gather_step(model)
        clips = augment(device_aug, clips_u8, generator, dtype)
        if use_byol:
            update_tmodeling_ema(cfg, state.ssl, model)
        with HOST_TIMES("step.forward"), torch.autocast(clips.device.type, dtype=dtype,
                                                        enabled=dtype != torch.float32):
            loss, stats = tmodeling_loss(cfg, model, state.ssl, clips, infos, generator)
        with HOST_TIMES("step.backward"):
            grads = loss_grads(loss, dict(model.named_parameters()))
        commit_bn(model)
        return finish_step(cfg, state, bundle, grads, {name: v.detach() for name, v in stats.items()}, lr, model)

    return spanned(step)


def make_train_step(cfg, bundle: OptimizerBundle, device_aug: Optional[Callable]):
    """Dispatch on the model, as the JAX ``make_train_step`` does:
    ContrastiveModel takes the contrastive step, TemporalModel the AdViSe
    step, MaskMViT the task step with the masked loss, every other model the
    task step of cfg.TASK."""
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        return make_contrastive_train_step(cfg, bundle, device_aug)
    if cfg.MODEL.MODEL_NAME == "TemporalModel":
        return make_tmodeling_train_step(cfg, bundle, device_aug)
    return make_task_train_step(cfg, bundle, device_aug)


def make_eval_step(cfg, device_aug: Optional[Callable]):
    """The forward-only step of speed_val and inference
    (``advise_tpu/engine/steps.py make_eval_step``): returns
    ``eval_step(model, clips_u8, generator) -> logits [B, K, classes]``.
    ``clips_u8`` [B, K, T, H, W, 3] uint8 (or already-augmented float clips
    when ``device_aug`` is None) go through the aug drawn from
    ``generator``, the cast to TPU.COMPUTE_DTYPE (bf16 under autocast) and
    ``model`` in eval mode without autograd: BN on its running statistics,
    which it does not record, and no dropout."""
    dtype = cfg_compute_dtype(cfg)

    @torch.no_grad()
    def eval_step(model: nn.Module, clips_u8: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
        model.eval()
        layouts = gather_step(model)
        clips = device_aug(clips_u8, generator) if device_aug is not None else clips_u8
        clips = clips.to(dtype)
        b, k = clips.shape[:2]
        with torch.autocast(clips.device.type, dtype=dtype, enabled=dtype != torch.float32):
            logits = model(clips.reshape(b * k, *clips.shape[2:]))
        for layout in layouts:
            layout.release()
        return logits.reshape(b, k, -1)

    return eval_step


def make_knn_probe_step(cfg, device_aug: Optional[Callable], num_classes: Optional[int] = None):
    """The epoch-end online kNN monitor (``advise_tpu/engine/steps.py:701``):
    returns ``probe(state, clips_u8, infos, generator) -> acc``, the forward
    of the first view -> l2-normalized float32 projection -> top-k vote
    against ``state.ssl['knn_mem']`` with ``state.ssl['knn_labels']``, top-1
    accuracy against ``infos['cls_id']``. ``num_classes`` is the dataset's
    label range (MODEL.NUM_CLASSES when None). Each rank votes on its own
    batch against the replicated bank; the accuracy is the world's mean.

    The forward is in eval mode, or with CONTRASTIVE.KNN_BATCH_STATS in
    train mode: BN on the batch's statistics and dropout live (its masks
    from ``generator`` after the aug's draws), as JAX's ``train=True``. JAX
    throws the mutated statistics away, so the probe drops what the BN
    layers recorded, and the running statistics stay as they were."""
    from advise_tpu_torch.engine.contrastive import knn_probe, l2_normalize

    use_batch_stats = bool(cfg.CONTRASTIVE.KNN_BATCH_STATS)
    dtype = cfg_compute_dtype(cfg)
    knn_k = int(cfg.CONTRASTIVE.KNN_K)
    if num_classes is None:
        num_classes = int(cfg.MODEL.NUM_CLASSES)

    @torch.no_grad()
    def probe(state: TrainState, clips_u8: torch.Tensor, infos: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator]) -> torch.Tensor:
        model = state.model
        model.train(use_batch_stats)
        layouts = gather_step(model)
        clips = device_aug(clips_u8, generator) if device_aug is not None else clips_u8
        clips = clips.to(dtype)
        with torch.autocast(clips.device.type, dtype=dtype, enabled=dtype != torch.float32):
            out = model(clips[:, 0], generator=generator)  # the first view
        for layout in layouts:
            layout.release()
        if use_batch_stats:
            drop_bn_records(model)
        proj = out[0] if isinstance(out, (list, tuple)) else out
        q = l2_normalize(proj.float())
        ssl = state.ssl
        return pmean(knn_probe(cfg, ssl, ssl["knn_labels"], q, infos["cls_id"], knn_k=knn_k,
                               t=cfg.CONTRASTIVE.T, num_classes=num_classes))

    return probe
