"""BYOL and MoCo on one device (counterpart of
``advise_tpu/engine/contrastive.py``, the BYOL and MoCo subset).

The JAX package keeps the algorithm state functional (``TrainState.ssl``);
here it is a dict too, holding the momentum encoder as a second module
(``ssl['ema_model']``: its parameters are the JAX ``ema_params``, its BN
buffers ``ema_batch_stats``), the kNN bank ``ssl['knn_mem']`` and, for
MoCo, the key queue ``ssl['queue_x']`` [QUEUE_LEN, DIM] with its write
pointer ``ssl['ptr']`` (an int64 tensor on the card, so that the step never
waits for it and the checkpoint carries it). The functions update that
state in place and say so.

Views run as one batch ``[V*B, ...]`` with ``views=V`` passed down to every
BN, so each view keeps its own batch statistics (see ``layers/norm.py``);
the BN running statistics are recorded by the forwards and committed by the
train step (:func:`advise_tpu_torch.models.layers.norm.commit_bn_stats`).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from advise_tpu_torch.models import losses as L
from advise_tpu_torch.parallel.collectives import batch_shuffle, batch_unshuffle


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / sqrt(max(sum(x^2), 1e-12)): the floor is on the SQUARED norm, as in
    the JAX package (``F.normalize`` clamps the norm itself, which differs)."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=1e-12))


def init_ssl_state(cfg, model: nn.Module, generator: torch.Generator) -> Dict[str, Any]:
    """BYOL and MoCo state: the momentum encoder (a copy of ``model``); for
    MoCo the queue [QUEUE_LEN, DIM] uniform(-stdv, stdv) and its pointer at
    0; with CONTRASTIVE.KNN_ON the kNN bank [LENGTH, DIM] uniform(-stdv,
    stdv); stdv = 1 / sqrt(DIM / 3). The draws come from ``generator``, the
    tensors live on the model's device."""
    ctype = cfg.CONTRASTIVE.TYPE
    if ctype not in ("byol", "moco"):
        raise NotImplementedError(f"CONTRASTIVE.TYPE={ctype} is not ported yet (ROADMAP A 14)")
    ema = copy.deepcopy(model)
    ema.requires_grad_(False)
    ssl: Dict[str, Any] = {"ema_model": ema}
    dim = cfg.CONTRASTIVE.DIM
    stdv = 1.0 / math.sqrt(dim / 3)
    device = next(model.parameters()).device

    def uniform(rows: int) -> torch.Tensor:
        u = torch.rand((rows, dim), generator=generator, device=generator.device)
        return (u * (2 * stdv) - stdv).to(device)

    if ctype == "moco":
        ssl["queue_x"] = uniform(cfg.CONTRASTIVE.QUEUE_LEN)
        ssl["ptr"] = torch.zeros((), dtype=torch.int64, device=device)
    if cfg.CONTRASTIVE.KNN_ON:
        ssl["knn_mem"] = uniform(cfg.CONTRASTIVE.LENGTH)
    return ssl


def momentum_at(cfg, epoch_exact: float) -> float:
    """Cosine momentum annealing; constant momentum otherwise."""
    m0 = cfg.CONTRASTIVE.MOMENTUM
    if not cfg.CONTRASTIVE.MOMENTUM_ANNEALING:
        return m0
    return 1.0 - (1.0 - m0) * (math.cos(math.pi * epoch_exact / cfg.SOLVER.MAX_EPOCH) + 1.0) * 0.5


@torch.no_grad()
def update_ema(ssl: Dict[str, Any], model: nn.Module, m: float) -> None:
    """In place: ema = ema * m + online * (1 - m), parameters only (the
    momentum encoder's BN buffers move in its own key forwards)."""
    ema = [p for p in ssl["ema_model"].parameters()]
    cur = [p for p in model.parameters()]
    torch._foreach_mul_(ema, m)
    torch._foreach_add_(ema, torch._foreach_mul(cur, 1.0 - m))


def views_apply(model: nn.Module, views: torch.Tensor,
                generator: Optional[torch.Generator] = None):
    """Run ``views`` [V, B, ...] through ``model`` as one [V*B, ...] batch with
    per-view BN; returns the head outputs reshaped to [V, B, dim].
    ``generator`` draws the model's dropout masks in training."""
    v, b = views.shape[:2]
    out = model(views.reshape(v * b, *views.shape[2:]), views=v, generator=generator)
    if isinstance(out, (list, tuple)):
        return [o.reshape(v, b, *o.shape[1:]) for o in out]
    return out.reshape(v, b, *out.shape[1:])


def shuffle_bn_on(cfg) -> bool:
    """MoCo's shuffle-BN, taken where the JAX ``compute_keys`` takes it:
    synchronized BN that is not global, not BYOL, and sync groups on the
    mesh (TPU.MESH_SYNC != -1)."""
    return (cfg.BN.NORM_TYPE == "sync_batchnorm" and not cfg.BN.GLOBAL_SYNC
            and cfg.CONTRASTIVE.TYPE != "byol" and cfg.TPU.MESH_SYNC != -1)


def _proj(out) -> torch.Tensor:
    return out[0] if isinstance(out, (list, tuple)) else out


@torch.no_grad()
def compute_keys(cfg, ssl: Dict[str, Any], views: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Momentum-encoder keys [V, B, dim] (l2-normalized projections) of
    ``views`` [V, B, ...], BN in train mode and per view. Without shuffle-BN
    and with TPU.VMAP_VIEWS the views run as one batch; otherwise one view
    after another, each in an order of its batch drawn from ``generator``
    under shuffle-BN (:func:`shuffle_bn_on`), its keys put back in order.
    ``generator`` also draws the encoder's dropout masks."""
    ema = ssl["ema_model"]
    shuffle = shuffle_bn_on(cfg)
    if cfg.TPU.VMAP_VIEWS and not shuffle and views.shape[0] > 1:
        return l2_normalize(_proj(views_apply(ema, views, generator)))
    keys = []
    for v in views:
        if shuffle:
            v, perm = batch_shuffle(v, generator)
        key = l2_normalize(_proj(ema(v, views=1, generator=generator)))
        keys.append(batch_unshuffle(key, perm) if shuffle else key)
    return torch.stack(keys)


@torch.no_grad()
def knn_update(cfg, ssl: Dict[str, Any], q: torch.Tensor, index: torch.Tensor) -> None:
    """In place: knn_mem[index] = q (momentum-1 scatter)."""
    if not cfg.CONTRASTIVE.KNN_ON or "knn_mem" not in ssl:
        return
    mem = ssl["knn_mem"]
    mem[index.to(mem.device)] = q.to(mem.dtype)


def byol_loss(cfg, model: nn.Module, ssl: Dict[str, Any], views: torch.Tensor,
              infos: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
              ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Symmetric predictor-vs-EMA-key similarity, -(q_hat . k_hat)/T averaged,
    for ``views`` [V>=2, B, T, H, W, C]. Both online views run as one batch
    with per-view BN, then the momentum encoder's keys, then the kNN scatter
    of the first view's normalized projection (in place). ``generator``
    draws the dropout masks."""
    if views.shape[0] < 2:
        raise ValueError("BYOL needs 2 clips per video")
    t = cfg.CONTRASTIVE.T
    views = views[:2]
    out = views_apply(model, views, generator)
    if not isinstance(out, list):
        raise ValueError("BYOL requires CONTRASTIVE.PREDICTOR_DEPTHS")
    proj, pred = out[0], l2_normalize(out[1])
    keys = compute_keys(cfg, ssl, views, generator)
    loss = (
        -(torch.sum(pred[0] * keys[1], dim=-1)).mean() / t
        + -(torch.sum(pred[1] * keys[0], dim=-1)).mean() / t
    )
    knn_update(cfg, ssl, l2_normalize(proj[0].detach()), infos["item_id"])
    return loss, ssl, {"loss_byol": loss.detach()}


@torch.no_grad()
def dequeue_and_enqueue(cfg, ssl: Dict[str, Any], keys: torch.Tensor) -> None:
    """In ``ssl``: the first view's keys (every view's with
    CONTRASTIVE.MOCO_MULTI_VIEW_QUEUE) written into the queue at ``ptr``,
    and ``ptr`` moved on by their count, back to 0 when it reaches the end.
    QUEUE_LEN must be a multiple of that count, as the JAX package asserts."""
    use = keys if cfg.CONTRASTIVE.MOCO_MULTI_VIEW_QUEUE else keys[:1]
    key = use.reshape(-1, use.shape[-1])
    queue, ptr = ssl["queue_x"], ssl["ptr"]
    k, n = queue.shape[0], key.shape[0]
    if k % n:
        raise ValueError(f"CONTRASTIVE.QUEUE_LEN ({k}) must be divisible by the key batch ({n})")
    # a new tensor: the step's loss saved the old queue for its backward
    ssl["queue_x"] = queue.index_copy(0, ptr + torch.arange(n, device=queue.device), key.to(queue.dtype))
    ssl["ptr"] = torch.where(ptr + n >= k, torch.zeros_like(ptr), ptr + n)


def moco_loss(cfg, model: nn.Module, ssl: Dict[str, Any], views: torch.Tensor,
              infos: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
              ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, torch.Tensor]]:
    """MoCo's NCE for ``views`` [V>=2, B, T, H, W, C]: the online model on
    view 0 alone (its BN statistics over that view), the momentum encoder's
    keys of views 1 and on (:func:`compute_keys`), per key view the logits
    [positive, q @ queue.T] over CONTRASTIVE.T, stacked, and the
    cross-entropy at index 0. Then, in place, the queue update
    (:func:`dequeue_and_enqueue`) and the kNN scatter of q. The logits are
    float32: in JAX the bf16 query times the float32 queue promotes. Stats:
    ``loss_nce`` and ``acc_ins`` (top-1 of the positive)."""
    if views.shape[0] < 2:
        raise ValueError("MoCo needs 2 clips per video")
    t = cfg.CONTRASTIVE.T
    q = l2_normalize(_proj(model(views[0], views=1, generator=generator)))
    keys = compute_keys(cfg, ssl, views[1:], generator)
    with torch.autocast(q.device.type, enabled=False):
        qf = q.float()
        queue_neg = qf @ ssl["queue_x"].T  # [B, QUEUE_LEN]
        logits = torch.cat([
            torch.cat([torch.sum(qf * key.float(), dim=-1, keepdim=True), queue_neg], dim=1)
            for key in keys], dim=0) / t
        zeros = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
        loss = L.cross_entropy(logits, zeros)
        acc = L.top_k_accuracy(logits.detach(), zeros, 1)
    dequeue_and_enqueue(cfg, ssl, keys)
    knn_update(cfg, ssl, q.detach(), infos["item_id"])
    return loss, ssl, {"loss_nce": loss.detach(), "acc_ins": acc}


CONTRASTIVE_LOSSES = {"byol": byol_loss, "moco": moco_loss}


def eval_knn(ssl: Dict[str, Any], q: torch.Tensor, knn_k: int = 200):
    """Top-k similarities of ``q`` [N, dim] against the kNN bank and their
    rows (reference eval_knn :233-241)."""
    dist = q @ ssl["knn_mem"].T
    return torch.topk(dist, min(knn_k, dist.shape[1]), dim=1)


def knn_probe(cfg, ssl: Dict[str, Any], labels_bank: torch.Tensor, feats: torch.Tensor,
              labels: torch.Tensor, knn_k: int = 200, t: float = 0.07,
              num_classes: Optional[int] = None) -> torch.Tensor:
    """Online kNN top-1 accuracy against the kNN bank
    (``advise_tpu/engine/contrastive.py:865``): a vote over the top-k
    neighbours weighted by exp(similarity / t). ``labels_bank`` [LENGTH]
    holds each bank row's class, -1 for a row with no vote; ``feats`` [N,
    dim] are l2-normalized query features, ``labels`` [N] their classes."""
    yd, yi = eval_knn(ssl, feats, knn_k)
    neigh = labels_bank.to(yi.device)[yi]  # [N, k]
    w = torch.exp(yd / t) * (neigh >= 0)  # a row labelled -1 casts no vote
    if num_classes is None:
        num_classes = int(labels_bank.max()) + 1
    votes = torch.zeros((feats.shape[0], num_classes), dtype=w.dtype, device=w.device)
    votes.scatter_add_(1, neigh.clamp(min=0).long(), w)
    pred = torch.argmax(votes, dim=-1)
    return (pred == labels.to(pred.device)).float().mean()


def knn_labels_from_dataset(dataset, length: int) -> torch.Tensor:
    """Label bank of the online kNN monitor (``advise_tpu/engine/
    contrastive.py:888``): row i holds the class of item i, rows past the
    dataset -1 (no vote); int32 on the CPU."""
    labels = torch.full((length,), -1, dtype=torch.int32)
    n = min(len(dataset.items), length)
    labels[:n] = torch.tensor([cls for _, cls in dataset.items[:n]], dtype=torch.int32)
    return labels
