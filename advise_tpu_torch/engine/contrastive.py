"""BYOL on one device (counterpart of ``advise_tpu/engine/contrastive.py``,
the BYOL subset with TPU.VMAP_VIEWS).

The JAX package keeps the algorithm state functional (``TrainState.ssl``);
here it is a dict too, holding the momentum encoder as a second module
(``ssl['ema_model']``: its parameters are the JAX ``ema_params``, its BN
buffers ``ema_batch_stats``) and the kNN bank ``ssl['knn_mem']``. The
functions update that state in place and say so.

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


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / sqrt(max(sum(x^2), 1e-12)): the floor is on the SQUARED norm, as in
    the JAX package (``F.normalize`` clamps the norm itself, which differs)."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=1e-12))


def init_ssl_state(cfg, model: nn.Module, generator: torch.Generator) -> Dict[str, Any]:
    """BYOL state: the momentum encoder (a copy of ``model``) and, with
    CONTRASTIVE.KNN_ON, the kNN bank drawn uniform(-stdv, stdv) from
    ``generator`` on the model's device."""
    if cfg.CONTRASTIVE.TYPE != "byol":
        raise NotImplementedError(f"CONTRASTIVE.TYPE={cfg.CONTRASTIVE.TYPE} is not ported yet")
    ema = copy.deepcopy(model)
    ema.requires_grad_(False)
    ssl: Dict[str, Any] = {"ema_model": ema}
    if cfg.CONTRASTIVE.KNN_ON:
        dim = cfg.CONTRASTIVE.DIM
        stdv = 1.0 / math.sqrt(dim / 3)
        device = next(model.parameters()).device
        u = torch.rand((cfg.CONTRASTIVE.LENGTH, dim), generator=generator,
                       device=generator.device)
        ssl["knn_mem"] = (u * (2 * stdv) - stdv).to(device)
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


def views_apply(model: nn.Module, views: torch.Tensor):
    """Run ``views`` [V, B, ...] through ``model`` as one [V*B, ...] batch with
    per-view BN; returns the head outputs reshaped to [V, B, dim]."""
    v, b = views.shape[:2]
    out = model(views.reshape(v * b, *views.shape[2:]), views=v)
    if isinstance(out, (list, tuple)):
        return [o.reshape(v, b, *o.shape[1:]) for o in out]
    return out.reshape(v, b, *out.shape[1:])


@torch.no_grad()
def compute_keys(cfg, ssl: Dict[str, Any], views: torch.Tensor) -> torch.Tensor:
    """Momentum-encoder keys [V, B, dim] (l2-normalized projections) of
    ``views`` [V, B, ...], BN in train mode and per view. The no-shuffle
    branch: BYOL never shuffles BN."""
    out = views_apply(ssl["ema_model"], views)
    proj = out[0] if isinstance(out, list) else out
    return l2_normalize(proj)


@torch.no_grad()
def knn_update(cfg, ssl: Dict[str, Any], q: torch.Tensor, index: torch.Tensor) -> None:
    """In place: knn_mem[index] = q (momentum-1 scatter)."""
    if not cfg.CONTRASTIVE.KNN_ON or "knn_mem" not in ssl:
        return
    mem = ssl["knn_mem"]
    mem[index.to(mem.device)] = q.to(mem.dtype)


def byol_loss(cfg, model: nn.Module, ssl: Dict[str, Any], views: torch.Tensor,
              infos: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Symmetric predictor-vs-EMA-key similarity, -(q_hat . k_hat)/T averaged,
    for ``views`` [V>=2, B, T, H, W, C]. Both online views run as one batch
    with per-view BN, then the momentum encoder's keys, then the kNN scatter
    of the first view's normalized projection (in place)."""
    if views.shape[0] < 2:
        raise ValueError("BYOL needs 2 clips per video")
    t = cfg.CONTRASTIVE.T
    views = views[:2]
    out = views_apply(model, views)
    if not isinstance(out, list):
        raise ValueError("BYOL requires CONTRASTIVE.PREDICTOR_DEPTHS")
    proj, pred = out[0], l2_normalize(out[1])
    keys = compute_keys(cfg, ssl, views)
    loss = (
        -(torch.sum(pred[0] * keys[1], dim=-1)).mean() / t
        + -(torch.sum(pred[1] * keys[0], dim=-1)).mean() / t
    )
    knn_update(cfg, ssl, l2_normalize(proj[0].detach()), infos["item_id"])
    return loss, ssl, {"loss_byol": loss.detach()}


CONTRASTIVE_LOSSES = {"byol": byol_loss}


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
