"""Loss functions of the speed pretext (counterpart of
``advise_tpu/models/losses.py``). Every loss computes in float32 whatever
the logits' dtype, as the JAX package does."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE with integer labels."""
    return F.cross_entropy(logits.float(), labels.long())


def soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of -sum(targets * log_softmax(logits))."""
    return -(targets.float() * F.log_softmax(logits.float(), dim=-1)).sum(-1).mean()


def bce_logit(logits: torch.Tensor, targets_onehot: torch.Tensor,
              smoothing: float = 0.0) -> torch.Tensor:
    """BCE-with-logits over one-hot targets, mean over every entry; label
    smoothing moves targets to ``t * (1 - s) + s / 2``."""
    t = targets_onehot.float() * (1.0 - smoothing) + 0.5 * smoothing
    x = logits.float()
    loss = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    return loss.mean()


def margin_ranking_intra(x: torch.Tensor, target: torch.Tensor, margin: float) -> torch.Tensor:
    """x [B, C, T] scores, target [B, C] the true transform per class: the
    mean hinge max(0, x - x_true + margin) over every entry but the true
    one."""
    x = x.float()
    t = x.shape[2]
    true_scores = torch.gather(x, 2, target.long()[:, :, None])
    hinge = torch.clamp(x - true_scores + margin, min=0.0)
    mask = F.one_hot(target.long(), t) == 0
    return (hinge * mask).sum() / mask.sum()


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Share of rows whose label is among the k largest logits (ties go to
    the lower index, as a stable sort of the negated logits orders them)."""
    topk = torch.argsort(-logits.float(), dim=-1, stable=True)[..., :k]
    return (topk == labels.long()[..., None]).any(dim=-1).float().mean()
