"""Collectives of the contrastive step on one card (counterpart of
``advise_tpu/parallel/collectives.py``): MoCo's shuffle-BN. With one
process the shuffle permutes the local batch; the cross-card gather of the
JAX version waits for the distributed port (ROADMAP A 16)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def _one_process() -> None:
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError("shuffle-BN across processes is not ported yet (ROADMAP A 16)")


def batch_shuffle(x: torch.Tensor, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` [B, ...] in a random order of its batch drawn from ``generator``
    (on its device), and the permutation that :func:`batch_unshuffle` undoes."""
    _one_process()
    if generator is None:
        raise ValueError("shuffle-BN needs a torch.Generator")
    perm = torch.randperm(x.shape[0], generator=generator, device=generator.device).to(x.device)
    return x[perm], perm


def batch_unshuffle(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Undo :func:`batch_shuffle`: row ``perm[i]`` of the result is row ``i``
    of ``x``."""
    _one_process()
    return x[torch.argsort(perm)]
