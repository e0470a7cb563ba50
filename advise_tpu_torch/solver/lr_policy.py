"""Learning-rate policy (the port's own copy of the cosine policy of
``advise_tpu/solver/lr_policy.py``, which is pure Python; a test holds the
two equal). Every preset of the repo uses it; the step and plateau
policies are not ported yet.

The reference schedule math (reference ``utils/lr_policy.py:9-94``):
cosine with linear warmup and an optional cosine-after-warmup offset,
evaluated at ``epoch_exact = epoch + (it + 1) / iters_per_epoch``. The LR
is computed on the host per step and passed into the train step as a
float, matching the reference's per-iteration ``update_lr``.
"""

from __future__ import annotations

import math


def lr_func_cosine(cfg, cur_epoch: float) -> float:
    offset = cfg.SOLVER.WARMUP_EPOCHS if cfg.SOLVER.COSINE_AFTER_WARMUP else 0.0
    if cfg.SOLVER.COSINE_END_LR > cfg.SOLVER.BASE_LR:
        raise ValueError("SOLVER.COSINE_END_LR must not exceed SOLVER.BASE_LR")
    return (
        cfg.SOLVER.COSINE_END_LR
        + (cfg.SOLVER.BASE_LR - cfg.SOLVER.COSINE_END_LR)
        * (
            math.cos(
                math.pi * (cur_epoch - offset) / (cfg.SOLVER.MAX_EPOCH - offset)
            )
            + 1.0
        )
        * 0.5
    )


def get_lr_at_epoch(cfg, cur_epoch: float) -> float:
    """Policy value with linear warmup below WARMUP_EPOCHS (reference
    lr_policy.py:9-28)."""
    if cfg.SOLVER.LR_POLICY != "cosine":
        raise NotImplementedError(f"SOLVER.LR_POLICY={cfg.SOLVER.LR_POLICY} is not ported yet")
    lr = lr_func_cosine(cfg, cur_epoch)
    if cur_epoch < cfg.SOLVER.WARMUP_EPOCHS:
        lr_start = cfg.SOLVER.WARMUP_START_LR
        lr_end = lr_func_cosine(cfg, cfg.SOLVER.WARMUP_EPOCHS)
        alpha = (lr_end - lr_start) / cfg.SOLVER.WARMUP_EPOCHS
        lr = cur_epoch * alpha + lr_start
    return lr
