"""Learning-rate policies (the port's own copy of
``advise_tpu/solver/lr_policy.py``, which is pure Python; tests hold the two
equal): cosine and steps_with_relative_lrs under a linear warm-up, and the
warm-up of the plateau policy with its :class:`PlateauController`.

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


def get_step_index(cfg, cur_epoch: float) -> int:
    """The index of the step of SOLVER.STEPS (then MAX_EPOCH) that
    ``cur_epoch`` lies in: the last step at or before it."""
    steps = list(cfg.SOLVER.STEPS) + [cfg.SOLVER.MAX_EPOCH]
    for ind, step in enumerate(steps):
        if cur_epoch < step:
            break
    return ind - 1


def lr_func_steps_with_relative_lrs(cfg, cur_epoch: float) -> float:
    """SOLVER.LRS[i] * BASE_LR in step i of SOLVER.STEPS."""
    return cfg.SOLVER.LRS[get_step_index(cfg, cur_epoch)] * cfg.SOLVER.BASE_LR


_POLICIES = {"cosine": lr_func_cosine, "steps_with_relative_lrs": lr_func_steps_with_relative_lrs}


def get_lr_at_epoch(cfg, cur_epoch: float) -> float:
    """Policy value with linear warmup below WARMUP_EPOCHS (reference
    lr_policy.py:9-28). Under the plateau policy: the linear warm-up to
    BASE_LR, then BASE_LR (the trainer's PlateauController takes over)."""
    if cfg.SOLVER.LR_POLICY == "plateau":
        if cur_epoch <= cfg.SOLVER.WARMUP_EPOCHS:
            alpha = (cfg.SOLVER.BASE_LR - cfg.SOLVER.WARMUP_START_LR) / cfg.SOLVER.WARMUP_EPOCHS
            return cur_epoch * alpha + cfg.SOLVER.WARMUP_START_LR
        return cfg.SOLVER.BASE_LR
    fn = _POLICIES[cfg.SOLVER.LR_POLICY]
    lr = fn(cfg, cur_epoch)
    if cur_epoch < cfg.SOLVER.WARMUP_EPOCHS:
        lr_start = cfg.SOLVER.WARMUP_START_LR
        lr_end = fn(cfg, cfg.SOLVER.WARMUP_EPOCHS)
        alpha = (lr_end - lr_start) / cfg.SOLVER.WARMUP_EPOCHS
        lr = cur_epoch * alpha + lr_start
    return lr


class PlateauController:
    """ReduceLROnPlateau with torch semantics (reference utils/solver.py:
    71-99: mode=min, factor=0.5, patience=5, threshold=1e-4), stepped once
    per epoch after warmup (``advise_tpu/solver/lr_policy.py:75``)."""

    def __init__(self, base_lr, factor=0.5, patience=5, threshold=1e-4):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr
