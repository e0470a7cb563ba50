"""Model utilities (counterpart of ``advise_tpu/models/utils.py``)."""

from __future__ import annotations

from typing import Optional


def stage_remat(cfg) -> Optional[str]:
    """TPU.REMAT / MODEL.ACT_CHECKPOINT as ``torch.utils.checkpoint``: None
    (off), 'stage' (one checkpoint per ResStage) or 'block' (one per ResBlock,
    TPU.REMAT_GRANULARITY 'block'). TPU.REMAT_POLICY selects what XLA saves
    inside a checkpoint and has no counterpart here: a checkpoint saves its
    inputs only."""
    if not (cfg.TPU.REMAT or cfg.MODEL.ACT_CHECKPOINT):
        return None
    return "block" if cfg.TPU.REMAT_GRANULARITY == "block" else "stage"


def round_width(width, multiplier, min_width=1, divisor=1) -> int:
    """Width times ``multiplier`` rounded to a multiple of ``divisor``, at
    least ``min_width``, and never below 90 % of the exact product (the JAX
    package's ``models/utils.py round_width``)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)
