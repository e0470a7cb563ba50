"""Model utilities (counterpart of ``advise_tpu/models/utils.py``): the
remat switch, MViT's width rounding and the fixed sin-cos position tables
(MVIT.USE_FIXED_SINCOS_POS), the latter in numpy as the JAX package builds
them."""

from __future__ import annotations

from typing import Optional

import numpy as np


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


def _sincos_1d(embed_dim: int, positions: np.ndarray) -> np.ndarray:
    """[len(positions), embed_dim] float64: sin then cos of each position
    times 1 / 10000^(2i / embed_dim)."""
    if embed_dim % 2:
        raise ValueError(f"sin-cos embedding needs an even width, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega = 1.0 / 10000 ** (omega / (embed_dim / 2))
    out = np.einsum("p,d->pd", positions.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_1d_sincos_pos_embed(embed_dim: int, length: int, cls_token: bool = False) -> np.ndarray:
    emb = _sincos_1d(embed_dim, np.arange(length))
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    """[grid_size^2 (+1), embed_dim]: half the width for the row, half for
    the column, rows major."""
    gh = np.arange(grid_size, dtype=np.float64)
    gw = np.arange(grid_size, dtype=np.float64)
    grid_w, grid_h = np.meshgrid(gw, gh)
    emb = np.concatenate([_sincos_1d(embed_dim // 2, grid_h), _sincos_1d(embed_dim // 2, grid_w)], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)


def get_3d_sincos_pos_embed(embed_dim: int, grid_size: int, t_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """[t_size * grid_size^2 (+1), embed_dim] float32: the temporal quarter
    of the width first, then the spatial three quarters, frames major; a
    zero row in front for a cls token."""
    if embed_dim % 4:
        raise ValueError(f"3-D sin-cos embedding needs a width divisible by 4, got {embed_dim}")
    pos_spatial = get_2d_sincos_pos_embed(embed_dim // 4 * 3, grid_size)
    pos_temporal = _sincos_1d(embed_dim // 4, np.arange(t_size)).astype(np.float32)
    n_spatial = grid_size * grid_size
    pos = np.concatenate([np.repeat(pos_temporal[:, None, :], n_spatial, axis=1),
                          np.tile(pos_spatial[None, :, :], (t_size, 1, 1))],
                         axis=-1).reshape(t_size * n_spatial, embed_dim)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim), np.float32), pos], axis=0)
    return pos.astype(np.float32)
