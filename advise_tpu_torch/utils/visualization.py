"""The VIS_MASK dump (counterpart of ``advise_tpu/utils/visualization.py``,
its ``denormalize`` and ``dump_mask_visualization``): at an epoch's end the
trainer runs one batch through the MAE model in eval mode and writes, per
clip, the (input, masked input, reconstruction) triple under
``LOGDIR/vis_mask/vid/{prefix}vis_video_in_mask_out_mr{AUG.MASK_RATIO}/``:

- ``vis_{epoch}_{i}.npy``: float32 [3, T, H, W, 3], normalised as the model
  saw it; always written;
- ``vis_{epoch}_{i}.mp4``: the three side by side, de-normalised with
  DATA.MEAN / DATA.STD; written only where ``cv2`` imports.

``prefix`` is the basename of TEST.CHECKPOINT_FILE_PATH without its
extension. The clip dumps, feature extraction and CAM heatmaps of the JAX
module are not ported yet (ROADMAP A 17).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def denormalize(clip: np.ndarray, mean, std) -> np.ndarray:
    """Normalised float clip [..., C] -> uint8: clip * std * 255 + mean *
    255, clipped to [0, 255] and truncated."""
    mean = np.asarray(mean) * 255.0
    std = np.asarray(std) * 255.0
    return np.clip(clip * std + mean, 0, 255).astype(np.uint8)


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def vis_dir(cfg) -> str:
    """Where the VIS_MASK dump of ``cfg`` lands."""
    pfx = os.path.basename(str(cfg.TEST.CHECKPOINT_FILE_PATH or "")).rsplit(".", 1)[0]
    return os.path.join(cfg.LOGDIR, "vis_mask", "vid", f"{pfx}vis_video_in_mask_out_mr{cfg.AUG.MASK_RATIO}")


@torch.no_grad()
def dump_mask_visualization(cfg, model: torch.nn.Module, clips_u8: torch.Tensor,
                            device_aug: Optional[Callable], generator: Optional[torch.Generator],
                            epoch: int, max_items: int = 4) -> Optional[str]:
    """VIS_MASK.ENABLE: the first ``max_items`` clips of ``clips_u8`` [B, K,
    T, H, W, 3] (already-augmented float clips when ``device_aug`` is None)
    through the train aug drawn from ``generator``, the cast to
    TPU.COMPUTE_DTYPE and the model in eval mode, whose random masks the
    same generator draws next; writes the triples (module docstring) and
    returns the directory, or None when VIS_MASK is off."""
    if not cfg.VIS_MASK.ENABLE:
        return None
    from advise_tpu_torch.models import compute_dtype

    dtype = compute_dtype(cfg)
    model.eval()
    clips = device_aug(clips_u8, generator) if device_aug is not None else clips_u8
    b, k = clips.shape[:2]
    x = clips.reshape(b * k, *clips.shape[2:])[:max_items].to(dtype)
    with torch.autocast(x.device.type, dtype=dtype, enabled=dtype != torch.float32):
        vis = model(x, generator=generator)[-1]
    triple = np.stack([v.float().cpu().numpy() for v in vis], axis=1)  # [N, 3, T, H, W, 3]
    out_dir = vis_dir(cfg)
    os.makedirs(out_dir, exist_ok=True)
    cv2 = _cv2()
    for i in range(triple.shape[0]):
        np.save(os.path.join(out_dir, f"vis_{epoch}_{i}.npy"), triple[i])
        if cv2 is None:
            continue
        frames = [np.concatenate([denormalize(triple[i, j, f], cfg.DATA.MEAN, cfg.DATA.STD)
                                  for j in range(3)], axis=1) for f in range(triple.shape[2])]
        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(os.path.join(out_dir, f"vis_{epoch}_{i}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 4, (w, h))
        for f in frames:
            writer.write(f[..., ::-1])  # RGB -> BGR
        writer.release()
    logger.info("VIS_MASK: wrote %d comparisons to %s%s", triple.shape[0], out_dir,
                "" if cv2 is not None else " (.npy only: no cv2)")
    return out_dir
