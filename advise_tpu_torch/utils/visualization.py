"""Offline visualization (counterpart of ``advise_tpu/utils/visualization.py``;
reference ``utils/visualization.py:38-231``):

- :func:`clips2videos`: normalised clips as .mp4 files (cv2), a speed label
  written on each frame when given; raises where cv2 does not import;
- :func:`get_features`: the pooled features of a backbone built with
  ``include_head=False`` over the train aug, into an ``.npz`` (features,
  labels, item ids) for ``tools/run_tsne.py``;
- :func:`cam_heatmaps`: token-norm CAMs in [0, 1], resized to the frame by
  cv2 where it imports, else at the token grid (the JAX module's branch);
- the VIS_MASK dump: at an epoch's end the trainer runs one batch through
  the MAE model in eval mode and writes, per clip, the (input, masked
  input, reconstruction) triple under
  ``LOGDIR/vis_mask/vid/{prefix}vis_video_in_mask_out_mr{AUG.MASK_RATIO}/``:
  ``vis_{epoch}_{i}.npy``, float32 [3, T, H, W, 3], normalised as the model
  saw it, always; ``vis_{epoch}_{i}.mp4``, the three side by side,
  de-normalised with DATA.MEAN / DATA.STD, only where ``cv2`` imports.
  ``prefix`` is the basename of TEST.CHECKPOINT_FILE_PATH without its
  extension.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional, Sequence

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


def clips2videos(clips: np.ndarray, out_dir: str, mean, std, labels: Optional[Sequence[int]] = None,
                 fps: int = 8, prefix: str = "clip") -> List[str]:
    """Normalised clips [N, T, H, W, C] as ``out_dir/{prefix}_{i:04d}.mp4``
    (mp4v, ``fps``), de-normalised with ``mean`` / ``std``, with ``spd=`` and
    ``labels[i]`` written on each frame when given. Returns the paths."""
    cv2 = _cv2()
    if cv2 is None:
        raise ImportError("clips2videos writes .mp4 files with cv2 (opencv-python), which does not import here")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, clip in enumerate(np.asarray(clips)):
        frames = denormalize(clip, mean, std)
        _, h, w, _ = frames.shape
        path = os.path.join(out_dir, f"{prefix}_{i:04d}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in frames:
            bgr = cv2.cvtColor(f, cv2.COLOR_RGB2BGR)
            if labels is not None:
                cv2.putText(bgr, f"spd={labels[i]}", (4, 16), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
            writer.write(bgr)
        writer.release()
        paths.append(path)
    logger.info("wrote %d clip videos to %s", len(paths), out_dir)
    return paths


@torch.no_grad()
def get_features(cfg, model_backbone: torch.nn.Module, state, loader, out_path: str,
                 max_batches: Optional[int] = None, device="cuda") -> str:
    """The penultimate features of ``loader``'s epoch 0 (its first
    ``max_batches`` batches) into ``out_path`` (.npz: ``features`` [N, D],
    ``labels`` [N], ``item_ids`` [N]): each batch through the train aug (a
    generator seeded with the batch's index) and ``model_backbone`` (built
    with ``include_head=False``, holding ``state.model``'s weights but its
    head) in eval mode; a list's first output; the features averaged over
    every dim between the batch and the channels, then over a video's
    clips. Returns ``out_path``."""
    from advise_tpu_torch.data import build_device_aug
    from advise_tpu_torch.engine.train import seeded_generator

    device = torch.device(device)
    if state is not None and state.model is not model_backbone:
        model_backbone.load_state_dict(state.model.state_dict(), strict=False)
    model_backbone.eval()
    aug = build_device_aug(cfg, "train")
    feats, labels, ids = [], [], []
    for i, (clips, infos) in enumerate(loader.epoch(0)):
        if max_batches is not None and i >= max_batches:
            break
        x = aug(torch.from_numpy(np.asarray(clips)).to(device), seeded_generator(device, i))
        b, k = x.shape[:2]
        out = model_backbone(x.reshape(b * k, *x.shape[2:]))
        if isinstance(out, (list, tuple)):
            out = out[0]
        if out.ndim > 2:
            out = out.mean(dim=tuple(range(1, out.ndim - 1)))
        feats.append(out.reshape(b, k, -1).mean(dim=1).float().cpu().numpy())
        labels.append(np.asarray(infos["cls_id"]).reshape(-1))
        ids.append(np.asarray(infos["item_id"]).reshape(-1))
    features = np.concatenate(feats)
    np.savez(out_path, features=features, labels=np.concatenate(labels), item_ids=np.concatenate(ids))
    logger.info("dumped %s features to %s", features.shape, out_path)
    return out_path


def cam_heatmaps(tokens: np.ndarray, grid_hw: int, frame_hw: int) -> np.ndarray:
    """Token-norm CAMs (reference cam :165-231): tokens [N, L, D] -> the
    tokens' norms on the [grid_hw, grid_hw] grid, each map shifted and
    scaled into [0, 1] -> [N, frame_hw, frame_hw] by cv2's bilinear resize
    where cv2 imports, else [N, grid_hw, grid_hw]."""
    energy = np.linalg.norm(np.asarray(tokens), axis=-1)  # [N, L]
    maps = energy.reshape(energy.shape[0], grid_hw, grid_hw)
    maps = maps - maps.min(axis=(1, 2), keepdims=True)
    maps = maps / np.maximum(maps.max(axis=(1, 2), keepdims=True), 1e-6)
    cv2 = _cv2()
    if cv2 is not None:
        maps = np.stack([cv2.resize(m, (frame_hw, frame_hw)) for m in maps])
    return maps


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
