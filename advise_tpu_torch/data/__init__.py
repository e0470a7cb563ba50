"""Data pipeline of the port: the factory of ``advise_tpu/data/__init__.py``
(:func:`build_sampler`, :func:`build_dataset`, :func:`build_loader`), the
on-card augmentation, and the host -> card prefetch.

Modes: 'train' (the sampler of cfg.TASK), 'speed' (speed_val: the dense
SpeedValSampler over VAL.*) and 'action' (inference: the
InferenceClipSampler over INFER.*), each with its own data dir, label dir
and split file (:func:`_mode_cfg`) and ingest geometry. The eval phases
fetch items through ``loader.threaded_items``.

One process drives one card: the train loader of rank r of a world of N
(``parallel/mesh.py``) loads its share of the global batch,
DATA.BATCHSIZE_PER_GPU x the batch-carrying ranks, over N, from its stride
of the epoch's order. With TPU.DEVICE_AUG False the items come out of the
host aug (``data/host_aug.py``).
"""

from __future__ import annotations

from typing import Optional

from advise_tpu_torch.data import sampling as spl
from advise_tpu_torch.data.dataset import ClipDataset
from advise_tpu_torch.data.device_aug import build_device_aug, ingest_geometry
from advise_tpu_torch.data.loader import ClipLoader, threaded_items
from advise_tpu_torch.data.prefetch import device_put_batch, prefetch_to_device

__all__ = [
    "build_sampler",
    "build_dataset",
    "build_loader",
    "build_device_aug",
    "ingest_geometry",
    "prefetch_to_device",
    "device_put_batch",
    "ClipDataset",
    "ClipLoader",
    "threaded_items",
]


def build_sampler(cfg, mode: str = "train"):
    """The sampler of ``mode`` (``advise_tpu/data/__init__.py build_sampler``):
    in 'train' that of cfg.TASK, in 'speed' the dense speed_val sweep, in
    'action' NUM_CLIPS starts x NUM_CROPS duplicates."""
    if mode == "train":
        if cfg.TASK == "speed":
            return spl.SpeedClipSampler(
                num_clips=cfg.DATA.NUM_CLIP, num_frames=cfg.DATA.NUM_FRAMES,
                stride=cfg.DATA.STRIDE, speed_range=cfg.SSL.RANGE,
                jitter=cfg.SSL.JITTER, method=cfg.SSL.METHOD,
            )
        if cfg.TASK == "tmodeling":
            return spl.TemporalModelingSampler(
                num_clips=cfg.DATA.NUM_CLIP, num_frames=cfg.DATA.NUM_FRAMES,
                stride=cfg.DATA.STRIDE, speed_range=cfg.SSL.RANGE,
                jitter=cfg.SSL.JITTER, method=cfg.SSL.METHOD,
            )
        if cfg.TASK in ("action_recog", "contrastive", "masked"):
            return spl.UniformClipSampler(
                num_clips=cfg.DATA.NUM_CLIP, num_frames=cfg.DATA.NUM_FRAMES,
                stride=cfg.DATA.STRIDE,
            )
        raise NotImplementedError(f"TASK={cfg.TASK}")
    if mode == "speed":
        return spl.SpeedValSampler(
            num_frames=cfg.VAL.NUM_FRAME, stride=cfg.VAL.STRIDE, speed_range=cfg.VAL.RANGE,
            jitter=cfg.VAL.JITTER, fps=cfg.VAL.FPS,
        )
    if mode == "action":
        return spl.InferenceClipSampler(
            num_clips=cfg.INFER.NUM_CLIPS, num_crops=cfg.INFER.NUM_CROPS,
            num_frames=cfg.INFER.NUM_FRAMES, stride=cfg.INFER.STRIDE,
            jitter=cfg.INFER.JITTER, method=cfg.INFER.SAMPLE_METHOD,
        )
    raise NotImplementedError(f"mode={mode}")


def _mode_cfg(cfg, mode: str):
    """(data dir, label dir, split file) of ``mode``."""
    if mode == "speed":
        return cfg.VAL.DATADIR, cfg.VAL.LABELDIR, cfg.VAL.SPLITFILE
    if mode == "action":
        return cfg.INFER.DATADIR, cfg.INFER.LABELDIR, cfg.INFER.SPLITFILE
    return cfg.DATA.DATADIR, cfg.DATA.LABELDIR, cfg.DATA.SPLITFILE


def build_dataset(cfg, mode: str = "train") -> ClipDataset:
    """The dataset of ``mode``: its sampler, its data, label dir and split
    file, and its ingest geometry; the synthetic backend's settings are
    DATA.*'s in every mode. With TPU.DEVICE_AUG False the train items come
    out of the host aug (``data/host_aug.py``), normalized float32."""
    data_dir, label_dir, split = _mode_cfg(cfg, mode)
    host_aug = None
    if mode == "train" and not cfg.TPU.DEVICE_AUG:
        from advise_tpu_torch.data.host_aug import build_host_aug

        host_aug = build_host_aug(cfg, mode)
    mask_gen = None
    if mode == "train" and cfg.TASK == "masked" and not cfg.MASK.MAE_RND_MASK:
        from advise_tpu_torch.data.masking import build_mask_generator

        mask_gen = build_mask_generator(cfg)
    return ClipDataset(
        name=cfg.DATA.DATASET,
        data_dir=data_dir,
        label_dir=label_dir,
        split_name=split,
        sampler=build_sampler(cfg, mode),
        ingest_wh=ingest_geometry(cfg, mode),
        backend=cfg.DATA.DECODE_BACKEND,
        synthetic_size=cfg.DATA.SYNTHETIC_SIZE,
        synthetic_length=cfg.DATA.SYNTHETIC_LENGTH,
        synthetic_res=cfg.DATA.SYNTHETIC_RES,
        synthetic_num_classes=cfg.DATA.SYNTHETIC_NUM_CLASSES,
        synthetic_motion=cfg.DATA.SYNTHETIC_MOTION,
        synthetic_class_coded=cfg.DATA.SYNTHETIC_CLASS_CODED,
        mask_gen=mask_gen,
        host_aug=host_aug,
    )


def build_loader(cfg, mode: str = "train", n_devices: Optional[int] = None) -> ClipLoader:
    """Host loader of the train mode (``advise_tpu/data/__init__.py
    build_loader``): shuffled, drop_last, DATA.WORKERS threads; this rank's
    batch is the global batch (DATA.BATCHSIZE_PER_GPU x the batch-carrying
    ones of ``n_devices``, by default the world's ranks) over the ranks that
    carry distinct batches, and it takes its batch index's stride of each
    epoch's order (ranks that differ only in 'seq', 'pipe' or 'model' load
    the same items)."""
    from advise_tpu_torch.parallel.mesh import batch_device_count, batch_index, world

    rank, n = world()
    index, n_batch = batch_index(cfg, rank, n)
    global_batch = cfg.DATA.BATCHSIZE_PER_GPU * batch_device_count(cfg, n if n_devices is None else n_devices)
    return ClipLoader(
        build_dataset(cfg, mode),
        batch_size=max(global_batch // n_batch, 1),
        shuffle=True,
        seed=cfg.TRAIN.SEED,
        num_workers=cfg.DATA.WORKERS,
        drop_last=True,
        rank=index,
        world=n_batch,
    )
