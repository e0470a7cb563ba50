"""Data pipeline of the port: the factory of ``advise_tpu/data/__init__.py``
(:func:`build_sampler`, :func:`build_dataset`, :func:`build_loader`), the
on-card augmentation, and the host -> card prefetch.

One process drives one card: the loader is rank 0 of a world of 1, and
its batch is DATA.BATCHSIZE_PER_GPU times ``n_devices``, the number of
cards this process drives (1). The host-side PIL augmentation
(TPU.DEVICE_AUG False) is not ported and raises (ROADMAP A).
"""

from __future__ import annotations

from advise_tpu_torch.data import sampling as spl
from advise_tpu_torch.data.dataset import ClipDataset
from advise_tpu_torch.data.device_aug import build_device_aug, ingest_geometry
from advise_tpu_torch.data.loader import ClipLoader
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
]


def build_sampler(cfg, mode: str = "train"):
    """The train sampler of cfg.TASK (``advise_tpu/data/__init__.py:33-60``);
    the speed_val and inference samplers wait for their phases."""
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
    raise NotImplementedError(f"the {mode} sampler is not ported yet (ROADMAP A items 5-6)")


def build_dataset(cfg, mode: str = "train") -> ClipDataset:
    """The dataset of ``mode`` (train only: the speed_val and inference
    geometries wait for ROADMAP A items 5-6)."""
    if not cfg.TPU.DEVICE_AUG:
        raise NotImplementedError(
            "TPU.DEVICE_AUG False (the host-side PIL augmentation, host_aug) is not "
            "ported yet (ROADMAP A)")
    mask_gen = None
    if cfg.TASK == "masked" and not cfg.MASK.MAE_RND_MASK:
        from advise_tpu_torch.data.masking import build_mask_generator

        mask_gen = build_mask_generator(cfg)
    return ClipDataset(
        name=cfg.DATA.DATASET,
        data_dir=cfg.DATA.DATADIR,
        label_dir=cfg.DATA.LABELDIR,
        split_name=cfg.DATA.SPLITFILE,
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
    )


def build_loader(cfg, mode: str = "train", n_devices: int = 1) -> ClipLoader:
    """Host loader of the train mode: shuffled, drop_last, DATA.WORKERS
    threads, a batch of DATA.BATCHSIZE_PER_GPU x ``n_devices`` (the cards
    this process drives), rank 0 of a world of 1."""
    return ClipLoader(
        build_dataset(cfg, mode),
        batch_size=cfg.DATA.BATCHSIZE_PER_GPU * n_devices,
        shuffle=True,
        seed=cfg.TRAIN.SEED,
        num_workers=cfg.DATA.WORKERS,
        drop_last=True,
    )
