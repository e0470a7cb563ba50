"""Datasets: label-list parsing and clip extraction with retry. The port's
copy of ``advise_tpu/data/dataset.py`` (numpy; the port imports nothing of
the JAX package): kinetics/ucf CSV lists ("<file> <cls>"), Diving48 JSON,
Something-Something-v2 JSON, the 10-retry random-resample policy on a
decode failure, uint8 channel-last clips ``[K, T, H, W, C]`` at a fixed
ingest geometry, every random draw from a per-(seed, epoch, index) numpy
Generator, and a synthetic dataset that needs no media.

With TPU.DEVICE_AUG False a ``host_aug`` (``data/host_aug.py``) turns each
clip into normalized float32 ``[K, T, S, S, C]`` on the host, one seed per
clip from the item's generator.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from advise_tpu_torch.data.video_io import SyntheticReader, VideoReader, open_video
from advise_tpu_torch.utils.host_times import HOST_TIMES

logger = logging.getLogger(__name__)


def parse_label_list(name: str, label_dir: str, split_name: str) -> List[Tuple[str, int]]:
    """Parse a split file into (relative_path, class_id) pairs
    (``advise_tpu/data/dataset.py:32-63``)."""
    split_path = os.path.join(label_dir, split_name)
    items: List[Tuple[str, int]] = []
    if name in ("kinetics", "ucf", "ucf-101"):
        with open(split_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(" ")
                items.append((parts[0], int(parts[1]) if len(parts) > 1 else -1))
    elif name in ("diving", "diving48"):
        with open(split_path) as f:
            video_infos = json.load(f)
        for vi in video_infos:
            items.append((vi["vid_name"] + ".avi", int(vi["label"])))
    elif name in ("something", "ssv2"):
        with open(os.path.join(label_dir, "something-something-v2-labels.json")) as f:
            class_dict = json.load(f)
        with open(split_path) as f:
            video_infos = json.load(f)
        for vi in video_infos:
            class_name = vi["template"].replace("[", "").replace("]", "")
            items.append((f"{int(vi['id'])}.avi", int(class_dict[class_name])))
    else:
        raise NotImplementedError(f"unknown dataset: {name}")
    return items


class ClipDataset:
    """Indexable dataset producing ``(clips_u8 [K,T,H,W,C], infos)``.

    ``sampler`` maps (rng, video_length, infos) -> (stamps [K,T], infos).
    ``ingest_wh`` is the fixed (W, H) frames are resized to at decode time.
    ``mask_gen`` (the masked task) draws one block mask per clip;
    ``host_aug(clip, seed)`` (TPU.DEVICE_AUG False) augments each clip.
    """

    def __init__(
        self,
        name: str,
        data_dir: Optional[str],
        label_dir: Optional[str],
        split_name: Optional[str],
        sampler: Callable,
        ingest_wh: Tuple[int, int],
        backend: str = "auto",
        synthetic_size: int = 64,
        synthetic_length: int = 250,
        synthetic_res: int = 128,
        synthetic_num_classes: int = 101,
        synthetic_motion: float = 1.0,
        synthetic_class_coded: bool = False,
        retries: int = 10,
        mask_gen=None,
        host_aug=None,
    ):
        self.name = name
        self.data_dir = data_dir
        self.sampler = sampler
        self.mask_gen = mask_gen
        self.host_aug = host_aug
        self.ingest_wh = tuple(ingest_wh)
        self.backend = backend
        self.retries = retries
        self.synthetic_length = synthetic_length
        self.synthetic_res = synthetic_res
        self.synthetic_motion = synthetic_motion
        self.synthetic_class_coded = synthetic_class_coded
        if backend == "synthetic" or data_dir is None:
            self.backend = "synthetic"
            self.items = [(f"synthetic_{i:06d}", i % synthetic_num_classes)
                          for i in range(synthetic_size)]
        else:
            self.items = parse_label_list(name, label_dir, split_name)

    def __len__(self) -> int:
        return len(self.items)

    def _open(self, idx: int) -> VideoReader:
        if self.backend == "synthetic":
            return SyntheticReader(
                seed=idx, length=self.synthetic_length, res=self.synthetic_res,
                cls_id=self.items[idx][1], motion=self.synthetic_motion,
                class_coded=self.synthetic_class_coded,
            )
        rel, _ = self.items[idx]
        return open_video(os.path.join(self.data_dir, rel), self.backend)

    def get(self, idx: int, rng: np.random.Generator):
        """Extract clips for one item; retries with a random substitute on
        failure (``advise_tpu/data/dataset.py:134-146``)."""
        for _ in range(self.retries):
            try:
                out = self._try_get(idx, rng)
            except Exception as e:  # a decode failure: resample, as the JAX loader does
                logger.warning("decode failed for item %d: %s", idx, e)
                out = None
            if out is not None:
                return out
            idx = int(rng.integers(0, len(self)))
        raise RuntimeError(f"After {self.retries} retries, still failed.")

    def _try_get(self, idx: int, rng: np.random.Generator):
        reader = self._open(idx)
        video_length = len(reader)
        _, cls_id = self.items[idx]
        infos = {
            "item_id": np.int64(idx),
            "cls_id": np.int64(cls_id),
            "length": np.int64(video_length),
        }
        stamps, infos = self.sampler(rng, video_length, infos)
        if stamps is None:
            return None
        k, t = stamps.shape
        if self.mask_gen is not None:
            infos["mask"] = np.stack([self.mask_gen(rng) for _ in range(k)]).astype(np.uint8)
        # normalized time of the first clip's start in [0, 1]
        infos.setdefault("time_idx", np.float32(stamps[0, 0] / max(video_length - 1, 1)))
        frames = reader.get_frames(stamps.reshape(-1), resize_wh=self.ingest_wh)
        clips = frames.reshape(k, t, *frames.shape[1:])
        if self.host_aug is not None:
            # one seed per clip, re-used for every frame (the JAX loader's draw)
            seeds = rng.integers(0, 2**31 - 1, size=k)
            with HOST_TIMES("host_aug"):
                clips = np.stack([self.host_aug(c, int(s)) for c, s in zip(clips, seeds)])
        return clips, infos
