"""The one traffic generator: a pool of train batches made on the device from
the seed, read from a cell's parameters.

A cell's file gives ``videos_per_step`` (B), ``clips_per_video`` (K),
``frames`` (T), ``ingest`` ([H, W] of the uint8 frames the loader would
hand over) and ``pool``, the number of distinct batches used in turn.
Each batch is ``(clips_u8 [B, K, T, H, W, 3], infos)``; ``infos`` is made,
from the same generator, by ``benchmark/traffic/<kind>.py`` for the kind
that ``labels`` names, so that a new kind of labels or masks is a new file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import torch

from harness import manifest
from harness.seeds import sub_seed

Batch = Tuple[torch.Tensor, Dict[str, torch.Tensor]]


def clips_per_step(traffic: dict) -> int:
    return traffic["videos_per_step"] * traffic["clips_per_video"]


def make_pool(traffic: dict, seed: int, device, root: Path = manifest.ROOT) -> List[Batch]:
    b, k, t = traffic["videos_per_step"], traffic["clips_per_video"], traffic["frames"]
    h, w = traffic["ingest"]
    labels = traffic["labels"]
    kind = manifest.traffic_kind(labels["kind"], root)
    pool = []
    for i in range(traffic["pool"]):
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "batch", i))
        clips = torch.randint(0, 256, (b, k, t, h, w, 3), generator=gen, device=device, dtype=torch.uint8)
        pool.append((clips, kind.infos(labels, clips, gen)))
    return pool


def step_seed(seed: int, i: int) -> int:
    """The seed of step i's generator (aug, dropout and drop-path draws)."""
    return sub_seed(seed, "step", i)
