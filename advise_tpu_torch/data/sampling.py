"""Temporal clip sampling: time-stamp generators and clip samplers. The
port's own copy of ``advise_tpu/data/sampling.py`` (numpy only; the port
imports nothing of the JAX package), held equal to it by
tests/test_torch_data.py.

Functional re-design of the reference's generator classes
(reference ``datasets/sampling.py:13-278``): every generator is a pure
function of an explicit ``np.random.Generator`` (no global ``random`` /
``np.random`` seeding), returning int64 frame indices. The math is kept
exactly equivalent:

- speed stamps: ``mod(linspace(start, start + T*stride*speed*jit, T,
  endpoint=False, int64), video_length)``, reversed when speed < 0
  (reference ``datasets/sampling.py:152-186``),
- uniform-stride stamps: ``linspace(start, start+T*stride, T,
  endpoint=False)`` (reference ``:39-65``),
- dense validation stamps: one clip per FPS frames, each swept over every
  speed label (reference ``:238-278``; the hardcoded 25 fps is configurable
  here, SURVEY.md §8.3),
- duplic inference stamps: NUM_CLIPS starts x NUM_CROPS duplicates
  (reference ``:189-235``).

Samplers return ``(stamps [K, T], infos)`` — frame gathering and
augmentation live elsewhere (the host gathers frames; augmentation runs on
device), unlike the reference where sampling, decode, and PIL aug are fused
in one host loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


def uniform_stamps(
    rng: np.random.Generator,
    video_length: int,
    num_frames: int,
    stride: int,
) -> np.ndarray:
    """Uniform-stride clip (reference StampsGenerator.gen_stamps :57-65)."""
    clip_len = num_frames * stride
    hi = max(video_length - clip_len, 0)
    start = int(rng.integers(0, hi + 1))
    stamps = np.linspace(
        start, start + clip_len, num=num_frames, endpoint=False, dtype=np.int64
    )
    return np.clip(stamps, 0, video_length - 1)


def speed_stamps(
    rng: np.random.Generator,
    video_length: int,
    num_frames: int,
    stride: int,
    speed_rate: int,
    jitter: float,
    start: Optional[int] = None,
    speed_jit: Optional[float] = None,
) -> np.ndarray:
    """Speed-spaced clip with jitter, modulo length, reversed if negative
    (reference SpeedStampsGenerator.gen_stamps :166-186)."""
    clip_len = num_frames * stride
    if speed_jit is None:
        speed_jit = 1.0 + rng.uniform(-jitter, jitter)
    if start is None:
        start = int(rng.integers(0, video_length))
    rev = speed_rate < 0
    rate = abs(speed_rate)
    stamps = np.mod(
        np.linspace(
            start,
            start + clip_len * rate * speed_jit,
            num=num_frames,
            endpoint=False,
            dtype=np.int64,
        ),
        video_length,
    )
    if rev:
        stamps = stamps[::-1].copy()
    return stamps


def interval_stamps(
    rng: np.random.Generator,
    video_length: int,
    num_frames: int,
    stride: int,
    intervals: Sequence[int],
) -> Tuple[int, List[int]]:
    """Per-frame-interval modeling (reference IntervalsStampsGenerator
    .interval_modeling :98-115): choose a random interval per gap, retry up
    to 10x to stay inside the video, else fall back to the smallest."""
    clip_len = num_frames * stride
    hi = max(video_length - clip_len, 0)
    start = int(rng.integers(0, hi + 1)) if hi > 0 else 0
    for _ in range(10):
        gaps = [int(rng.choice(np.asarray(intervals))) for _ in range(num_frames - 1)]
        stamps, cur = [start], start
        for itv in gaps:
            cur += itv * stride
            stamps.append(cur)
        if cur < video_length:
            return start, stamps
    gaps = [intervals[0]] * (num_frames - 1)
    stamps, cur = [start], start
    for itv in gaps:
        cur += itv * stride
        stamps.append(cur)
    assert cur < video_length, "smallest interval still overruns the video"
    return start, stamps


# ---------------------------------------------------------------------------
# Samplers: produce [K, T] stamps + labels for a whole item
# ---------------------------------------------------------------------------


@dataclass
class SpeedClipSampler:
    """K clips per video, each at a random speed from ``speed_range``;
    the label is the index into ``speed_range``
    (reference SpeedSampling :368-399 + SpeedStampsGenerator)."""

    num_clips: int
    num_frames: int
    stride: int
    speed_range: Sequence[int]
    jitter: float
    # SSL.METHOD (reference SpeedStampsGenerator.__call__ :162-168: only
    # 'random' is implemented; anything else raises)
    method: str = "random"

    def __call__(self, rng: np.random.Generator, video_length: int, infos: dict):
        if self.method != "random":
            raise NotImplementedError(f"SSL.METHOD={self.method!r}")
        labels = rng.integers(0, len(self.speed_range), size=self.num_clips)
        stamps = np.stack(
            [
                speed_stamps(
                    rng,
                    video_length,
                    self.num_frames,
                    self.stride,
                    self.speed_range[int(lbl)],
                    self.jitter,
                )
                for lbl in labels
            ]
        )
        infos["spd_label"] = labels.astype(np.int64)
        return stamps, infos


@dataclass
class TemporalModelingSampler:
    """K clips with start/stamps/speed recorded (reference
    TemporalModelingSampling :342-363 — which is missing its return
    statement; fixed here per SURVEY.md §8.1)."""

    num_clips: int
    num_frames: int
    stride: int
    speed_range: Sequence[int]
    jitter: float
    # SSL.METHOD (reference IntervalsStampsGenerator: 'random' start
    # sampling is the only implemented branch)
    method: str = "random"

    @property
    def clip_len(self) -> int:
        return self.num_frames * self.stride

    def __call__(self, rng: np.random.Generator, video_length: int, infos: dict):
        if self.method != "random":
            raise NotImplementedError(f"SSL.METHOD={self.method!r}")
        if video_length < self.clip_len:
            return None, None
        starts, all_stamps, speeds = [], [], []
        for _ in range(self.num_clips):
            hi = video_length - self.clip_len
            start = 0 if hi <= 0 else int(rng.integers(0, hi + 1))
            speed = int(rng.choice(np.asarray(self.speed_range)))
            stamps = speed_stamps(
                rng,
                video_length,
                self.num_frames,
                self.stride,
                speed,
                self.jitter,
                start=start,
            )
            starts.append(start)
            all_stamps.append(stamps)
            speeds.append(abs(speed))
        infos["starts"] = np.asarray(starts, np.int64)
        infos["stamps"] = np.stack(all_stamps)
        infos["speeds"] = np.asarray(speeds, np.int64)
        # label = index into speed_range (the reference remaps {1,2,4,8} ->
        # {0..3} at train time, tools/train.py:129; we emit indices directly)
        range_abs = [abs(s) for s in self.speed_range]
        infos["spd_label"] = np.asarray(
            [range_abs.index(s) for s in speeds], np.int64
        )
        return np.stack(all_stamps), infos


@dataclass
class UniformClipSampler:
    """K uniform-stride clips (action recognition training)."""

    num_clips: int
    num_frames: int
    stride: int

    def __call__(self, rng: np.random.Generator, video_length: int, infos: dict):
        stamps = np.stack(
            [
                uniform_stamps(rng, video_length, self.num_frames, self.stride)
                for _ in range(self.num_clips)
            ]
        )
        return stamps, infos


@dataclass
class SpeedValSampler:
    """Dense validation sweep: one clip start per ``fps`` frames, each start
    expanded over every speed label (reference SpeedValSampling :430-463 +
    SpeedStampsValGenerator :238-278). Unlike training, clip count varies
    per video; the dataset layer pads/chunks to static shapes."""

    num_frames: int
    stride: int
    speed_range: Sequence[int]
    jitter: float
    fps: int = 25

    def __call__(self, rng: np.random.Generator, video_length: int, infos: dict):
        n_starts = max(video_length // self.fps, 1)
        starts = np.linspace(
            0, video_length, num=n_starts, endpoint=False, dtype=np.int64
        )
        labels = list(range(len(self.speed_range))) * n_starts
        stamps = []
        for i, start in enumerate(np.repeat(starts, len(self.speed_range))):
            stamps.append(
                speed_stamps(
                    rng,
                    video_length,
                    self.num_frames,
                    self.stride,
                    self.speed_range[labels[i]],
                    self.jitter,
                    start=int(start),
                )
            )
        infos["spd_label"] = np.asarray(labels, np.int64)
        return np.stack(stamps), infos


@dataclass
class InferenceClipSampler:
    """NUM_CLIPS uniform (or random) starts x NUM_CROPS duplicates for
    multi-view action inference (reference DuplicSpeedStampsGenerator
    :189-235 with speed_rate=1)."""

    num_clips: int
    num_crops: int
    num_frames: int
    stride: int
    jitter: float
    method: str = "uniform"

    def __call__(self, rng: np.random.Generator, video_length: int, infos: dict):
        clip_len = self.num_frames * self.stride
        if self.method == "uniform":
            hi = max(video_length - clip_len - 1, 0)
            starts = np.linspace(
                0, hi, num=self.num_clips, endpoint=True, dtype=np.int64
            )
        elif self.method == "random":
            starts = np.asarray(
                [int(rng.integers(0, video_length)) for _ in range(self.num_clips)],
                np.int64,
            )
        else:
            raise NotImplementedError(self.method)
        stamps = []
        for start in starts:
            jit = 1.0 + rng.uniform(-self.jitter, self.jitter)
            for _ in range(self.num_crops):
                stamps.append(
                    speed_stamps(
                        rng,
                        video_length,
                        self.num_frames,
                        self.stride,
                        1,
                        self.jitter,
                        start=int(start),
                        speed_jit=jit,
                    )
                )
        return np.stack(stamps), infos
