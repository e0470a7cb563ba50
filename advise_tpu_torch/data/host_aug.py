"""Host-side augmentation for TPU.DEVICE_AUG False (counterpart of
``advise_tpu/data/host_aug.py``): the reference's frame pipeline for
AUG.TYPE 'simple' (Resize -> RandomCrop -> RandomColorJitter -> ToTensor ->
Normalize), with one ``random.Random`` seeded per clip and re-seeded for
every frame, as the reference does.

The JAX package runs it through PIL; the port computes PIL's arithmetic in
numpy, equal to it bit for bit (``tests/test_torch_host_aug.py``):

- ``Image.resize(BILINEAR)``: Pillow's two-pass resample (horizontal, then
  vertical), the triangle filter widened by the downscale factor, each
  output's taps normalised in double and stored as 22-bit fixed point,
  sums started at half a unit and shifted back, clipped to uint8;
- ``ImageEnhance.Brightness``, ``Contrast`` and ``Color``: ``Image.blend``
  of the image with black, with its rounded mean luma, or with its luma
  (``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``), in float32, truncated
  to uint8 and clipped outside [0, 255];
- the hue factor is drawn and not applied (the reference's own hue op
  truncates to a no-op), so the generator's stream stays aligned.

Clips are [T, H, W, C] uint8; the output is [T, S, S, C] float32,
normalized by division as numpy does on the host.
"""

from __future__ import annotations

import math
import random
from typing import Tuple

import numpy as np

_PRECISION_BITS = 22  # Pillow's fixed-point coefficients (Resample.c)


def _bilinear_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` for the bilinear filter and
    ``normalize_coeffs_8bpc``: per output pixel the first input pixel and the
    int fixed-point weights [out, ksize] (zero past each pixel's taps), so
    every output reads ``ksize`` inputs from its first one, clamped."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        taps = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        total = 0.0
        for w in taps:
            total += w
        for x, w in enumerate(taps):
            w = w / total if total != 0.0 else w
            weights[xx, x] = int(-0.5 + w * (1 << _PRECISION_BITS)) if w < 0 else int(0.5 + w * (1 << _PRECISION_BITS))
        first[xx] = xmin
    return first, weights


def _resample_axis(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` of uint8 ``x``."""
    in_size = x.shape[axis]
    first, weights = _bilinear_taps(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(weights.shape[1])[None, :], in_size - 1)
    taps = np.take(x.astype(np.int64), idx, axis=axis)  # the axis becomes [out, ksize]
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = weights.shape
    acc = np.sum(taps * weights.reshape(shape), axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize_bilinear(frames: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """``Image.resize(wh, BILINEAR)`` of each frame of [..., H, W, C] uint8:
    the horizontal pass where the width changes, then the vertical one
    where the height does."""
    w, h = wh
    if frames.shape[-2] != w:
        frames = _resample_axis(frames, w, frames.ndim - 2)
    if frames.shape[-3] != h:
        frames = _resample_axis(frames, h, frames.ndim - 3)
    return frames


def pil_luma(x: np.ndarray) -> np.ndarray:
    """PIL's RGB -> 'L' of uint8 [..., 3]."""
    x = x.astype(np.int64)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def pil_blend(degenerate: np.ndarray, image: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(degenerate, image, alpha)`` on uint8 arrays: in1 +
    alpha (in2 - in1) in float32 (alpha rounded to float32), truncated,
    clipped to [0, 255]."""
    a = np.float32(alpha)
    lo = degenerate.astype(np.float32)
    v = lo + a * (image.astype(np.float32) - lo)
    return np.floor(np.clip(v, np.float32(0.0), np.float32(255.0))).astype(np.uint8)


def _brightness(frames: np.ndarray, factor: float) -> np.ndarray:
    return pil_blend(np.zeros_like(frames), frames, factor)


def _contrast(frames: np.ndarray, factor: float) -> np.ndarray:
    """Blend with each frame's mean luma, ``int(mean + 0.5)``."""
    luma = pil_luma(frames)
    count = luma.shape[-2] * luma.shape[-1]
    totals = luma.reshape(luma.shape[0], -1).astype(np.int64).sum(axis=1)
    means = np.array([int(int(s) / count + 0.5) for s in totals], np.uint8)
    return pil_blend(np.broadcast_to(means[:, None, None, None], frames.shape), frames, factor)


def _color(frames: np.ndarray, factor: float) -> np.ndarray:
    return pil_blend(np.broadcast_to(pil_luma(frames)[..., None], frames.shape), frames, factor)


def color_jitter_frames(frames: np.ndarray, rng: random.Random, p, b, c, s, h) -> np.ndarray:
    """The reference's RandomColorJitter (``_color_jitter_frame``) on uint8
    frames [T, H, W, C] that share one generator state: the three factors,
    the hue factor (drawn, not applied), the shuffled order, then with
    probability ``p`` the enhancements in that order."""
    b_factor = rng.uniform(max(0, 1.0 - b), 1.0 + b)
    c_factor = rng.uniform(max(0, 1.0 - c), 1.0 + c)
    s_factor = rng.uniform(max(0, 1.0 - s), 1.0 + s)
    rng.uniform(-h, h)
    fn_idx = [0, 1, 2, 3]
    rng.shuffle(fn_idx)
    if rng.random() < p:
        for fn_id in fn_idx:
            if fn_id == 0:
                frames = _brightness(frames, b_factor)
            elif fn_id == 1:
                frames = _contrast(frames, c_factor)
            elif fn_id == 2:
                frames = _color(frames, s_factor)
    return frames


class SimpleHostAug:
    """AUG.TYPE 'simple' on the host: the fixed Resize to AUG.RESIZE (where
    the frame is not that size already), a random AUG.TARGET_SIZE crop, the
    colour jitter of AUG.COLOR, then normalize; every frame of a clip takes
    the same draws (its generator re-seeded from the clip's seed)."""

    def __init__(self, cfg):
        self.resize_wh = (int(cfg.AUG.RESIZE[0]), int(cfg.AUG.RESIZE[1]))
        self.size = int(cfg.AUG.TARGET_SIZE)
        self.color = tuple(cfg.AUG.COLOR)
        self.mean = np.asarray(cfg.DATA.MEAN, np.float32)
        self.std = np.asarray(cfg.DATA.STD, np.float32)

    def __call__(self, clip_u8: np.ndarray, seed: int) -> np.ndarray:
        """[T, H, W, C] uint8 -> [T, S, S, C] normalized float32."""
        k = self.size
        rng = random.Random(seed)
        frames = pil_resize_bilinear(np.asarray(clip_u8, np.uint8), self.resize_wh)
        h, w = frames.shape[1:3]
        top = 0 if h == k else rng.randint(1, h - k) - 1
        left = 0 if w == k else rng.randint(1, w - k) - 1
        frames = frames[:, top:top + k, left:left + k]
        frames = color_jitter_frames(frames, rng, *self.color)
        arr = frames.astype(np.float32) / np.float32(255.0)
        return (arr - self.mean) / self.std


def build_host_aug(cfg, mode: str = "train"):
    """The host aug of ``mode``: only the 'simple' train pipeline runs on
    the host; every other AUG.TYPE runs on the card."""
    if mode == "train" and cfg.AUG.TYPE == "simple":
        return SimpleHostAug(cfg)
    raise NotImplementedError(
        f"host aug only supports AUG.TYPE='simple' (got {cfg.AUG.TYPE}); "
        "use TPU.DEVICE_AUG=True for the on-device pipelines"
    )
