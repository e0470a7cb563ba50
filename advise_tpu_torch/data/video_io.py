"""Video ingestion backends: the port's copy of ``advise_tpu/data/video_io.py``
(the readers and ``open_video``), with its own bilinear resize.

The JAX package resizes frames with ``cv2.resize(..., INTER_LINEAR)``
(``video_io.py:51-56``). A machine that runs the port need not have cv2,
and the resize must not depend on it, so :func:`resize_bilinear_u8`
states cv2's uint8 arithmetic itself: the
coefficients are cv2's (source coordinate ``(d + 0.5) * scale - 0.5`` in
float32, clamped at the edges, weights rounded to 11-bit fixed point), the
horizontal pass is exact in integers, and the vertical pass rounds as cv2's
SIMD kernel does (``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)``, then
``(v + 2) >> 2``), in numpy on the host. The two axes treat a source
coordinate outside the image differently, as cv2 does: the horizontal taps
clamp to the edge pixel with the fraction set to 0, while the vertical taps
keep their fraction and clamp only the two row indices, so an upscale's
first and last output rows take both truncating taps on the edge row (one
less than the rounded edge value on some pixels). That equals cv2 (5.0) on
every pixel, downscales and upscales alike (tests/test_torch_data.py).

Readers: :class:`SyntheticReader` (procedural, no media), :class:`ArrayReader`
(.npy/.npz/.pt archives) and :class:`CV2Reader`, which decodes .avi/.mp4
with cv2 and is there only for a machine where ``cv2`` imports; every
reader resizes with :func:`resize_bilinear_u8`. Remote paths raise
(``utils/storage.py``).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from advise_tpu_torch.utils.host_times import HOST_TIMES

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS  # cv2's INTER_RESIZE_COEF_SCALE


# frames resized together: the int32 intermediates of 4 frames at 298 x 224
# stay in cache, and numpy (one thread per call, the GIL released) lets the
# loader's worker threads run side by side
RESIZE_CHUNK = 4


@lru_cache(maxsize=64)
def _coeffs(src: int, dst: int, clamp_fraction: bool = True):
    """cv2's linear-resize taps along one axis: (index 0, index 1, weight 0,
    weight 1), the weights in 11-bit fixed point. Where the source
    coordinate falls outside the image, ``clamp_fraction`` (cv2's
    horizontal axis) puts both taps on the edge with the fraction 0; without
    it (cv2's vertical axis) the fraction stays and only the indices clamp."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp_fraction:
        low = s < 0
        f[low], s[low] = 0, 0
        high = s >= src - 1
        f[high], s[high] = 0, src - 1
    w1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * np.float32(COEF_SCALE)).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def _resize_chunk(frames: np.ndarray, resize_wh: Tuple[int, int]) -> np.ndarray:
    w, h = resize_wh
    n, src_h, src_w, c = frames.shape
    x0, x1, a0, a1 = _coeffs(src_w, w)
    y0, y1, b0, b1 = _coeffs(src_h, h, clamp_fraction=False)
    lanes = np.arange(c)
    rows = frames.reshape(n, src_h, src_w * c)
    # horizontal: exact integer sums of the two taps, [n, H, w * C]
    s = np.multiply(rows[:, :, (x0[:, None] * c + lanes).ravel()], np.repeat(a0, c), dtype=np.int32)
    s += np.multiply(rows[:, :, (x1[:, None] * c + lanes).ravel()], np.repeat(a1, c), dtype=np.int32)
    # vertical, rounded as cv2's SIMD kernel: mulhi of each tap on S >> 4
    # (int16), then (v + 2) >> 2; every value after a shift fits int16
    q = np.right_shift(s, 4, out=np.empty(s.shape, np.int16), casting="unsafe")
    t = np.multiply(q[:, y0], b0[:, None], dtype=np.int32)
    out = np.right_shift(t, 16, out=np.empty(t.shape, np.int16), casting="unsafe")
    np.multiply(q[:, y1], b1[:, None], out=t, dtype=np.int32)
    t >>= 16
    np.add(out, t, out=out, casting="unsafe")
    out += 2
    out >>= 2  # in [0, 255]: the weights of each axis sum to 2048
    return out.astype(np.uint8).reshape(n, h, w, c)


def resize_bilinear_u8(frames: np.ndarray, resize_wh: Tuple[int, int]) -> np.ndarray:
    """uint8 frames ``[..., H, W, C]`` resized to ``(W, H) = resize_wh`` with
    cv2's INTER_LINEAR arithmetic (module docstring)."""
    flat = frames.reshape(-1, *frames.shape[-3:])
    out = np.concatenate([_resize_chunk(flat[i:i + RESIZE_CHUNK], resize_wh)
                          for i in range(0, len(flat), RESIZE_CHUNK)])
    return out.reshape(*frames.shape[:-3], *out.shape[1:])


def _resize_frames(frames: np.ndarray, resize_wh: Optional[Tuple[int, int]]) -> np.ndarray:
    if resize_wh is None:
        return frames
    w, h = resize_wh
    if frames.shape[-3] == h and frames.shape[-2] == w:
        return frames
    with HOST_TIMES("resize"):
        return resize_bilinear_u8(frames, resize_wh)


class VideoReader:
    """Interface: ``len(reader)`` frames; ``get_frames(indices, resize_wh)``
    returns uint8 [T, H, W, C] (RGB)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def get_frames(
        self, indices: Sequence[int], resize_wh: Optional[Tuple[int, int]] = None
    ) -> np.ndarray:
        raise NotImplementedError


class CV2Reader(VideoReader):
    """Sequential decode of the requested frames with ``cv2.VideoCapture``
    (``advise_tpu/data/video_io.py CV2Reader``, without its seek), for a
    machine where cv2 imports; frames resize with :func:`resize_bilinear_u8`.
    """

    def __init__(self, path: str):
        import cv2

        self._cv2 = cv2
        self.path = path
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self._length = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        if self._length <= 0:
            raise IOError(f"video reports no frames: {path}")

    def __len__(self) -> int:
        return self._length

    def get_frames(self, indices, resize_wh=None) -> np.ndarray:
        indices = np.asarray(indices, np.int64)
        wanted = set(indices.tolist())
        decoded = {}
        cap = self._cv2.VideoCapture(self.path)
        try:
            pos = 0
            while pos <= int(indices.max()) and len(decoded) < len(wanted):
                ok, frame = cap.read()
                if not ok:
                    break
                if pos in wanted:
                    decoded[pos] = frame[:, :, ::-1]  # BGR -> RGB
                pos += 1
        finally:
            cap.release()
        if not decoded:
            raise IOError(f"decode produced no frames: {self.path}")
        last = decoded[max(decoded)]  # a codec that undercounts: repeat the last
        frames = np.stack([decoded.get(int(i), last) for i in indices])
        return _resize_frames(frames, resize_wh)


class ArrayReader(VideoReader):
    """Pre-tensorized videos: .npy/.npz uint8 [T, H, W, C] archives, or the
    reference's .pt dict {'data': tensor, 'info': {'length': [T]}}."""

    def __init__(self, path_or_array):
        if isinstance(path_or_array, np.ndarray):
            arr = path_or_array
        else:
            ext = os.path.splitext(str(path_or_array))[1]
            if ext == ".npy":
                arr = np.load(path_or_array, mmap_mode="r")
            elif ext == ".npz":
                arr = np.load(path_or_array)["data"]
            elif ext == ".pt":
                arr = torch.load(path_or_array, map_location="cpu")["data"].numpy()
            else:
                raise NotImplementedError(f"unsupported tensor video: {ext}")
        if arr.ndim != 4 or arr.shape[-1] not in (1, 3):
            raise ValueError(f"tensor video must be [T, H, W, 1|3], got {arr.shape}")
        self._arr = arr

    def __len__(self) -> int:
        return self._arr.shape[0]

    def get_frames(self, indices, resize_wh=None) -> np.ndarray:
        frames = np.asarray(self._arr[np.asarray(indices, np.int64)])
        return _resize_frames(frames, resize_wh)


class SyntheticReader(VideoReader):
    """Procedural video: moving squares over a gradient background
    (``advise_tpu/data/video_io.py:218-276``, the same frames).

    Every frame is a pure function of (seed, t), so only requested frames
    are materialized. Motion position advances linearly in t, which makes
    playback-speed classification learnable.
    """

    def __init__(self, seed: int, length: int = 250, res: int = 128, cls_id: int = 0,
                 motion: float = 1.0, class_coded: bool = False):
        self.seed = int(seed)
        self._length = int(length)
        self.res = int(res)
        self.cls_id = int(cls_id)
        rng = np.random.default_rng(self.seed)
        self.n_obj = 3
        self.pos0 = rng.uniform(0, 1, size=(self.n_obj, 2))
        self.vel = motion * rng.uniform(-0.02, 0.02, size=(self.n_obj, 2))
        self.size = rng.integers(max(res // 12, 4), max(res // 5, 8), size=self.n_obj)
        self.color = rng.integers(40, 255, size=(self.n_obj, 3))
        if class_coded:
            # DATA.SYNTHETIC_CLASS_CODED: object colours from the class id
            crng = np.random.default_rng(100003 + self.cls_id)
            self.color = crng.integers(40, 255, size=(self.n_obj, 3))
        self.bg_phase = rng.uniform(0, 2 * np.pi, size=3)

    def __len__(self) -> int:
        return self._length

    def _frames(self, ts: np.ndarray) -> np.ndarray:
        """Frames ``ts`` at once, each value computed as the JAX package's
        ``_frame(t)`` computes it (the same operations in the same types and
        order), in a few large numpy calls: the loader's threads then hold
        the GIL for little of the work."""
        r = self.res
        yy = np.linspace(0, 1, r, dtype=np.float32)[:, None]
        xx = np.linspace(0, 1, r, dtype=np.float32)[None, :]
        ramp = 2 * np.pi * (xx + yy)
        shift = (0.01 * ts)[:, None, None]
        frames = np.stack(
            [127.5 * (1 + np.sin(ramp + p + shift)) for p in self.bg_phase], axis=-1)
        for frame, t in zip(frames, ts.tolist()):
            for k in range(self.n_obj):
                cy, cx = (self.pos0[k] + t * self.vel[k]) % 1.0
                s = int(self.size[k])
                y0 = int(cy * (r - s))
                x0 = int(cx * (r - s))
                frame[y0 : y0 + s, x0 : x0 + s, :] = self.color[k]
        return frames.astype(np.uint8)

    def get_frames(self, indices, resize_wh=None) -> np.ndarray:
        return _resize_frames(self._frames(np.asarray(indices, np.int64)), resize_wh)


def open_video(path: str, backend: str = "auto") -> VideoReader:
    """Open a local video file with the right backend (``.npy/.npz/.pt``:
    :class:`ArrayReader`, else :class:`CV2Reader`)."""
    from advise_tpu_torch.utils.storage import local_path

    path = local_path(path)
    ext = os.path.splitext(path)[1].lower()
    if backend == "auto":
        backend = "tensor" if ext in (".npy", ".npz", ".pt") else "cv2"
    if backend == "cv2":
        return CV2Reader(path)
    if backend == "tensor":
        return ArrayReader(path)
    raise NotImplementedError(f"unknown video backend: {backend}")
