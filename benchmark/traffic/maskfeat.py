"""MaskFeat's loader masks: ``mask`` [B, K, t, h, w] (bool, True = masked)
on the patch grid ``labels["grid"]``, each frame's 2-D block mask by the
rule of ``advise_tpu_torch/data/masking.py MaskingGenerator3D`` (the
benchmark's own copy), covering ``labels["ratio"]`` of the tokens: round(ratio
x t x h x w) // t patches a frame, in blocks of log-uniform aspect (0.3 to
1 / 0.3) and of an area uniform from 4 patches to what is left, each placed
where it adds at most what is left, up to 10 tries a block; a frame stops
early where no block fits. Its uniforms come from the batch's generator in
one draw a batch (more where one runs out), read in order on the host
(``labels``: ``{"kind": "maskfeat", "grid": [t, h, w], "ratio": r}``)."""

import math

import numpy as np
import torch

MIN_PATCHES = 4
MIN_ASPECT = 0.3
TRIES = 10
DRAW = 1 << 16


class _Uniforms:
    """[0, 1) draws from ``gen``, DRAW at a time, read in order."""

    def __init__(self, gen: torch.Generator):
        self.gen, self.buf, self.at = gen, np.empty(0), 0

    def __call__(self) -> float:
        if self.at == len(self.buf):
            self.buf = torch.rand(DRAW, generator=self.gen, device=self.gen.device, dtype=torch.float64).cpu().numpy()
            self.at = 0
        self.at += 1
        return float(self.buf[self.at - 1])


def frame_mask(h: int, w: int, target: int, u: _Uniforms) -> np.ndarray:
    mask = np.zeros((h, w), np.bool_)
    log_aspect = (math.log(MIN_ASPECT), math.log(1 / MIN_ASPECT))
    count = 0
    while count < target:
        left_over = target - count
        added = 0
        for _ in range(TRIES):
            hi = max(left_over, MIN_PATCHES)
            area = MIN_PATCHES + u() * (hi - MIN_PATCHES)
            aspect = math.exp(log_aspect[0] + u() * (log_aspect[1] - log_aspect[0]))
            bh, bw = int(round(math.sqrt(area * aspect))), int(round(math.sqrt(area / aspect)))
            if bw < w and bh < h:
                top, left = int(u() * (h - bh)), int(u() * (w - bw))
                new = bh * bw - int(mask[top:top + bh, left:left + bw].sum())
                if 0 < new <= left_over:
                    mask[top:top + bh, left:left + bw] = True
                    added = new
            if added > 0:
                break
        if added == 0:
            break
        count += added
    return mask


def infos(labels: dict, clips: torch.Tensor, gen: torch.Generator) -> dict:
    b, k = clips.shape[:2]
    t, h, w = labels["grid"]
    per_frame = int(round(labels["ratio"] * t * h * w)) // t
    u = _Uniforms(gen)
    masks = np.stack([frame_mask(h, w, per_frame, u) for _ in range(b * k * t)])
    return {"mask": torch.from_numpy(masks.reshape(b, k, t, h, w)).to(clips.device)}
