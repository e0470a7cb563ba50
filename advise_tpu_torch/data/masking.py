"""BEiT-style block masking generators (host side, numpy): the port's own
copy of ``advise_tpu/data/masking.py`` (the port imports nothing of the JAX
package), held equal to it by tests/test_torch_masked.py.

MaskingGenerator retries random log-uniform-area blocks until the target
number of masked patches is reached; MaskingGenerator3D draws one such 2D
mask per frame.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


class MaskingGenerator:
    """2D block masking (reference transform.py MaskingGenerator)."""

    def __init__(
        self,
        input_size,
        num_masking_patches: int,
        min_num_patches: int = 4,
        max_num_patches: Optional[int] = None,
        min_aspect: float = 0.3,
        max_aspect: Optional[float] = None,
    ):
        if isinstance(input_size, int):
            input_size = (input_size, input_size)
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (
            num_masking_patches if max_num_patches is None else max_num_patches
        )
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _mask_block(self, mask: np.ndarray, max_mask_patches: int, rng) -> int:
        delta = 0
        for _ in range(10):
            # random.uniform tolerates reversed bounds; np doesn't
            hi = max(max_mask_patches, self.min_num_patches)
            target_area = rng.uniform(self.min_num_patches, hi)
            aspect = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = rng.integers(0, self.height - h)
                left = rng.integers(0, self.width - w)
                num_masked = mask[top : top + h, left : left + w].sum()
                if 0 < h * w - num_masked <= max_mask_patches:
                    mask[top : top + h, left : left + w] = 1
                    delta = h * w - num_masked
            if delta > 0:
                break
        return int(delta)

    def __call__(self, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        mask = np.zeros((self.height, self.width), np.int32)
        count = 0
        while count < self.num_masking_patches:
            max_patches = min(
                self.num_masking_patches - count, self.max_num_patches
            )
            delta = self._mask_block(mask, max_patches, rng)
            if delta == 0:
                break
            count += delta
        return mask


class MaskingGenerator3D(MaskingGenerator):
    """Per-frame 2D block masks stacked over time (reference
    MaskingGenerator3D)."""

    def __init__(self, input_size, num_masking_patches, **kw):
        t, h, w = input_size
        super().__init__((h, w), num_masking_patches // t, **kw)
        self.temporal = t

    def __call__(self, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        return np.stack(
            [super(MaskingGenerator3D, self).__call__(rng) for _ in range(self.temporal)]
        )


def build_mask_generator(cfg) -> MaskingGenerator3D:
    """The train loader's generator for MASK.MAE_RND_MASK False: block masks
    on the token grid (NUM_FRAMES / pt, TARGET_SIZE / ph, TARGET_SIZE / pw)
    covering round(AUG.MASK_RATIO * tokens) tokens (the JAX package's
    ``data/__init__.py build_dataset``)."""
    pt, ph, pw = cfg.MVIT.PATCH_STRIDE
    grid = (max(cfg.DATA.NUM_FRAMES // pt, 1), cfg.AUG.TARGET_SIZE // ph,
            cfg.AUG.TARGET_SIZE // pw)
    total = grid[0] * grid[1] * grid[2]
    return MaskingGenerator3D(grid, int(round(cfg.AUG.MASK_RATIO * total)),
                              max_num_patches=(cfg.AUG.MAX_MASK_PATCHES_PER_BLOCK or None))
