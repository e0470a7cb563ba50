"""Random erasing and the Gaussian blur (counterpart of
``advise_tpu/data/erasing.py`` ``random_erasing_clip`` and
``gaussian_blur_clip``).

Erasing, cube mode: one region for all frames of a clip. Mode 'pixel'
fills the region with per-pixel noise ``normal * 64 + 128``, clipped to
[0, 255]. The noise is drawn only where it lands: one [T, eh, ew, C] block
per erased clip.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from advise_tpu_torch.data.device_aug import uniform_from


BLUR_RADIUS = 4  # the JAX blur's static kernel radius


def gaussian_blur_clips(clips: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable spatial Gaussian blur of float clips [N, T, H, W, C], each
    clip with its own sigma [N]: a 9-tap kernel exp(-x^2 / (2 max(sigma,
    1e-3)^2)) normalised to sum 1, over H and then over W of the
    edge-padded clip, the taps summed in order as the JAX function sums
    them."""
    r = BLUR_RADIUS
    dev = clips.device
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    k = torch.exp(-0.5 * (xs[None, :] / torch.clamp(sigma.to(dev, torch.float32), min=1e-3)[:, None]) ** 2)
    k = k / k.sum(dim=1, keepdim=True)
    k = k.view(-1, 2 * r + 1, 1, 1, 1, 1)  # [N, taps, 1, 1, 1, 1]

    def one_axis(x, axis):
        n = x.shape[axis]
        idx = torch.arange(-r, n + r, device=dev).clamp(0, n - 1)
        xp = x.index_select(axis, idx)
        out = k[:, 0] * xp.narrow(axis, 0, n)
        for i in range(1, 2 * r + 1):
            out = out + k[:, i] * xp.narrow(axis, i, n)
        return out

    return one_axis(one_axis(clips, 2), 3)


class RandomErasing:
    def __init__(self, probability: float = 0.25, mode: str = "pixel",
                 min_area: float = 0.02, max_area: float = 1 / 3,
                 min_aspect: float = 0.3, count: int = 1):
        if mode != "pixel" or count != 1:
            raise NotImplementedError(f"erasing mode={mode} count={count} is not ported yet")
        self.probability = probability
        self.min_area, self.max_area = min_area, max_area
        self.log_aspect = (math.log(min_aspect), math.log(1.0 / min_aspect))

    def region_from_uniforms(self, u_apply, u_area, u_aspect, u_top, u_left,
                             h: int, w: int) -> torch.Tensor:
        """[N, 5] (apply, top, left, eh, ew) from uniform [0, 1) draws [N]."""
        area = h * w * uniform_from(u_area, self.min_area, self.max_area)
        aspect = torch.exp(uniform_from(u_aspect, *self.log_aspect))
        eh = torch.clamp(torch.round(torch.sqrt(area * aspect)), max=h - 1)
        ew = torch.clamp(torch.round(torch.sqrt(area / aspect)), max=w - 1)
        top = torch.floor(u_top * (h - eh))
        left = torch.floor(u_left * (w - ew))
        apply = (u_apply < self.probability).to(torch.float32)
        return torch.stack([apply, top, left, eh, ew], dim=1)

    def sample(self, n: int, clip_shape, generator: torch.Generator) -> Dict[str, Any]:
        """{'region': [N, 5], 'noise': per clip a [T, eh, ew, C] normal block,
        or None where the clip is not erased}."""
        t, h, w, c = clip_shape
        dev = generator.device
        u = [torch.rand(n, generator=generator, device=dev) for _ in range(5)]
        region = self.region_from_uniforms(*u, h, w)
        noise: List[Optional[torch.Tensor]] = []
        for apply, _, _, eh, ew in region.tolist():
            noise.append(
                torch.randn((t, int(eh), int(ew), c), generator=generator, device=dev)
                if apply else None
            )
        return {"region": region, "noise": noise}

    def apply(self, clips: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        """clips [N, T, H, W, C] float; erased regions set in place."""
        for i, (apply, top, left, eh, ew) in enumerate(params["region"].tolist()):
            if not apply:
                continue
            top, left, eh, ew = int(top), int(left), int(eh), int(ew)
            fill = torch.clamp(params["noise"][i].to(clips.device) * 64.0 + 128.0, 0, 255)
            clips[i, :, top:top + eh, left:left + ew, :] = fill
        return clips
