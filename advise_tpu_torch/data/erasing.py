"""Random erasing, the Gaussian blur and the camera-dynamics clip crop
(counterpart of ``advise_tpu/data/erasing.py`` ``random_erasing_clip``,
``gaussian_blur_clip`` and ``clip_random_resized_crop``).

Erasing, cube mode: each of ``count`` regions covers all frames of a clip,
the regions applied in order, each from its own draws. Mode 'pixel' fills
a region with per-pixel noise ``normal * 64 + 128``, 'rand' with one such
value per channel, 'const' with zeros; the fill is clipped to [0, 255].
The pixel noise is drawn only where it lands: one [T, eh, ew, C] block per
erased region.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from advise_tpu_torch.data.device_aug import _luma, resized_crop_clip_boxes, uniform_from


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


ERASING_MODES = ("pixel", "rand", "const")


class RandomErasing:
    def __init__(self, probability: float = 0.25, mode: str = "pixel",
                 min_area: float = 0.02, max_area: float = 1 / 3,
                 min_aspect: float = 0.3, count: int = 1):
        if mode not in ERASING_MODES:
            raise ValueError(f"erasing mode {mode!r}: one of {ERASING_MODES}")
        self.probability = probability
        self.mode = mode
        self.count = int(count)
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
        """{'region': [N, count, 5], 'noise': per clip a list of each
        region's fill draws: a [T, eh, ew, C] normal block ('pixel'), a [C]
        normal ('rand'), or None ('const', or a region not applied)}. Per
        region: 5 uniforms [N], then the fills clip by clip."""
        t, h, w, c = clip_shape
        dev = generator.device
        regions = []
        noise: List[List[Optional[torch.Tensor]]] = [[] for _ in range(n)]
        for _ in range(self.count):
            u = [torch.rand(n, generator=generator, device=dev) for _ in range(5)]
            region = self.region_from_uniforms(*u, h, w)
            regions.append(region)
            for i, (apply, _, _, eh, ew) in enumerate(region.tolist()):
                shape = {"pixel": (t, int(eh), int(ew), c), "rand": (c,)}.get(self.mode)
                noise[i].append(torch.randn(shape, generator=generator, device=dev)
                                if apply and shape else None)
        return {"region": torch.stack(regions, dim=1), "noise": noise}

    def apply(self, clips: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        """clips [N, T, H, W, C] float; erased regions set in place, region by
        region (``params`` as :meth:`sample` draws them)."""
        noise = params["noise"]
        for i, clip_regions in enumerate(params["region"].tolist()):
            for j, (apply, top, left, eh, ew) in enumerate(clip_regions):
                if not apply:
                    continue
                top, left, eh, ew = int(top), int(left), int(eh), int(ew)
                if self.mode == "const":
                    fill = 0.0
                else:
                    fill = torch.clamp(noise[i][j].to(clips.device) * 64.0 + 128.0, 0, 255)
                clips[i, :, top:top + eh, left:left + ew, :] = fill
        return clips


def clip_dynamics_boxes(boxes: torch.Tensor, params: Dict[str, torch.Tensor], t: int, h: int, w: int,
                        shift: float, zoom: float, jitter: float) -> torch.Tensor:
    """Per-frame boxes [N, T, 4] of the camera dynamics over base boxes
    ``boxes`` [N, 4] (top, left, height, width), at tt = linspace(0, 1, T):
    the corner moves linearly by up to +-``shift`` of the box
    (``params['shift']`` [N, 2]: dx, dy draws), the size scales linearly to
    1 +- ``zoom`` (``params['zoom']`` [N]), and with ``jitter`` each frame's
    corner shakes by up to +-``jitter`` of the box (``params['shake']`` [N,
    2, T]: tops, lefts); then the corner is clamped into the frame and the
    size to [8, what is left of it]. The draws are uniform [0, 1)."""
    dev = boxes.device
    tt = torch.linspace(0.0, 1.0, t, dtype=torch.float32, device=dev)[None]
    top, left, bh, bw = (boxes[:, i, None].to(torch.float32) for i in range(4))
    dx = uniform_from(params["shift"][:, 0:1].to(dev), -shift, shift) * bw
    dy = uniform_from(params["shift"][:, 1:2].to(dev), -shift, shift) * bh
    tops = top + tt * dy
    lefts = left + tt * dx
    z_end = 1.0 + uniform_from(params["zoom"][:, None].to(dev), -zoom, zoom)
    zs = 1.0 + tt * (z_end - 1.0)
    bhs, bws = bh * zs, bw * zs
    if jitter > 0:
        shake = params["shake"].to(dev)
        tops = tops + uniform_from(shake[:, 0], -jitter, jitter) * bh
        lefts = lefts + uniform_from(shake[:, 1], -jitter, jitter) * bw
    tops = torch.clamp(tops, 0.0, h - 1.0)
    lefts = torch.clamp(lefts, 0.0, w - 1.0)
    bhs = torch.minimum(torch.clamp(bhs, min=8.0), h - tops)
    bws = torch.minimum(torch.clamp(bws, min=8.0), w - lefts)
    return torch.stack([tops, lefts, bhs, bws], dim=-1)


def clip_random_resized_crop(clips: torch.Tensor, params: Dict[str, torch.Tensor], size: int,
                             jitter: float = 0.0, shift: float = 0.0, zoom: float = 0.0,
                             brightness: float = 0.0, saturation: float = 0.0,
                             white_balance: float = 0.0) -> torch.Tensor:
    """ClipRandomResizedCrop on float clips [N, T, H, W, C]: one base RRC box
    a clip (``params['box']`` [N, 4]), the per-frame boxes of
    :func:`clip_dynamics_boxes`, each frame resized from its box to ``size``
    as ``jax.image.scale_and_translate`` (linear, antialiased), the clip to
    [0, 255]. Then the temporal colour ramps, each factor going linearly
    over linspace(0, 1, T) from 1 to 1 +- its amplitude (``params['bri']``,
    ``['sat']`` [N] and ``['wb']`` [N, 3] uniform [0, 1) draws): brightness
    scales, saturation blends with the PIL luma of the clip as brightness
    left it, white balance scales each channel; a ramp of amplitude 0 is
    skipped. Then the clip to [0, 255]."""
    n, t, h, w = clips.shape[:4]
    dev = clips.device
    boxes = clip_dynamics_boxes(params["box"].to(dev), params, t, h, w, shift, zoom, jitter)
    out = torch.clamp(resized_crop_clip_boxes(clips, boxes, size), 0.0, 255.0)
    tt = torch.linspace(0.0, 1.0, t, dtype=torch.float32, device=dev)[None]
    if brightness > 0:
        b_end = 1.0 + uniform_from(params["bri"][:, None].to(dev), -brightness, brightness)
        out = out * (1.0 + tt * (b_end - 1.0))[:, :, None, None, None]
    if saturation > 0:
        s_end = 1.0 + uniform_from(params["sat"][:, None].to(dev), -saturation, saturation)
        sf = (1.0 + tt * (s_end - 1.0))[:, :, None, None, None]
        luma = _luma(out)[..., None]
        out = luma + sf * (out - luma)
    if white_balance > 0:
        wb_end = 1.0 + uniform_from(params["wb"].to(dev), -white_balance, white_balance)
        wf = 1.0 + tt[:, :, None] * (wb_end - 1.0)[:, None, :]  # [N, T, 3]
        out = out * wf[:, :, None, None, :]
    return torch.clamp(out, 0.0, 255.0)
