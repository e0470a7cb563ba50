"""On-device augmentation (counterpart of ``advise_tpu/data/device_aug.py``):
the train pipelines 'aa' with AUG.FUSED_RA, 'simple' (the fused kernel
with TPU.PALLAS_AUG, else the XLA path), 'OnlyCrop' (RandomResizedCrop +
normalize), 'rbyol' (the MoCo-v2 / BYOL stack), 'clip_aug' (the crop with
camera dynamics) and 'none' (normalize only);
the speed_val pipeline (the RRC with VAL's size, scale and ratio) and the
inference crop.

uint8 ``[B, K, T, H, W, C]`` at the ingest geometry goes in, and float32
or, with TPU.AUG_COMPUTE_OUT under bf16, bfloat16 comes out. All frames of
a clip share its parameters.

- 'aa': per clip, RandomResizedCrop, RandAugment (with AUG.FUSED_RA one
  composed bilinear warp, then the color ops, the flip inside the warp;
  otherwise op by op at AUG.INTERPOLATION, then the flip), RandomErasing
  and normalize.
- 'simple': the fixed Resize happened at ingest; per clip, a random crop,
  the colour jitter and normalize: in one kernel (``ops/fused_aug.py``)
  with TPU.PALLAS_AUG, else op by op (:func:`color_jitter`), each op's
  luma and contrast mean from the current image and a real hue rotation.
- 'OnlyCrop': per clip, RandomResizedCrop with scale (AUG.MIN_AREA, 1) as
  ``jax.image.scale_and_translate`` computes it (linear, antialiased: one
  weight matrix per axis), clip to [0, 255], normalize. Mode 'speed' runs
  the same crop at VAL.TARGET_SIZE with scale (VAL.MIN_AREA, 1) and
  VAL.RAND_CROP_RATIO.
- 'rbyol': per clip, RandomResizedCrop with scale (AUG.MIN_AREA, 1) (or,
  with AUG.TRAIN_JITTER_MOTION_SHIFT, per frame a box between two drawn
  boxes, floored to the grid), clip to [0, 255], the colour jitter of
  AUG.COLOR with a real hue, grayscale with probability AUG.GRAYSCALE, the
  Gaussian blur with probability 0.5, the flip with AUG.RANDOM_FLIP,
  normalize.
- 'clip_aug': per clip, one RandomResizedCrop box moved, zoomed and shaken
  frame by frame, each frame's box resized, clip to [0, 255], the ramped
  brightness, saturation and white balance, normalize.
- mode 'action': per clip, a random INFER.RES square crop (the ingest
  resized the short side to INFER.RES), normalize.

Every pipeline normalizes as the jitted JAX step does: (x - mean) times
float32(1 / std).

Each pipeline is split into sampling (``sample``, from an explicit
``torch.Generator`` on the clips' device) and applying (``apply``), so a
test can hand the apply the parameters the JAX code drew.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

LUMA = (0.299, 0.587, 0.114)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """PIL's uint8 store after each enhance op: round half up, clip."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add. Evaluated
    in float64: for the colour ops' operands (a float32 times an integer of
    at most 9 bits, plus a value below 2^10) that holds the exact result;
    for the HSV products (two float32 values in [0, 1], plus 1) it can
    round twice only where the float64 result falls exactly on a float32
    tie."""
    a, b, c = (torch.as_tensor(v).double() for v in (a, b, c))
    return (a * b + c).float()


def _luma(x: torch.Tensor) -> torch.Tensor:
    """PIL 'L' conversion: truncating integer luma of [..., 3]. The JAX
    package's ``x @ LUMA`` evaluates, eagerly and under jit alike, as
    fma(b, 0.114, fma(g, 0.587, r * 0.299)) in float32."""
    k = torch.tensor(LUMA, dtype=torch.float32, device=x.device)
    return torch.floor(_fma(x[..., 2], k[2], _fma(x[..., 1], k[1], x[..., 0] * k[0])))


def _blend(base: torch.Tensor, factor, x: torch.Tensor, contract: bool) -> torch.Tensor:
    """base + factor * (x - base), rounded to uint8: as one fused
    multiply-add when ``contract`` (XLA's code for the op inside a jitted
    program), else the product and the sum rounded apart (eager JAX)."""
    if contract:
        return _round_u8(_fma(factor, x - base, base))
    return _round_u8(base + factor * (x - base))


# colour ops on clips [N, T, H, W, C] in float [0, 255], with factors that
# broadcast against them; each takes its luma and contrast mean from the
# image it is given (the current one in a chain)


def adjust_brightness(clip: torch.Tensor, factor, contract: bool = False) -> torch.Tensor:
    if contract:
        return torch.clamp(torch.floor(_fma(clip, factor, 0.5)), 0.0, 255.0)
    return _round_u8(clip * factor)


def contrast_mean(clip: torch.Tensor) -> torch.Tensor:
    """Each frame's rounded mean luma [N, T, 1, 1, 1]: the integer luma sum
    (exact in float32 while H * W <= 65792) times float32(1 / (H * W)), as
    XLA evaluates ``jnp.mean``."""
    area = clip.shape[2] * clip.shape[3]
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(area))
    total = torch.sum(_luma(clip), dim=(2, 3), keepdim=True)
    return torch.floor(total * inv.to(clip.device) + 0.5)[..., None]


def adjust_contrast(clip: torch.Tensor, factor, contract: bool = False) -> torch.Tensor:
    """Blend with each frame's rounded mean luma."""
    return _blend(contrast_mean(clip), factor, clip, contract)


def adjust_saturation(clip: torch.Tensor, factor, contract: bool = False) -> torch.Tensor:
    return _blend(_luma(clip)[..., None], factor, clip, contract)


def rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in [0, 1] -> (h, s, v) in [0, 1], float32, rounded as
    the jitted JAX program rounds it (h / 6 is h times float32(1 / 6))."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    d = mx - mn
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(
        mx == r,
        torch.remainder((g - b) / safe_d, 6.0),
        torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0),
    )
    sixth = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(6.0)
    h = torch.where(d == 0, torch.zeros_like(h), h * sixth.to(x.device))
    s = torch.where(mx == 0, torch.zeros_like(d), d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] (h, s, v) in [0, 1] -> RGB in [0, 1]: the sextant ``i`` of
    h picks each channel from (v, q, p, p, t, v) rotated. As in the jitted
    JAX program, 1 - f s and 1 - (1 - f) s are fused multiply-adds."""
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * _fma(-f, s, 1.0)
    t = v * _fma(f - 1.0, s, 1.0)
    i = torch.remainder(i.to(torch.int32), 6)
    table = torch.stack([v, q, p, p, t, v, t, v, v, q, p, p, p, p, t, v, v, q], dim=-1)
    idx = torch.stack([i, i + 6, i + 12], dim=-1).long()
    return torch.gather(table, -1, idx)


def adjust_hue(clip: torch.Tensor, shift_u8) -> torch.Tensor:
    """Rotate hue by shift_u8 / 255 of a turn (PIL's uint8 HSV scale);
    ``shift_u8`` broadcasts against ``clip`` as the other ops' factors do."""
    hsv = rgb_to_hsv(clip / 255.0)
    shift = torch.as_tensor(shift_u8, dtype=torch.float32, device=clip.device)
    if shift.ndim == clip.ndim:
        shift = shift[..., 0]
    h = torch.remainder(hsv[..., 0] + shift / 255.0, 1.0)
    out = hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))
    return _round_u8(out * 255.0)


def uniform_from(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """A uniform draw on [lo, hi) from a [0, 1) draw ``u``, in float32 the
    way ``jax.random.uniform`` scales it, so injected JAX draws give the same
    values."""
    lo = torch.as_tensor(lo, dtype=torch.float32).to(u.device)
    hi = torch.as_tensor(hi, dtype=torch.float32).to(u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def rrc_box_from_uniforms(u_area, u_ratio, u_top, u_left, h: int, w: int,
                          scale, ratio) -> torch.Tensor:
    """torchvision RandomResizedCrop box from uniform [0, 1) draws of shape
    [N, attempts] each: the first attempt that fits, else the centre-crop
    fallback. Returns [N, 4] float (top, left, height, width)."""
    area = h * w
    target_area = area * uniform_from(u_area, scale[0], scale[1])
    log_ratio = torch.log(torch.tensor(ratio, dtype=torch.float32))
    aspect = torch.exp(uniform_from(u_ratio, log_ratio[0], log_ratio[1]))
    ws = torch.round(torch.sqrt(target_area * aspect))
    hs = torch.round(torch.sqrt(target_area / aspect))
    ok = (ws <= w) & (hs <= h)
    tops = torch.floor(u_top * (h - hs + 1))
    lefts = torch.floor(u_left * (w - ws + 1))
    idx = torch.argmax(ok.to(torch.int8), dim=1, keepdim=True)
    any_ok = ok.any(dim=1)
    in_ratio = w / h
    if in_ratio < ratio[0]:
        fb_w, fb_h = w, round(w / ratio[0])
    elif in_ratio > ratio[1]:
        fb_w, fb_h = round(h * ratio[1]), h
    else:
        fb_w, fb_h = w, h
    fb = torch.tensor([round((h - fb_h) / 2.0), round((w - fb_w) / 2.0), fb_h, fb_w],
                      dtype=torch.float32, device=u_area.device)
    picked = torch.stack([t.gather(1, idx)[:, 0] for t in (tops, lefts, hs, ws)], dim=1)
    return torch.where(any_ok[:, None], picked, fb)


def sample_rrc_box(n: int, h: int, w: int, scale, ratio, generator: torch.Generator,
                   n_attempts: int = 10) -> torch.Tensor:
    dev = generator.device
    u = [torch.rand((n, n_attempts), generator=generator, device=dev) for _ in range(4)]
    return rrc_box_from_uniforms(*u, h, w, scale, ratio)


def normalize(x: torch.Tensor, mean, std, by_reciprocal: bool = False) -> torch.Tensor:
    """[0, 255] -> ImageNet-normalized float32: (x - mean) / std, or with
    ``by_reciprocal`` (x - mean) * float32(1 / std), which is what XLA makes
    of the division by a constant inside a jitted program."""
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    if by_reciprocal:
        return (x - m) * (1.0 / s)
    return (x - m) / s


def aug_out_dtype(cfg) -> torch.dtype:
    """Emission dtype (TPU.AUG_COMPUTE_OUT): bf16 when the step computes in
    bf16 and the knob is on; the per-clip math stays float32."""
    if cfg.TPU.AUG_COMPUTE_OUT and cfg.TPU.COMPUTE_DTYPE == "bfloat16":
        return torch.bfloat16
    return torch.float32


class AAAug:
    """AUG.TYPE 'aa': ``aug(batch_u8, generator)``, or ``apply(batch_u8,
    sample(...))`` with parameters from elsewhere. Both paths draw the same
    parameters: the RRC box, the RandAugment plan, the flip and the erasing.

    - AUG.FUSED_RA: the RRC, the plan's geometric ops and the flip as one
      bilinear gather, then the color ops.
    - Otherwise the op-exact path: the RRC resized as OnlyCrop resizes it
      and clipped to [0, 255], every RandAugment op in turn at
      AUG.INTERPOLATION (``rand_augment.ExactRandAugment``), then the flip.

    Then RandomErasing at AUG.RE_PROB and normalize by the reciprocal."""

    def __init__(self, cfg):
        from advise_tpu_torch.data.erasing import RandomErasing
        from advise_tpu_torch.data.rand_augment import ExactRandAugment, FusedRandAugment

        if cfg.AUG.RA_BATCHED and cfg.AUG.FUSED_RA:
            raise NotImplementedError("AUG.RA_BATCHED is a TPU layout of the same math")
        self.size = int(cfg.AUG.TARGET_SIZE)
        self.scale = (cfg.AUG.MIN_AREA, cfg.AUG.MAX_AREA)
        self.ratio = tuple(cfg.AUG.RAND_CROP_RATIO)
        self.random_flip = cfg.AUG.RANDOM_FLIP
        self.mean, self.std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
        self.out_dtype = aug_out_dtype(cfg)
        self.fused = bool(cfg.AUG.FUSED_RA)
        self.ra = (FusedRandAugment(cfg.AUG.AA_TYPE) if self.fused
                   else ExactRandAugment(cfg.AUG.AA_TYPE, interpolation=cfg.AUG.INTERPOLATION))
        self.erasing = (
            RandomErasing(cfg.AUG.RE_PROB, cfg.AUG.RE_MODE, count=cfg.AUG.RE_COUNT)
            if cfg.AUG.RE_PROB > 0 else None
        )

    def sample(self, n: int, t: int, h: int, w: int, c: int,
               generator: torch.Generator) -> Dict[str, Any]:
        """Parameters for n clips of [t, h, w, c]."""
        dev = generator.device
        params: Dict[str, Any] = {
            "box": sample_rrc_box(n, h, w, self.scale, self.ratio, generator),
            "plan": self.ra.sample(n, generator),
            "flip": (
                torch.rand(n, generator=generator, device=dev) < 0.5
                if self.random_flip else torch.zeros(n, dtype=torch.bool, device=dev)
            ),
        }
        if self.erasing is not None:
            params["erase"] = self.erasing.sample(n, (t, self.size, self.size, c), generator)
        return params

    def _fused(self, flat: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        from advise_tpu_torch.data.rand_augment import fused_warp_coords, warp_gather

        dev = flat.device
        sx, sy, valid = fused_warp_coords(
            {kk: v.to(dev) for kk, v in params["plan"].items()},
            params["box"].to(dev), params["flip"].to(dev), self.size,
        )
        return self.ra.color_apply(warp_gather(flat, sx, sy, valid), params["plan"])

    def _exact(self, flat: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        clips = torch.clamp(resized_crop_clips(flat.to(torch.float32), params["box"], self.size), 0.0, 255.0)
        clips = self.ra.apply(clips, params["plan"])
        flip = params["flip"].to(clips.device).view(-1, 1, 1, 1, 1)
        return torch.where(flip, clips.flip(3), clips)

    def apply(self, batch_u8: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        b, k = batch_u8.shape[:2]
        flat = batch_u8.reshape(b * k, *batch_u8.shape[2:])
        clips = self._fused(flat, params) if self.fused else self._exact(flat, params)
        if self.erasing is not None:
            clips = self.erasing.apply(clips, params["erase"])
        out = normalize(clips, self.mean, self.std, by_reciprocal=True).to(self.out_dtype)
        return out.reshape(b, k, *out.shape[1:])

    def __call__(self, batch_u8: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        b, k, t, h, w, c = batch_u8.shape
        return self.apply(batch_u8, self.sample(b * k, t, h, w, c, generator))


def color_jitter(clips: torch.Tensor, params: Dict[str, torch.Tensor], hue: bool) -> torch.Tensor:
    """RandomColorJitter on float clips [N, T, H, W, C] (``color_jitter_clip``
    of the JAX package): per clip, brightness, contrast, saturation and hue
    (codes 0-3) in the order ``params['order']`` [N, 4], the whole chain kept
    where ``params['apply']`` is set. Each op sees the image the previous one
    left, and rounds its blends as the jitted JAX program does. Every op runs
    on every clip and a select keeps the clip's own, as JAX's vmapped switch
    does; with ``hue`` False (h == 0) the hue op is the identity."""
    dev = clips.device
    bc = (-1,) + (1,) * (clips.ndim - 1)
    bf, cf, sf, hf = (params[k].to(dev, torch.float32).view(bc) for k in ("bfac", "cfac", "sfac", "hfac"))
    ops = [
        lambda y: adjust_brightness(y, bf, contract=True),
        lambda y: adjust_contrast(y, cf, contract=True),
        lambda y: adjust_saturation(y, sf, contract=True),
    ]
    if hue:
        ops.append(lambda y: adjust_hue(y, hf))
    order = params["order"].to(dev).long()
    y = clips
    for pos in range(order.shape[1]):
        for code, op in enumerate(ops):
            y = torch.where((order[:, pos] == code).view(bc), op(y), y)
    return torch.where((params["apply"].to(dev) > 0).view(bc), y, clips)


class SimpleAug:
    """AUG.TYPE 'simple' (``make_simple_train_aug``): ``aug(batch_u8,
    generator)``, or ``apply(batch_u8, sample(...))`` with parameters from
    elsewhere. Per clip: a random crop of AUG.TARGET_SIZE, the colour jitter
    of AUG.COLOR (p, brightness, contrast, saturation, hue), normalize.

    - TPU.PALLAS_AUG: the fused kernel (``ops/fused_aug.py``), which takes
      its luma and contrast mean from the raw crop and skips hue.
    - Otherwise the XLA path: :func:`color_jitter`, each op on the current
      image, with a real hue rotation unless AUG.REFERENCE_EXACT_HUE sets h
      to 0 (the reference's own hue is a no-op)."""

    def __init__(self, cfg):
        self.size = int(cfg.AUG.TARGET_SIZE)
        self.pallas = bool(cfg.TPU.PALLAS_AUG)
        p, b, c, s, h = (float(v) for v in cfg.AUG.COLOR)
        if cfg.AUG.REFERENCE_EXACT_HUE:
            h = 0.0
        self.color = tuple(cfg.AUG.COLOR) if self.pallas else (p, b, c, s, h)
        self.mean, self.std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
        self.out_dtype = aug_out_dtype(cfg)

    def sample(self, n: int, t: int, h: int, w: int, c: int,
               generator: torch.Generator) -> Dict[str, Any]:
        """Parameters for n clips of [t, h, w, c]: crop offsets ``tops`` and
        ``lefts``, factors ``bfac``, ``cfac``, ``sfac`` (and on the XLA path
        the hue shift ``hfac``, uniform on [-h, h)), ``apply`` and ``order``."""
        from advise_tpu_torch.ops.fused_aug import sample_simple_aug

        params = sample_simple_aug(n, h, w, self.size, self.color, generator)
        if not self.pallas:
            u = torch.rand(n, generator=generator, device=generator.device)
            params["hfac"] = uniform_from(u, -self.color[4], self.color[4])
        return params

    def apply(self, batch_u8: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        from advise_tpu_torch.ops.fused_aug import crop_windows, fused_simple_aug

        b, k = batch_u8.shape[:2]
        flat = batch_u8.reshape(b * k, *batch_u8.shape[2:])
        if self.pallas:
            out = fused_simple_aug(flat, params, self.size, self.mean, self.std, self.out_dtype)
        else:
            clips = crop_windows(flat, params["tops"], params["lefts"], self.size)
            clips = color_jitter(clips, params, hue=self.color[4] != 0.0)
            out = normalize(clips, self.mean, self.std, by_reciprocal=True).to(self.out_dtype)
        return out.reshape(b, k, *out.shape[1:])

    def __call__(self, batch_u8: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        b, k, t, h, w, c = batch_u8.shape
        return self.apply(batch_u8, self.sample(b * k, t, h, w, c, generator))


class NoAug:
    """AUG.TYPE 'none': normalize the uint8 clips as they are."""

    def __init__(self, cfg):
        self.mean, self.std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
        self.out_dtype = aug_out_dtype(cfg)

    def sample(self, n: int, t: int, h: int, w: int, c: int,
               generator: torch.Generator) -> Dict[str, Any]:
        return {}

    def apply(self, batch_u8: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        return normalize(batch_u8.float(), self.mean, self.std, by_reciprocal=True).to(self.out_dtype)

    def __call__(self, batch_u8: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return self.apply(batch_u8, {})


def resize_weights(in_size: int, out_size: int, scale: torch.Tensor,
                   translation: torch.Tensor) -> torch.Tensor:
    """Per-clip [N, in_size, out_size] weights of ``jax.image``'s
    ``compute_weight_mat`` with the triangle kernel and antialiasing: the
    kernel widened by the downscale factor, columns normalised, and zero
    where the sample falls outside the input. ``scale`` and ``translation``
    are float32 [N]."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    sample_f = out_pos[None, :] * inv_scale[:, None] - (translation * inv_scale)[:, None] - 0.5
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = torch.abs(sample_f[:, None, :] - in_pos[None, :, None]) / kernel_scale[:, None, None]
    weights = torch.clamp(1.0 - x, min=0.0)
    total = torch.sum(weights, dim=1, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def resized_crop_clips(clips: torch.Tensor, boxes: torch.Tensor, size: int) -> torch.Tensor:
    """float32 clips [N, T, H, W, C] -> [N, T, size, size, C]: each clip's box
    (top, left, height, width) resized as ``jax.image.scale_and_translate``
    with scale (size / height, size / width) and translation -(top, left) *
    scale, linear and antialiased."""
    top, left, bh, bw = (boxes[:, i].to(clips.device, torch.float32) for i in range(4))
    wh = resize_weights(clips.shape[2], size, size / bh, -top * size / bh)
    ww = resize_weights(clips.shape[3], size, size / bw, -left * size / bw)
    out = torch.einsum("nthwc,nhy->ntywc", clips, wh)
    return torch.einsum("ntywc,nwx->ntyxc", out, ww)


def sample_crop_offsets(n: int, h: int, w: int, size: int,
                        generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Per-clip offsets of a fixed-size crop (``random_crop_clip``): ``tops``
    uniform in [0, h - size) and ``lefts`` in [0, w - size), 0 where the dim
    equals the size."""
    dev = generator.device
    return {name: torch.randint(0, max(dim - size, 1), (n,), generator=generator, device=dev,
                                dtype=torch.int32)
            for name, dim in (("tops", h), ("lefts", w))}


class RRCAug:
    """RandomResizedCrop + normalize (``make_rrc_aug``): AUG.TYPE 'OnlyCrop'
    (AUG.TARGET_SIZE, scale (AUG.MIN_AREA, 1), AUG.RAND_CROP_RATIO) by
    default, or the given size, scale and ratio (mode 'speed'), with a
    horizontal flip of half the clips when ``random_flip``:
    ``aug(batch_u8, generator)``, or ``apply(batch_u8, sample(...))`` with
    boxes (and flips) from elsewhere."""

    def __init__(self, cfg, size: Optional[int] = None, scale=None, ratio=None,
                 random_flip: bool = False):
        self.size = int(size if size is not None else cfg.AUG.TARGET_SIZE)
        self.scale = tuple(scale if scale is not None else (cfg.AUG.MIN_AREA, 1.0))
        self.ratio = tuple(ratio if ratio is not None else cfg.AUG.RAND_CROP_RATIO)
        self.random_flip = random_flip
        self.mean, self.std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
        self.out_dtype = aug_out_dtype(cfg)

    def sample(self, n: int, t: int, h: int, w: int, c: int,
               generator: torch.Generator) -> Dict[str, Any]:
        params = {"box": sample_rrc_box(n, h, w, self.scale, self.ratio, generator)}
        if self.random_flip:
            params["flip"] = torch.rand(n, generator=generator, device=generator.device) < 0.5
        return params

    def apply(self, batch_u8: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        b, k = batch_u8.shape[:2]
        flat = batch_u8.reshape(b * k, *batch_u8.shape[2:]).float()
        clips = resized_crop_clips(flat, params["box"], self.size)
        if self.random_flip:
            flip = params["flip"].to(clips.device).view(-1, 1, 1, 1, 1)
            clips = torch.where(flip, clips.flip(3), clips)
        clips = torch.clamp(clips, 0.0, 255.0)
        out = normalize(clips, self.mean, self.std, by_reciprocal=True).to(self.out_dtype)
        return out.reshape(b, k, *out.shape[1:])

    def __call__(self, batch_u8: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        b, k, t, h, w, c = batch_u8.shape
        return self.apply(batch_u8, self.sample(b * k, t, h, w, c, generator))


class InferAug:
    """The inference crop (``make_infer_aug``): per clip a random square crop
    of INFER.RES (:func:`sample_crop_offsets`), normalize.
    ``aug(batch_u8, generator)``, or ``apply(batch_u8, sample(...))`` with
    offsets from elsewhere."""

    def __init__(self, cfg):
        self.size = int(cfg.INFER.RES)
        self.mean, self.std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
        self.out_dtype = aug_out_dtype(cfg)

    def sample(self, n: int, t: int, h: int, w: int, c: int,
               generator: torch.Generator) -> Dict[str, Any]:
        return sample_crop_offsets(n, h, w, self.size, generator)

    def apply(self, batch_u8: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        from advise_tpu_torch.ops.fused_aug import crop_windows

        b, k = batch_u8.shape[:2]
        flat = batch_u8.reshape(b * k, *batch_u8.shape[2:])
        clips = crop_windows(flat, params["tops"], params["lefts"], self.size)
        out = normalize(clips, self.mean, self.std, by_reciprocal=True).to(self.out_dtype)
        return out.reshape(b, k, *out.shape[1:])

    def __call__(self, batch_u8: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        b, k, t, h, w, c = batch_u8.shape
        return self.apply(batch_u8, self.sample(b * k, t, h, w, c, generator))


def motion_boxes(b1: torch.Tensor, b2: torch.Tensor, t: int) -> torch.Tensor:
    """Per-frame boxes [N, t, 4] between boxes ``b1`` and ``b2`` [N, 4]:
    b1 (1 - a) + b2 a at a = linspace(0, 1, t), floored to the integer grid.
    The sum is one fused multiply-add, as XLA emits it in the jitted JAX
    program (``motion_shift_boxes``)."""
    alpha = torch.linspace(0.0, 1.0, t, dtype=torch.float32, device=b1.device)[None, :, None]
    return torch.floor(_fma(b2[:, None], alpha, b1[:, None] * (1 - alpha)))


def resized_crop_clip_boxes(clips: torch.Tensor, boxes: torch.Tensor, size: int) -> torch.Tensor:
    """:func:`resized_crop_clips` with a box per frame: boxes [N, T, 4]."""
    n, t = boxes.shape[:2]
    top, left, bh, bw = (boxes[..., i].reshape(-1).to(clips.device, torch.float32) for i in range(4))
    wh = resize_weights(clips.shape[2], size, size / bh, -top * size / bh).view(n, t, -1, size)
    ww = resize_weights(clips.shape[3], size, size / bw, -left * size / bw).view(n, t, -1, size)
    out = torch.einsum("nthwc,nthy->ntywc", clips, wh)
    return torch.einsum("ntywc,ntwx->ntyxc", out, ww)


def grayscale(clips: torch.Tensor, gray: torch.Tensor) -> torch.Tensor:
    """RandomGrayscale: the PIL 'L' luma replicated to the 3 channels where
    ``gray`` [N] is set."""
    luma = _luma(clips)[..., None].expand(clips.shape)
    return torch.where(gray.to(clips.device).view(-1, 1, 1, 1, 1), luma, clips)


class RByolAug:
    """AUG.TYPE 'rbyol' (``make_rbyol_aug``): ``aug(batch_u8, generator)``,
    or ``apply(batch_u8, sample(...))`` with parameters from elsewhere."""

    def __init__(self, cfg):
        self.size = int(cfg.AUG.TARGET_SIZE)
        self.scale = (cfg.AUG.MIN_AREA, 1.0)
        self.ratio = tuple(cfg.AUG.RAND_CROP_RATIO)
        self.motion_shift = bool(cfg.AUG.TRAIN_JITTER_MOTION_SHIFT)
        self.color = tuple(float(v) for v in cfg.AUG.COLOR)
        self.gray_p = float(cfg.AUG.GRAYSCALE)
        self.sigma = (float(cfg.AUG.SSL_BLUR_SIGMA_MIN[1]), float(cfg.AUG.SSL_BLUR_SIGMA_MAX[1]))
        self.random_flip = bool(cfg.AUG.RANDOM_FLIP)
        self.mean, self.std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
        self.out_dtype = aug_out_dtype(cfg)

    def sample(self, n: int, t: int, h: int, w: int, c: int,
               generator: torch.Generator) -> Dict[str, Any]:
        """Parameters for n clips of [t, h, w, c]: ``box`` [N, 4] (or with
        motion shift ``boxes`` [N, t, 4]); the colour jitter's ``bfac``,
        ``cfac``, ``sfac``, ``hfac``, ``apply`` and ``order``; ``gray``,
        ``sigma``, ``blur`` and ``flip`` [N]."""
        dev = generator.device

        def rand(*shape):
            return torch.rand((n, *shape), generator=generator, device=dev)

        if self.motion_shift:
            b1, b2 = (sample_rrc_box(n, h, w, self.scale, self.ratio, generator) for _ in range(2))
            params: Dict[str, Any] = {"boxes": motion_boxes(b1, b2, t)}
        else:
            params = {"box": sample_rrc_box(n, h, w, self.scale, self.ratio, generator)}
        p, bj, cj, sj, hj = self.color
        params["bfac"] = uniform_from(rand(), max(0.0, 1 - bj), 1 + bj)
        params["cfac"] = uniform_from(rand(), max(0.0, 1 - cj), 1 + cj)
        params["sfac"] = uniform_from(rand(), max(0.0, 1 - sj), 1 + sj)
        params["hfac"] = uniform_from(rand(), -hj, hj)
        params["apply"] = (rand() < p).to(torch.int32)
        params["order"] = torch.argsort(rand(4), dim=1).to(torch.int32)
        params["gray"] = rand() < self.gray_p
        params["sigma"] = uniform_from(rand(), *self.sigma)
        params["blur"] = rand() < 0.5
        params["flip"] = rand() < 0.5 if self.random_flip else torch.zeros(n, dtype=torch.bool, device=dev)
        return params

    def apply(self, batch_u8: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        from advise_tpu_torch.data.erasing import gaussian_blur_clips

        b, k = batch_u8.shape[:2]
        flat = batch_u8.reshape(b * k, *batch_u8.shape[2:]).float()
        if "boxes" in params:
            clips = resized_crop_clip_boxes(flat, params["boxes"], self.size)
        else:
            clips = resized_crop_clips(flat, params["box"], self.size)
        clips = torch.clamp(clips, 0.0, 255.0)
        clips = color_jitter(clips, params, hue=self.color[4] != 0.0)
        clips = grayscale(clips, params["gray"])
        blur = params["blur"].to(clips.device).view(-1, 1, 1, 1, 1)
        clips = torch.where(blur, gaussian_blur_clips(clips, params["sigma"]), clips)
        flip = params["flip"].to(clips.device).view(-1, 1, 1, 1, 1)
        clips = torch.where(flip, clips.flip(3), clips)
        out = normalize(clips, self.mean, self.std, by_reciprocal=True).to(self.out_dtype)
        return out.reshape(b, k, *out.shape[1:])

    def __call__(self, batch_u8: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        b, k, t, h, w, c = batch_u8.shape
        return self.apply(batch_u8, self.sample(b * k, t, h, w, c, generator))


class ClipAug:
    """AUG.TYPE 'clip_aug' (``make_clip_aug``): per clip one RandomResizedCrop
    box with scale (AUG.MIN_AREA, 1) and AUG.RAND_CROP_RATIO, the camera
    dynamics over the frames (AUG.CAMERA_SHIFT, ZOOM, CAMERA_SHAKE), the
    per-frame box crop to AUG.TARGET_SIZE, the colour ramps (AUG.COLOR_BRI,
    COLOR_SAT, WHITE_BALANCE; ``erasing.clip_random_resized_crop``), then
    normalize. ``aug(batch_u8, generator)``, or ``apply(batch_u8,
    sample(...))`` with parameters from elsewhere."""

    def __init__(self, cfg):
        self.size = int(cfg.AUG.TARGET_SIZE)
        self.scale = (cfg.AUG.MIN_AREA, 1.0)
        self.ratio = tuple(cfg.AUG.RAND_CROP_RATIO)
        self.dynamics = {"jitter": float(cfg.AUG.CAMERA_SHAKE), "shift": float(cfg.AUG.CAMERA_SHIFT),
                         "zoom": float(cfg.AUG.ZOOM), "brightness": float(cfg.AUG.COLOR_BRI),
                         "saturation": float(cfg.AUG.COLOR_SAT),
                         "white_balance": float(cfg.AUG.WHITE_BALANCE)}
        self.mean, self.std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
        self.out_dtype = aug_out_dtype(cfg)

    def sample(self, n: int, t: int, h: int, w: int, c: int,
               generator: torch.Generator) -> Dict[str, Any]:
        """Parameters for n clips of [t, h, w, c]: ``box`` [N, 4] and the
        uniform [0, 1) draws ``shift`` [N, 2], ``zoom`` [N], ``shake`` [N,
        2, t], ``bri``, ``sat`` [N] and ``wb`` [N, 3]."""
        dev = generator.device

        def rand(*shape):
            return torch.rand((n, *shape), generator=generator, device=dev)

        return {"box": sample_rrc_box(n, h, w, self.scale, self.ratio, generator),
                "shift": rand(2), "zoom": rand(), "shake": rand(2, t), "bri": rand(), "sat": rand(),
                "wb": rand(3)}

    def apply(self, batch_u8: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        from advise_tpu_torch.data.erasing import clip_random_resized_crop

        b, k = batch_u8.shape[:2]
        flat = batch_u8.reshape(b * k, *batch_u8.shape[2:]).float()
        clips = clip_random_resized_crop(flat, params, self.size, **self.dynamics)
        out = normalize(clips, self.mean, self.std, by_reciprocal=True).to(self.out_dtype)
        return out.reshape(b, k, *out.shape[1:])

    def __call__(self, batch_u8: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        b, k, t, h, w, c = batch_u8.shape
        return self.apply(batch_u8, self.sample(b * k, t, h, w, c, generator))


_TRAIN_AUGS = {"aa": AAAug, "simple": SimpleAug, "OnlyCrop": RRCAug, "rbyol": RByolAug, "clip_aug": ClipAug,
               "none": NoAug}


def _build_device_aug(cfg, mode: str):
    if mode == "train":
        if cfg.AUG.TYPE not in _TRAIN_AUGS:
            raise KeyError(f"AUG.TYPE={cfg.AUG.TYPE!r}: one of {sorted(_TRAIN_AUGS)}")
        return _TRAIN_AUGS[cfg.AUG.TYPE](cfg)
    if mode == "speed":
        return RRCAug(cfg, size=cfg.VAL.TARGET_SIZE, scale=(cfg.VAL.MIN_AREA, 1.0),
                      ratio=cfg.VAL.RAND_CROP_RATIO)
    if mode == "action":
        return InferAug(cfg)
    raise NotImplementedError(mode)


def build_device_aug(cfg, mode: str = "train"):
    """The pipeline of ``mode`` (``advise_tpu/data/device_aug.py
    build_device_aug``): 'train' by AUG.TYPE ('aa', 'simple', 'OnlyCrop',
    'rbyol', 'clip_aug', 'none'), 'speed' the RRC of VAL.*,
    'action' the INFER.RES crop. DATA.REVERSE_INPUT_CHANNEL flips the channel
    axis of the raw batch first."""
    aug = _build_device_aug(cfg, mode)
    if not cfg.DATA.REVERSE_INPUT_CHANNEL:
        return aug

    def reversed_channels(batch_u8, generator):
        return aug(batch_u8.flip(-1), generator)

    return reversed_channels


def ingest_geometry(cfg, mode: str = "train") -> Tuple[int, int]:
    """Fixed (W, H) decode geometry of ``mode``: AUG.RESIZE verbatim for a
    'simple' train aug (the reference resizes to this exact size); else a
    4:3 canvas around the crop, so crops have material to sample: around
    VAL.TARGET_SIZE for 'speed', INFER.RES for 'action', AUG.TARGET_SIZE
    for 'train'."""
    if mode == "train" and cfg.AUG.TYPE == "simple":
        return (int(cfg.AUG.RESIZE[0]), int(cfg.AUG.RESIZE[1]))
    if mode == "speed":
        s = int(cfg.VAL.TARGET_SIZE)
    elif mode == "action":
        s = int(cfg.INFER.RES)
    else:
        s = int(cfg.AUG.TARGET_SIZE)
    return (s * 4 // 3, s)
