"""On-device augmentation (counterpart of ``advise_tpu/data/device_aug.py``):
the 'aa' pipeline with AUG.FUSED_RA, the 'simple' pipeline with
TPU.PALLAS_AUG, and 'OnlyCrop' (RandomResizedCrop + normalize).

uint8 ``[B, K, T, H, W, C]`` at the ingest geometry goes in, and float32
or, with TPU.AUG_COMPUTE_OUT under bf16, bfloat16 comes out. All frames of
a clip share its parameters.

- 'aa': per clip, RandomResizedCrop, RandAugment (one composed bilinear
  warp, then the color ops), the horizontal flip (inside the warp),
  RandomErasing and normalize.
- 'simple': the fixed Resize happened at ingest; per clip, a random crop,
  the colour jitter and normalize, in one kernel (``ops/fused_aug.py``).
- 'OnlyCrop': per clip, RandomResizedCrop with scale (AUG.MIN_AREA, 1) as
  ``jax.image.scale_and_translate`` computes it (linear, antialiased: one
  weight matrix per axis), clip to [0, 255], normalize.

Each pipeline is split into sampling (``sample``, from an explicit
``torch.Generator`` on the clips' device) and applying (``apply``), so a
test can hand the apply the parameters the JAX code drew.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

LUMA = (0.299, 0.587, 0.114)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """PIL's uint8 store after each enhance op: round half up, clip."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def _luma(x: torch.Tensor) -> torch.Tensor:
    """PIL 'L' conversion: truncating integer luma of [..., 3]."""
    return torch.floor(x[..., 0] * LUMA[0] + x[..., 1] * LUMA[1] + x[..., 2] * LUMA[2])


def adjust_brightness(clip: torch.Tensor, factor) -> torch.Tensor:
    return _round_u8(clip * factor)


def adjust_contrast(clip: torch.Tensor, factor) -> torch.Tensor:
    """[N, T, H, W, C]: blend with each frame's rounded mean luma."""
    mean = torch.floor(torch.mean(_luma(clip), dim=(2, 3), keepdim=True) + 0.5)
    return _round_u8(mean[..., None] + factor * (clip - mean[..., None]))


def adjust_saturation(clip: torch.Tensor, factor) -> torch.Tensor:
    lum = _luma(clip)[..., None]
    return _round_u8(lum + factor * (clip - lum))


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


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """[0, 255] -> ImageNet-normalized float32."""
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return (x - m) / s


def aug_out_dtype(cfg) -> torch.dtype:
    """Emission dtype (TPU.AUG_COMPUTE_OUT): bf16 when the step computes in
    bf16 and the knob is on; the per-clip math stays float32."""
    if cfg.TPU.AUG_COMPUTE_OUT and cfg.TPU.COMPUTE_DTYPE == "bfloat16":
        return torch.bfloat16
    return torch.float32


class AAAug:
    """AUG.TYPE 'aa' with AUG.FUSED_RA: ``aug(batch_u8, generator)``, or
    ``apply(batch_u8, sample(...))`` with parameters from elsewhere."""

    def __init__(self, cfg):
        from advise_tpu_torch.data.erasing import RandomErasing
        from advise_tpu_torch.data.rand_augment import FusedRandAugment

        if not cfg.AUG.FUSED_RA:
            raise NotImplementedError("the op-exact RandAugment path is not ported yet")
        if cfg.AUG.RA_BATCHED:
            raise NotImplementedError("AUG.RA_BATCHED is a TPU layout of the same math")
        self.size = int(cfg.AUG.TARGET_SIZE)
        self.scale = (cfg.AUG.MIN_AREA, cfg.AUG.MAX_AREA)
        self.ratio = tuple(cfg.AUG.RAND_CROP_RATIO)
        self.random_flip = cfg.AUG.RANDOM_FLIP
        self.mean, self.std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
        self.out_dtype = aug_out_dtype(cfg)
        self.ra = FusedRandAugment(cfg.AUG.AA_TYPE)
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

    def apply(self, batch_u8: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        from advise_tpu_torch.data.rand_augment import fused_warp_coords, warp_gather

        b, k = batch_u8.shape[:2]
        flat = batch_u8.reshape(b * k, *batch_u8.shape[2:])
        dev = flat.device
        sx, sy, valid = fused_warp_coords(
            {kk: v.to(dev) for kk, v in params["plan"].items()},
            params["box"].to(dev), params["flip"].to(dev), self.size,
        )
        clips = warp_gather(flat, sx, sy, valid)
        clips = self.ra.color_apply(clips, params["plan"])
        if self.erasing is not None:
            clips = self.erasing.apply(clips, params["erase"])
        out = normalize(clips, self.mean, self.std).to(self.out_dtype)
        return out.reshape(b, k, *out.shape[1:])

    def __call__(self, batch_u8: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        b, k, t, h, w, c = batch_u8.shape
        return self.apply(batch_u8, self.sample(b * k, t, h, w, c, generator))


class SimpleAug:
    """AUG.TYPE 'simple' with TPU.PALLAS_AUG: ``aug(batch_u8, generator)``,
    or ``apply(batch_u8, sample(...))`` with parameters from elsewhere. The
    XLA path of the JAX package (TPU.PALLAS_AUG off) draws its parameters
    from other key splits and rotates hue for real; it is not ported yet."""

    def __init__(self, cfg):
        if not cfg.TPU.PALLAS_AUG:
            raise NotImplementedError("the simple aug without TPU.PALLAS_AUG is not ported yet")
        self.size = int(cfg.AUG.TARGET_SIZE)
        self.color = tuple(cfg.AUG.COLOR)
        self.mean, self.std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
        self.out_dtype = aug_out_dtype(cfg)

    def sample(self, n: int, t: int, h: int, w: int, c: int,
               generator: torch.Generator) -> Dict[str, Any]:
        """Parameters for n clips of [t, h, w, c]."""
        from advise_tpu_torch.ops.fused_aug import sample_simple_aug

        return sample_simple_aug(n, h, w, self.size, self.color, generator)

    def apply(self, batch_u8: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        from advise_tpu_torch.ops.fused_aug import fused_simple_aug

        b, k = batch_u8.shape[:2]
        flat = batch_u8.reshape(b * k, *batch_u8.shape[2:])
        out = fused_simple_aug(flat, params, self.size, self.mean, self.std, self.out_dtype)
        return out.reshape(b, k, *out.shape[1:])

    def __call__(self, batch_u8: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        b, k, t, h, w, c = batch_u8.shape
        return self.apply(batch_u8, self.sample(b * k, t, h, w, c, generator))


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


class RRCAug:
    """AUG.TYPE 'OnlyCrop' (``make_rrc_aug`` with scale (AUG.MIN_AREA, 1), no
    flip): ``aug(batch_u8, generator)``, or ``apply(batch_u8, sample(...))``
    with boxes from elsewhere."""

    def __init__(self, cfg):
        self.size = int(cfg.AUG.TARGET_SIZE)
        self.scale = (cfg.AUG.MIN_AREA, 1.0)
        self.ratio = tuple(cfg.AUG.RAND_CROP_RATIO)
        self.mean, self.std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
        self.out_dtype = aug_out_dtype(cfg)

    def sample(self, n: int, t: int, h: int, w: int, c: int,
               generator: torch.Generator) -> Dict[str, Any]:
        return {"box": sample_rrc_box(n, h, w, self.scale, self.ratio, generator)}

    def apply(self, batch_u8: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        b, k = batch_u8.shape[:2]
        flat = batch_u8.reshape(b * k, *batch_u8.shape[2:]).float()
        clips = torch.clamp(resized_crop_clips(flat, params["box"], self.size), 0.0, 255.0)
        out = normalize(clips, self.mean, self.std).to(self.out_dtype)
        return out.reshape(b, k, *out.shape[1:])

    def __call__(self, batch_u8: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        b, k, t, h, w, c = batch_u8.shape
        return self.apply(batch_u8, self.sample(b * k, t, h, w, c, generator))


_TRAIN_AUGS = {"aa": AAAug, "simple": SimpleAug, "OnlyCrop": RRCAug}


def build_device_aug(cfg, mode: str = "train"):
    """The train-mode pipeline of AUG.TYPE 'aa', 'simple' or 'OnlyCrop'
    (other AUG.TYPEs and modes are not ported yet). DATA.REVERSE_INPUT_CHANNEL flips the
    channel axis of the raw batch first."""
    if mode != "train" or cfg.AUG.TYPE not in _TRAIN_AUGS:
        raise NotImplementedError(f"device aug mode={mode} AUG.TYPE={cfg.AUG.TYPE} is not ported yet")
    aug = _TRAIN_AUGS[cfg.AUG.TYPE](cfg)
    if not cfg.DATA.REVERSE_INPUT_CHANNEL:
        return aug

    def reversed_channels(batch_u8, generator):
        return aug(batch_u8.flip(-1), generator)

    return reversed_channels


def ingest_geometry(cfg, mode: str = "train") -> Tuple[int, int]:
    """Fixed (W, H) decode geometry in train mode: AUG.RESIZE verbatim for
    'simple' (the reference resizes to this exact size), else a 4:3 canvas
    around AUG.TARGET_SIZE, so crops have material to sample (the other
    modes of the JAX ``ingest_geometry`` are not ported yet)."""
    if mode != "train":
        raise NotImplementedError(f"ingest geometry mode={mode} is not ported yet")
    if cfg.AUG.TYPE == "simple":
        return (int(cfg.AUG.RESIZE[0]), int(cfg.AUG.RESIZE[1]))
    s = int(cfg.AUG.TARGET_SIZE)
    return (s * 4 // 3, s)
