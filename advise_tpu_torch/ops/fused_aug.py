"""The fused 'simple' training augmentation: crop + colour jitter +
normalise, as a CUDA kernel and its plain PyTorch version.

Counterpart of ``advise_tpu/ops/pallas/fused_aug.py`` (TPU.PALLAS_AUG).
The split of the JAX function is kept: :func:`sample_simple_aug` draws the
per-clip parameters, :func:`fused_simple_aug` applies them (the kernel
``csrc/fused_aug.cu`` for a CUDA tensor, :func:`fused_simple_aug_plain`
for a CPU tensor, and raises otherwise; no fallback from a CUDA tensor).
The wrapper counts its launches in ``fused_simple_aug.launches``.

The arithmetic is the JAX reference's as XLA evaluates it on the CPU inside
jit, as the train step runs it (the source note of ``csrc/fused_aug.cu``
says why): every operation rounds to
float32, except where XLA contracts a product and a sum into one fused
multiply-add: the three colour blends and the luma that the contrast mean
sums; that mean is the luma sum times the float32 reciprocal of S^2. The
plain version evaluates each fused multiply-add in float64 and rounds once:
for this file's operands (a float32 factor >= 2^-20 times an integer, or a
luma weight times a uint8 value, plus a value below 2^10) the exact result
fits in float64's 53 bits, so that single rounding is the fused
multiply-add's.

Layouts follow the JAX package: clips ``[N, T, H, W, 3]`` uint8, output
``[N, T, S, S, 3]`` float32 or bf16.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np
import torch

from advise_tpu_torch.data.device_aug import uniform_from
from advise_tpu_torch.ops import build

LUMA = (0.299, 0.587, 0.114)
OPS = ("brightness", "contrast", "saturation", "hue")  # the codes of ``order``

SOURCE = "fused_aug.cu"
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_aug.argtypes = [vp] * 9 + [ci] * 5 + [cf] * 6 + [ci, vp]
        lib.fused_aug.restype = ci
        _lib = lib
    return _lib


def sample_simple_aug(n: int, h: int, w: int, size: int, color: Sequence[float],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Per-clip parameters of the fused aug, drawn from ``generator`` on its
    device, with the JAX function's ranges: crop offsets in [0, max(h - S, 1))
    and [0, max(w - S, 1)), factors uniform on [max(0, 1 - j), 1 + j), the
    chain applied with probability ``color[0]`` in a random order of the four
    ops. ``color`` is AUG.COLOR (p, brightness, contrast, saturation, hue)."""
    p, b, c, s = (float(v) for v in color[:4])
    dev = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    return {
        "tops": torch.randint(0, max(h - size, 1), (n,), generator=generator, device=dev,
                              dtype=torch.int32),
        "lefts": torch.randint(0, max(w - size, 1), (n,), generator=generator, device=dev,
                               dtype=torch.int32),
        "bfac": uniform_from(rand(n), max(0.0, 1 - b), 1 + b),
        "cfac": uniform_from(rand(n), max(0.0, 1 - c), 1 + c),
        "sfac": uniform_from(rand(n), max(0.0, 1 - s), 1 + s),
        "apply": (rand(n) < p).to(torch.int32),
        "order": torch.argsort(rand(n, len(OPS)), dim=1).to(torch.int32),
    }


def affine_constants(mean: Sequence[float], std: Sequence[float]):
    """float32(mean) * 255 and float32(std) * 255 per channel, each product
    rounded to float32 (the JAX kernel's ``tri(mean) * 255.0``)."""
    m = np.asarray(mean, np.float32) * np.float32(255.0)
    s = np.asarray(std, np.float32) * np.float32(255.0)
    return m, s


def crop_windows(clips_u8: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                 size: int) -> torch.Tensor:
    """[N, T, H, W, 3] uint8 -> each clip's [T, S, S, 3] window at its
    (top, left), as float32 [N, T, S, S, 3]."""
    n = clips_u8.shape[0]
    dev = clips_u8.device
    ar = torch.arange(size, device=dev)
    rows = tops.to(dev, torch.long)[:, None] + ar  # [N, S]
    cols = lefts.to(dev, torch.long)[:, None] + ar
    idx = torch.arange(n, device=dev)[:, None, None]
    win = clips_u8[idx, :, rows[:, :, None], cols[:, None, :]]  # [N, S, S, T, 3]
    return win.permute(0, 3, 1, 2, 4).float()


def luma(x: torch.Tensor) -> torch.Tensor:
    """floor((0.299 r + 0.587 g) + 0.114 b) of float32 [..., 3], each product
    and sum rounded to float32: the kernel's luma, which saturation blends
    towards."""
    k = torch.tensor(LUMA, dtype=torch.float32, device=x.device)
    return torch.floor((x[..., 0] * k[0] + x[..., 1] * k[1]) + x[..., 2] * k[2])


def mean_luma(x: torch.Tensor) -> torch.Tensor:
    """The luma that the contrast mean sums: XLA contracts the same sum into
    floor(fma(b, 0.114, fma(r, 0.299, 0.587 g))), which rounds apart from
    :func:`luma` on some pixels (white among them)."""
    k = torch.tensor(LUMA, dtype=torch.float32, device=x.device)
    return torch.floor(_fma(x[..., 2], k[2], _fma(x[..., 0], k[0], x[..., 1] * k[1])))


def crop_mean(win: torch.Tensor) -> torch.Tensor:
    """The contrast mean [N, T] of float32 windows [N, T, S, S, 3]:
    floor(sum(mean_luma) * float32(1 / S^2) + 0.5). The sum of integer lumas
    is exact in float32 while S <= 256."""
    area = win.shape[2] * win.shape[3]
    inv_area = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(area))
    total = torch.sum(mean_luma(win), dim=(2, 3))
    return torch.floor(total * inv_area.to(win.device) + 0.5)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (exact in float64 for this file's
    operands; see the module docstring)."""
    a, b, c = (torch.as_tensor(v).double() for v in (a, b, c))
    return (a * b + c).float()


def _clip_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 255.0)


def fused_simple_aug_plain(clips_u8: torch.Tensor, params: Dict[str, torch.Tensor],
                           size: int, mean: Sequence[float], std: Sequence[float],
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in PyTorch ops, on any device."""
    dev = clips_u8.device
    p = {k: v.to(dev) for k, v in params.items()}
    x = crop_windows(clips_u8, p["tops"], p["lefts"], size)
    lum = luma(x)[..., None]
    cmean = crop_mean(x)[:, :, None, None, None]
    bc = (-1,) + (1,) * (x.ndim - 1)
    bf, cf, sf = (p[k].float().view(bc) for k in ("bfac", "cfac", "sfac"))
    chain = [
        lambda y: _clip_u8(torch.floor(_fma(y, bf, 0.5))),
        lambda y: _clip_u8(torch.floor(_fma(cf, y - cmean, cmean) + 0.5)),
        lambda y: _clip_u8(torch.floor(_fma(sf, y - lum, lum) + 0.5)),
        lambda y: y,
    ]
    y = x
    order = p["order"].long()
    for pos in range(len(OPS)):
        for code, op in enumerate(chain):
            y = torch.where((order[:, pos] == code).view(bc), op(y), y)
    y = torch.where((p["apply"] > 0).view(bc), y, x)
    m, s = (torch.from_numpy(a).to(dev) for a in affine_constants(mean, std))
    return ((y - m) / s).to(out_dtype)


def fused_simple_aug(clips_u8: torch.Tensor, params: Dict[str, torch.Tensor], size: int,
                     mean: Sequence[float], std: Sequence[float],
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Crop + colour jitter + normalise of uint8 clips [N, T, H, W, 3] with the
    per-clip ``params`` of :func:`sample_simple_aug`: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if clips_u8.device.type != "cuda":
        if clips_u8.device.type != "cpu":
            raise RuntimeError(f"fused aug: no kernel for device {clips_u8.device}")
        return fused_simple_aug_plain(clips_u8, params, size, mean, std, out_dtype)
    if clips_u8.dtype != torch.uint8:
        raise TypeError(f"clips: expected torch.uint8, got {clips_u8.dtype}")
    if clips_u8.ndim != 5 or clips_u8.shape[-1] != 3:
        raise ValueError(f"clips: expected [N, T, H, W, 3], got {tuple(clips_u8.shape)}")
    if not clips_u8.is_contiguous():
        raise ValueError("clips: must be contiguous")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype: float32 or bfloat16, got {out_dtype}")
    n, t, h, w, _ = clips_u8.shape
    if not 0 < size <= min(h, w):
        raise ValueError(f"crop {size} does not fit frames of {h} x {w}")
    dev = clips_u8.device
    ints = {k: params[k].to(dev, torch.int32).contiguous() for k in ("tops", "lefts", "apply", "order")}
    floats = {k: params[k].to(dev, torch.float32).contiguous() for k in ("bfac", "cfac", "sfac")}
    if ints["order"].shape != (n, len(OPS)) or any(
            ints[k].shape != (n,) for k in ("tops", "lefts", "apply")) or any(
            v.shape != (n,) for v in floats.values()):
        raise ValueError(f"params do not match {n} clips")
    m, s = affine_constants(mean, std)
    out = torch.empty((n, t, size, size, 3), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().fused_aug(
            clips_u8.data_ptr(), ints["tops"].data_ptr(), ints["lefts"].data_ptr(),
            floats["bfac"].data_ptr(), floats["cfac"].data_ptr(), floats["sfac"].data_ptr(),
            ints["apply"].data_ptr(), ints["order"].data_ptr(), out.data_ptr(),
            n, t, h, w, size, *(float(v) for v in m), *(float(v) for v in s),
            int(out_dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_aug launch failed: CUDA error {err}")
    fused_simple_aug.launches += 1
    return out


fused_simple_aug.launches = 0
