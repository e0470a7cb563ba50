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
``[N, T, S, S, 3]`` float32 or bf16. :func:`plan` is the kernel's launch
plan (a cluster of CTAs a frame, one band of window rows each), plain
arithmetic on the shapes that the wrapper launches from.
"""

from __future__ import annotations

import ctypes
import functools
import re
from fractions import Fraction
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from advise_tpu_torch.data.device_aug import sample_crop_offsets, uniform_from
from advise_tpu_torch.ops import build

LUMA = (0.299, 0.587, 0.114)
OPS = ("brightness", "contrast", "saturation", "hue")  # the codes of ``order``

SOURCE = "fused_aug.cu"
_lib = None

# the kernel's launch constants (csrc/fused_aug.cu) and the card's limits
SMS = 132                 # streaming multiprocessors of an H100
MAX_CLUSTER = 8           # CTAs of a portable cluster
BAND_ROWS = 16            # window rows a CTA, before the cluster's cap
PIX = 4                   # pixels a thread takes at a time (12 channels)
CHUNK = 16                # bytes of one cp.async
MAX_THREADS = 256
MAX_SMEM_BLOCK = 232448   # shared memory a CTA can have (227 KB)
SMEM_SM, SMEM_RESERVED = 233472, 1024  # an SM's shared memory, the part each CTA reserves
THREADS_SM, BLOCKS_SM, REGISTERS_SM = 2048, 32, 65536
# a thread's registers under the kernel's launch bound: 6 CTAs of 256 an SM
# for float4 / 8-byte stores (S % 4 == 0), 5 for the narrower ones
MAX_REGISTERS = {4: 40, 2: 48, 1: 48}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def set_argtypes(lib) -> None:
    """The ctypes signature of the library's ``fused_aug``."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_aug.argtypes = [vp] * 9 + [ci] * 11 + [cf] * 9 + [ci, vp]
    lib.fused_aug.restype = ci


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        set_argtypes(lib)
        _lib = lib
    return _lib


def static_smem(out_dtype: torch.dtype) -> int:
    """The kernel's static shared memory: a warp's 32 x 12 outputs for each
    of its warps, the warps' luma sums, the partial sum and the mean."""
    return MAX_THREADS // 32 * (32 * 3 * PIX * torch.finfo(out_dtype).bits // 8 + 4) + 8


@functools.lru_cache(maxsize=None)
def reciprocals(m: Tuple[float, ...], s: Tuple[float, ...]) -> Tuple[float, ...]:
    """float32(1 / s_c) per channel, for the kernel's normalisation of y in
    [0, 255]: q = y - m; q0 = q * inv; fma(fma(-q0, s, q), inv, q0), each step
    rounded once to float32 (evaluated here exactly, in fractions). Raises
    ValueError unless that equals the float32 division (y - m) / s for all
    256 values of every channel, which Markstein's theorem promises: inv is
    correctly rounded and q0 within an ulp of the quotient."""
    inv = []
    for mc, sc in zip(np.asarray(m, np.float32), np.asarray(s, np.float32)):
        ic = np.float32(1.0) / sc
        bad = reciprocal_misses(mc, sc, ic)
        if bad:
            raise ValueError(f"fused aug: the reciprocal normalisation is not exact for mean "
                             f"{float(mc)} / std {float(sc)} at y = {bad}")
        inv.append(float(ic))
    return tuple(inv)


def reciprocal_misses(m: np.float32, s: np.float32, inv: np.float32) -> list:
    """The y in [0, 255] at which fma(fma(-q0, s, q), inv, q0), q = y - m,
    q0 = q * inv (each step one float32 rounding) differs from the float32
    division (y - m) / s."""
    q = np.arange(256, dtype=np.float32) - m
    q0 = q * inv
    bad = []
    for y, (qv, q0v, want) in enumerate(zip(q, q0, q / s)):
        r = _round_f32(Fraction(float(qv)) - Fraction(float(q0v)) * Fraction(float(s)))
        if _round_f32(Fraction(float(r)) * Fraction(float(inv)) + Fraction(float(q0v))) != want:
            bad.append(y)
    return bad


def _round_f32(x: Fraction) -> np.float32:
    """x rounded once to float32, to nearest, ties to even."""
    f = np.float32(float(x))  # within an ulp; pick the nearest neighbour exactly
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x), int(c.view(np.uint32)) & 1))


def plan(n: int, t: int, h: int, w: int, s: int, out_dtype: torch.dtype = torch.float32,
         registers: int = 0) -> dict:
    """How the kernel runs clips [n, t, h, w, 3] at crop ``s``: a cluster of
    ``cluster`` CTAs a frame (about BAND_ROWS window rows each, at most
    MAX_CLUSTER CTAs), CTA k on window rows ``bands[k]`` (``band`` rows, the
    last band what remains), ``threads`` a CTA over (row, group of 4 pixels)
    items; each staged row ``pitch`` bytes of shared memory (the
    16-byte-aligned superset of the row's 3 s bytes at any shift, and the
    last group's 16-byte read), ``smem`` the band's dynamic bytes and
    ``smem_total`` with the static part (each warp's output buffer, the luma
    sums); output stores of ``vector`` elements (the largest of 4, 2, 1 that
    divides s, so every output row starts aligned), ``store_bytes`` each;
    the grid and its waves on SMS SMs at ``per_sm`` CTAs an SM (by threads,
    shared memory and ``registers`` a thread: the build's ptxas report, or
    else the kernel's launch bound for the store width, MAX_REGISTERS).
    ``h`` and ``w`` only bound the crop. Pure arithmetic on the shapes."""
    if not 0 < s <= min(h, w):
        raise ValueError(f"crop {s} does not fit frames of {h} x {w}")
    cluster = min(MAX_CLUSTER, _cdiv(s, BAND_ROWS))
    band = _cdiv(s, cluster)
    cluster = _cdiv(s, band)
    groups = _cdiv(s, PIX)
    items = band * groups
    if items < 128:
        threads = _cdiv(items, 32) * 32
    else:  # the least padding of the items over the threads, then the most threads
        threads = min(range(128, MAX_THREADS + 1, 32), key=lambda th: (_cdiv(items, th) * th, -th))
    pitch = _cdiv(3 * s + 2 * CHUNK - 2, CHUNK) * CHUNK
    smem = band * pitch
    static = static_smem(out_dtype)
    if smem + static > MAX_SMEM_BLOCK:
        raise ValueError(f"fused aug: a band of {band} rows of crop {s} does not fit shared memory")
    vector = next(v for v in (4, 2, 1) if s % v == 0)
    registers = registers or MAX_REGISTERS[vector]
    per_sm = min(BLOCKS_SM, THREADS_SM // threads, SMEM_SM // (smem + static + SMEM_RESERVED),
                 REGISTERS_SM // (_cdiv(registers * 32, 256) * 256 * threads // 32))
    blocks = cluster * n * t
    return {"cluster": cluster, "band": band,
            "bands": [(k * band, min(s, (k + 1) * band)) for k in range(cluster)],
            "groups": groups, "threads": threads, "items_per_thread": _cdiv(items, threads),
            "pitch": pitch, "chunks": (3 * s + 2 * CHUNK - 2) // CHUNK, "smem": smem,
            "smem_total": smem + static, "vector": vector,
            "store_bytes": vector * torch.finfo(out_dtype).bits // 8, "per_sm": per_sm,
            "grid": (blocks, 1, 1), "waves": blocks / (SMS * per_sm)}


def kernel_usage() -> dict:
    """{(vector, output type): registers a thread, spill bytes and static
    shared memory} of the built library's kernel instances, from ptxas -v."""
    usage = {}
    for name, u in build.ptxas_usage(SOURCE).items():
        m = re.search(r"fused_aug_kernelILi(\d)E(f|13__nv_bfloat16)E", name)
        if m:
            usage[(int(m.group(1)), "float32" if m.group(2) == "f" else "bfloat16")] = u
    return usage


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
        **sample_crop_offsets(n, h, w, size, generator),
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
    out = launch(_library(), clips_u8, ints, floats, size, mean, std, out_dtype)
    fused_simple_aug.launches += 1
    return out


def launch(lib, clips_u8: torch.Tensor, ints: Dict[str, torch.Tensor],
           floats: Dict[str, torch.Tensor], size: int, mean: Sequence[float],
           std: Sequence[float], out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of ``lib``'s kernel on checked CUDA inputs, by :func:`plan`;
    raises if the launch fails."""
    n, t, h, w, _ = clips_u8.shape
    p = plan(n, t, h, w, size, out_dtype)
    m, s = affine_constants(mean, std)
    inv = reciprocals(tuple(float(v) for v in m), tuple(float(v) for v in s))
    out = torch.empty((n, t, size, size, 3), dtype=out_dtype, device=clips_u8.device)
    with torch.cuda.device(clips_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_aug(
            clips_u8.data_ptr(), ints["tops"].data_ptr(), ints["lefts"].data_ptr(),
            floats["bfac"].data_ptr(), floats["cfac"].data_ptr(), floats["sfac"].data_ptr(),
            ints["apply"].data_ptr(), ints["order"].data_ptr(), out.data_ptr(),
            n, t, h, w, size, p["cluster"], p["band"], p["threads"], p["pitch"], p["smem"],
            p["vector"], *(float(v) for v in m), *(float(v) for v in s), *inv,
            int(out_dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_aug launch failed: CUDA error {err}")
    return out


fused_simple_aug.launches = 0
