"""The nine Mosaic probe kernels (P1-P9 of scripts/probe_mosaic_aot.py) as
one CUDA window gather (``csrc/window_probe.cu``), with a plain PyTorch
version of each and one launch-counting entry per probe, named as the
script names its functions.

Each probe reads a window of its input at a run-time int32 offset ``o``
(the script's ``off = jnp.int32(8)``) and writes it out as float32:
aligned down to 8 or 32 where the script uses ``pl.multiple_of``, rolled
with wrap-around where it uses ``pltpu.roll`` (``jnp.roll``'s semantics:
a roll by ``-r`` takes element ``(i + r) mod n`` to ``i``), clamped where
it uses ``lax.dynamic_slice``, cast u8 -> i32 -> f32 where its input is
uint8, and summed over two leading slices in P1. The probes whose kernels
take two offsets (P6, P7, P9: ``jnp.stack([o, o])``) get ``o`` twice.

A window that reaches past its axis raises :class:`IndexError` before any
launch: the TPU kernels' DMA could not read it either. The CUDA kernel is
launched for a CUDA tensor, the plain version taken for a CPU tensor, and
anything else raises. The script's numbers are sizes in elements; nothing
here times a TPU.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from advise_tpu_torch.ops import build

SOURCE = "window_probe.cu"
RANK = 4
H, W = 64, 256  # the script's probe sizes (:57)
_lib = None
_SPECS: Dict[str, list] = {}  # each window's ctypes arrays, built at its first launch


@dataclass(frozen=True)
class Window:
    """One probe's window over its input seen as ``in_shape`` (rank 4).
    Per axis: ``out`` extent; ``base`` static start; ``src`` the offset
    (0 or 1, -1 none) that moves it, times ``scale``; ``align`` 1 at the
    offset, > 1 aligned down, 0 at ``base``; ``clamp`` into the axis; and
    ``wrap`` > 0 rolls within that many elements from the start."""

    shape: Tuple[int, ...]      # the probe's input shape
    dtype: torch.dtype
    in_shape: Tuple[int, ...]
    out: Tuple[int, ...]
    out_shape: Tuple[int, ...]  # the probe's output shape
    src: Tuple[int, ...] = (-1, -1, -1, -1)
    base: Tuple[int, ...] = (0, 0, 0, 0)
    scale: Tuple[int, ...] = (1, 1, 1, 1)
    align: Tuple[int, ...] = (1, 1, 1, 1)
    clamp: Tuple[int, ...] = (0, 0, 0, 0)
    wrap: Tuple[int, ...] = (0, 0, 0, 0)
    sum_axis0: bool = False


F32, U8 = torch.float32, torch.uint8
WINDOWS: Dict[str, Window] = {
    # 1 x[o : o+2].sum(0) over [8, H, W] f32 (:76-96)
    "lead_dyn": Window((8, H, W), F32, (8, H, W, 1), (2, H, W, 1), (H, W),
                       src=(0, -1, -1, -1), sum_axis0=True),
    # 2 x[0, o : o+16, :] (:99-120)
    "sub_dyn": Window((8, H, W), F32, (1, 8, H, W), (1, 1, 16, W), (16, W),
                      src=(-1, -1, 0, -1)),
    # 3 x[0, o8 : o8+16, :], o8 = (o // 8) * 8 (:123-145)
    "sub_aligned": Window((8, H, W), F32, (1, 8, H, W), (1, 1, 16, W), (16, W),
                          src=(-1, -1, 0, -1), align=(1, 1, 8, 1)),
    # 4 lax.dynamic_slice_in_dim(x, o, 16, 0): start clamped to [0, H - 16] (:138-150)
    "val_dslice": Window((H, W), F32, (1, 1, H, W), (1, 1, 16, W), (16, W),
                         src=(-1, -1, 0, -1), clamp=(0, 0, 1, 0)),
    # 5 pltpu.roll(x, -o, 0)[:16, :] (:153-165)
    "roll_dyn": Window((H, W), F32, (1, 1, H, W), (1, 1, 16, W), (16, W),
                       src=(-1, -1, 0, -1), align=(1, 1, 0, 1), wrap=(0, 0, H, 0)),
    # 6 x[0, o : o+16, o : o+16, :] u8 -> f32 (:180-204)
    "aug_like": Window((8, H, W, 3), U8, (8, H, W, 3), (1, 16, 16, 3), (16, 16, 3),
                       src=(-1, 0, 1, -1)),
    # 7 x[0, o : o+16, la : la+64, :], la = (o // 32) * 32, u8 -> f32 (:207-231)
    "aug_like_aligned": Window((8, H, W, 3), U8, (8, H, W, 3), (1, 16, 64, 3), (16, 64, 3),
                               src=(-1, 0, 1, -1), align=(1, 1, 32, 1)),
    # 8 pltpu.roll(x, -o, 1)[:, :128] (:236-248)
    "roll_lane": Window((H, W), F32, (1, 1, H, W), (1, 1, H, 128), (H, 128),
                        src=(-1, -1, -1, 0), align=(1, 1, 1, 0), wrap=(0, 0, 0, W)),
    # 9 s = x[0, 2, ta : ta+24, :] u8 -> f32, ta = (o // 8) * 8; rolled by
    #   -(o % 8) on rows and -(3 o) on lanes; [:16, :640] (:263-286)
    "flat_u8": Window((4, 8, H, 896), U8, (4, 8, H, 896), (1, 1, 16, 640), (16, 640),
                      src=(-1, -1, 0, 1), base=(0, 2, 0, 0), scale=(1, 1, 1, 3),
                      align=(1, 1, 8, 0), wrap=(0, 0, 24, 896)),
}


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.window_gather.argtypes = [vp, vp] + [ip] * 8 + [ci, ci, ci, ci, vp]
        lib.window_gather.restype = ci
        _lib = lib
    return _lib


def _start(win: Window, a: int, offsets) -> Tuple[int, int]:
    """(start, roll shift) of axis ``a``, as the kernel computes them."""
    v = 0 if win.src[a] < 0 else win.scale[a] * offsets[win.src[a]]
    if win.clamp[a]:
        start = min(max(win.base[a] + v, 0), win.in_shape[a] - win.out[a])
    elif win.align[a] == 0:
        start = win.base[a]
    else:
        start = win.base[a] + (v // win.align[a]) * win.align[a]
    return start, win.base[a] + v - start


def check_in_range(win: Window, offsets) -> None:
    """Raise IndexError for a window that reaches past its axis (a rolled
    axis reads its whole wrap window)."""
    for a in range(RANK):
        start, _ = _start(win, a, offsets)
        hi = start + (win.wrap[a] or win.out[a])
        if start < 0 or hi > win.in_shape[a]:
            raise IndexError(f"window [{start}, {hi}) of axis {a} lies outside "
                             f"[0, {win.in_shape[a]}) at offsets {tuple(offsets)}")


def window_indices(win: Window, offsets) -> Tuple[torch.Tensor, ...]:
    """The input index of every window position, per axis; raises
    IndexError for a window that reaches past its axis."""
    check_in_range(win, offsets)
    out = []
    for a in range(RANK):
        start, shift = _start(win, a, offsets)
        i = torch.arange(win.out[a])
        out.append(start + ((i + shift) % win.wrap[a] if win.wrap[a] else i))
    return tuple(out)


def window_plain(win: Window, x: torch.Tensor, offsets) -> torch.Tensor:
    """The window by advanced indexing, cast and summed in torch."""
    i0, i1, i2, i3 = window_indices(win, offsets)
    x4 = x.reshape(win.in_shape)
    y = x4[i0[:, None, None, None], i1[None, :, None, None], i2[None, None, :, None],
           i3[None, None, None, :]]
    if x.dtype == U8:
        y = y.to(torch.int32).to(F32)
    if win.sum_axis0:
        y = y.sum(0)
    return y.reshape(win.out_shape)


def _window(entry: Callable, name: str, o: int, x: torch.Tensor) -> torch.Tensor:
    win = WINDOWS[name]
    o = int(o)
    offsets = (o, o)
    if tuple(x.shape) != win.shape or x.dtype != win.dtype:
        raise ValueError(f"{name}: expected {win.dtype} {win.shape}, got {x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda":
        if x.device.type != "cpu":
            raise RuntimeError(f"{name}: no kernel for device {x.device}")
        return window_plain(win, x, offsets)
    check_in_range(win, offsets)  # raises before the launch
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    y = torch.empty(win.out_shape, dtype=F32, device=x.device)
    if name not in _SPECS:
        _SPECS[name] = [(ctypes.c_int * RANK)(*vals) for vals in (
            win.in_shape, win.out, win.base, win.src, win.scale, win.align, win.clamp, win.wrap)]
    arrays = _SPECS[name]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().window_gather(x.data_ptr(), y.data_ptr(), *arrays, int(win.sum_axis0),
                                       int(win.dtype == U8), o, o, stream)
    if err != 0:
        raise RuntimeError(f"{name}: window_gather launch failed: CUDA error {err}")
    entry.launches += 1
    return y


def lead_dyn(o: int, x: torch.Tensor) -> torch.Tensor:
    """P1: the sum of two leading slices at offset o."""
    return _window(lead_dyn, "lead_dyn", o, x)


def sub_dyn(o: int, x: torch.Tensor) -> torch.Tensor:
    """P2: 16 rows at the unaligned offset o."""
    return _window(sub_dyn, "sub_dyn", o, x)


def sub_aligned(o: int, x: torch.Tensor) -> torch.Tensor:
    """P3: 16 rows at o aligned down to 8."""
    return _window(sub_aligned, "sub_aligned", o, x)


def val_dslice(o: int, x: torch.Tensor) -> torch.Tensor:
    """P4: 16 rows at o, the start clamped into the array."""
    return _window(val_dslice, "val_dslice", o, x)


def roll_dyn(o: int, x: torch.Tensor) -> torch.Tensor:
    """P5: the first 16 rows after a row roll by -o."""
    return _window(roll_dyn, "roll_dyn", o, x)


def aug_like(o: int, x: torch.Tensor) -> torch.Tensor:
    """P6: a 16 x 16 uint8 pixel window at (o, o), as float32."""
    return _window(aug_like, "aug_like", o, x)


def aug_like_aligned(o: int, x: torch.Tensor) -> torch.Tensor:
    """P7: 16 rows at o by 64 columns at o aligned down to 32, as float32."""
    return _window(aug_like_aligned, "aug_like_aligned", o, x)


def roll_lane(o: int, x: torch.Tensor) -> torch.Tensor:
    """P8: the first 128 lanes after a lane roll by -o."""
    return _window(roll_lane, "roll_lane", o, x)


def flat_u8(o: int, x: torch.Tensor) -> torch.Tensor:
    """P9: a 24-row band at o aligned down to 8, rolled by the residual
    rows and by 3 o lanes, its first 16 x 640 as float32."""
    return _window(flat_u8, "flat_u8", o, x)


ENTRIES: Dict[str, Callable] = {
    "lead_dyn": lead_dyn, "sub_dyn": sub_dyn, "sub_aligned": sub_aligned,
    "val_dslice": val_dslice, "roll_dyn": roll_dyn, "aug_like": aug_like,
    "aug_like_aligned": aug_like_aligned, "roll_lane": roll_lane, "flat_u8": flat_u8,
}
for _entry in ENTRIES.values():
    _entry.launches = 0
