"""The SlowFast fast-stem convolution: CUDA kernels, their plain PyTorch
versions, and the autograd Function that pairs them.

Counterpart of ``advise_tpu/ops/pallas/stem_conv.py`` (TPU.PALLAS_STEM).
The kernels (``csrc/stem_conv.cu``) compute the (kt,7,7)/s(1,2,2) conv with
3 input and 8 output channels (kt odd) from the raw NDHWC clip as
tensor-core implicit GEMMs: each block stages its tile's frames once, in
the 2x2 space-to-depth layout, in a ring in shared memory, and walks its
work items frame by frame (the JAX kernels' Toeplitz column packing exists
to fill the TPU's 128-lane MXU and is not carried over; the source note in
the ``.cu`` file says what bounds the CUDA version). :func:`plan` is how
they run a shape: tile, persistent grid, ring and partials, plain
arithmetic that the wrappers pass to the kernels and the CPU tests read.

Two other launch schedules of the same kernels, the counterparts of the JAX
package's TPU.PALLAS_STEM_CHUNK and TPU.PALLAS_STEM_WGRAD_ONLY entry points
(``pallas_s2d_stem_chunked``, ``pallas_s2d_stem_wgrad_only``):
:func:`stem_conv_chunked` runs K1 and K2 once per batch chunk, and
:func:`stem_conv_wgrad_only` keeps the dense conv forward and runs K2 over
chunks of :data:`WGRAD_CHUNK` samples. On the TPU the chunks bounded the
packed input buffer; the CUDA kernels read the raw clip and have no pack
buffer, so here the chunks only change the launch schedule and the order
of the float32 sum of dW.

Routing: every wrapper takes its plain version for a tensor on the CPU
(the tests), launches its kernel for a CUDA tensor, and raises otherwise.
There is no fallback from a CUDA tensor to the plain version. Each kernel
wrapper counts its launches in a plain integer attribute, ``.launches``.

Layouts follow the JAX package: clips ``[B, T, H, W, 3]``, the weight
``[kt, 7, 7, 3, 8]``, the output ``[B, T, Ho, Wo, 8]`` with
``Ho = (H - 1) // 2 + 1`` (the padded stride-2 conv's output size).
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import Optional

import torch
import torch.nn.functional as F

from advise_tpu_torch.ops import build

CHANNELS_IN = 3
FEATURES = 8
KSIZE = 7
# samples per K2 launch of the wgrad-only backward
# (advise_tpu/ops/pallas/stem_conv.py:230)
WGRAD_CHUNK = 16

SOURCE = "stem_conv.cu"
# the kernels' geometry (csrc/stem_conv.cu holds the same constants; the
# card tests compare the shared memory it computes with this module's)
SMS = 132  # streaming multiprocessors of an H100: one persistent block each
SMEM_LIMIT = 232448  # dynamic shared memory a block may use
TILE_W = 16  # output columns of a tile: one m16 tile of positions
WARP_ROWS = 7  # output rows of a K1 warp
CELL_BYTES = 32  # a staged space-to-depth cell: 12 channels + 4 zero, bf16
WGRAD_MAX_TAPS = 5  # temporal taps of a K2 group (its warps: 2 a tap)
S2D_TAPS = 16  # (ah, aw) taps of the s2d kernel per temporal tap
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.stem_fwd.argtypes = [vp, vp, vp] + [ci] * 7 + [vp]
        lib.stem_fwd.restype = ci
        lib.stem_wgrad.argtypes = [vp] * 4 + [ci] * 8 + [vp]
        lib.stem_wgrad.restype = ci
        for name in ("stem_fwd_smem", "stem_wgrad_smem"):
            getattr(lib, name).argtypes = [ci, ci]
            getattr(lib, name).restype = ci
        _lib = lib
    return _lib


def out_hw(h: int, w: int):
    return (h - 1) // 2 + 1, (w - 1) // 2 + 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def frame_bytes(th: int) -> int:
    """Shared memory of one staged frame of a tile of ``th`` output rows:
    (th + 3) x (16 + 3) cells, the halo 2 before and 1 after."""
    return (th + 3) * (TILE_W + 3) * CELL_BYTES


def fwd_smem(th: int, kt: int) -> int:
    """K1's block: a ring of kt frames and the weight's B fragments (kt x 16
    taps x 32 lanes x 8 bytes)."""
    return kt * frame_bytes(th) + kt * S2D_TAPS * 32 * 8


def wgrad_smem(th: int, dg: int) -> int:
    """K2's block: a ring of dg + 1 frames (the dg its warps read and the
    one in flight) and the output gradient's frame (th x 16 positions x 16
    bytes)."""
    return (dg + 1) * frame_bytes(th) + th * TILE_W * 16


def _rows(smem) -> int:
    """Tile rows: the most warps (8, 4, 2 or 1, of WARP_ROWS rows each)
    whose ring fits."""
    for nw in (8, 4, 2, 1):
        if smem(nw * WARP_ROWS) <= SMEM_LIMIT:
            return nw * WARP_ROWS
    raise ValueError("stem conv: the temporal kernel is too deep for a block's shared memory")


@functools.lru_cache(maxsize=None)
def plan(b: int, t: int, h: int, w: int, kt: int) -> dict:
    """How the kernels run clips [b, t, h, w, 3] with temporal kernel kt:
    per kernel its tile (output rows x columns), warps, grid, shared memory,
    ring depth (frames staged), work items ((clip, tile, frame) triples) and
    items a block, and the waves of its grid on SMS SMs (one persistent
    block an SM: the ring takes most of its shared memory); for K2 also its
    temporal-tap groups (one grid row each) and the float32 partials the
    reduce sums. Pure arithmetic on the shapes."""
    if kt % 2 == 0 or kt < 1:
        raise ValueError(f"stem conv: the kernels take an odd temporal kernel, got {kt}")
    ho, wo = out_hw(h, w)
    out = {"out": (ho, wo)}
    groups = _cdiv(kt, WGRAD_MAX_TAPS)
    dg = _cdiv(kt, groups)
    fwd_th = _rows(lambda r: fwd_smem(r, kt))
    wg_th = _rows(lambda r: wgrad_smem(r, dg))
    for name, th, ring, warps, smem, rows_of in (
            ("fwd", fwd_th, kt, fwd_th // WARP_ROWS, fwd_smem(fwd_th, kt), 1),
            ("wgrad", wg_th, dg + 1, 2 * dg, wgrad_smem(wg_th, dg), groups)):
        tiles = _cdiv(ho, th) * _cdiv(wo, TILE_W)
        items = b * tiles * t
        blocks = min(SMS, items)
        out[name] = {"tile": (th, TILE_W), "warps": warps, "grid": (blocks, rows_of, 1),
                     "smem": smem, "ring": ring, "tiles": tiles, "items": items,
                     "items_per_block": _cdiv(items, blocks), "waves": blocks * rows_of / SMS}
    out["wgrad"].update(groups=groups, taps_per_group=dg, partials=out["wgrad"]["grid"][0])
    return out


def kernel_usage() -> dict:
    """{kernel name: registers a thread, spill bytes and static shared
    memory} of the built library, from ptxas -v."""
    usage = {}
    for name, u in build.ptxas_usage(SOURCE).items():
        m = re.search(r"(stem_[a-z_]+_kernel)", name)
        if m:
            usage[m.group(1)] = u
    return usage


def _check_cuda(name: str, t: torch.Tensor, shape, dtype=torch.bfloat16):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_unless_cpu(t: torch.Tensor):
    if t.device.type != "cpu":
        raise RuntimeError(f"stem conv: no kernel for device {t.device}")


def _check_aligned(name: str, t: torch.Tensor, nbytes: int):
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must be {nbytes}-byte aligned")


# -- plain versions ----------------------------------------------------------


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B,T,H,W,C] x [kt,7,7,C,F] -> [B,T,Ho,Wo,F] through F.conv3d."""
    kt = w.shape[0]
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
        stride=(1, 2, 2), padding=(kt // 2, 3, 3),
    )
    return y.permute(0, 2, 3, 4, 1)


def stem_wgrad_plain(x: torch.Tensor, g: torch.Tensor, kt: int) -> torch.Tensor:
    """dW [kt,7,7,C,F] (float32) of the stem conv for the cotangent g."""
    c, f = x.shape[-1], g.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        x.permute(0, 4, 1, 2, 3).float(), (f, c, kt, KSIZE, KSIZE),
        g.permute(0, 4, 1, 2, 3).float(), stride=(1, 2, 2),
        padding=(kt // 2, 3, 3),
    )
    return dw.permute(2, 3, 4, 1, 0)


def stem_dgrad_plain(g: torch.Tensor, w: torch.Tensor, x_shape) -> torch.Tensor:
    """Input gradient [B,T,H,W,C] of the stem conv (the plain conv's own)."""
    kt = w.shape[0]
    b, t, h, wd, c = x_shape
    dx = torch.nn.grad.conv3d_input(
        (b, c, t, h, wd), w.permute(4, 3, 0, 1, 2),
        g.permute(0, 4, 1, 2, 3), stride=(1, 2, 2), padding=(kt // 2, 3, 3),
    )
    return dx.permute(0, 2, 3, 4, 1)


# -- kernel wrappers -----------------------------------------------------------


def stem_conv_fwd(x: torch.Tensor, w: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stem conv forward: the CUDA kernel for a CUDA tensor (bf16 in, bf16
    out), the plain conv for a CPU tensor. With ``out`` (contiguous, of the
    output's shape) the result is written there and ``out`` returned."""
    if x.device.type != "cuda":
        _raise_unless_cpu(x)
        y = stem_conv_plain(x, w)
        return y if out is None else out.copy_(y)
    b, t, h, wd, _ = x.shape
    kt = w.shape[0]
    _check_cuda("x", x, (b, t, h, wd, CHANNELS_IN))
    _check_cuda("w", w, (kt, KSIZE, KSIZE, CHANNELS_IN, FEATURES))
    _check_aligned("x", x, 4)
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    ho, wo = out_hw(h, wd)
    if out is None:
        y = torch.empty((b, t, ho, wo, FEATURES), dtype=torch.bfloat16, device=x.device)
    else:
        _check_cuda("out", out, (b, t, ho, wo, FEATURES))
        _check_aligned("out", out, 4)
        if out.device != x.device:
            raise ValueError("x and out must be on one device")
        y = out
    p = plan(b, t, h, wd, kt)["fwd"]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().stem_fwd(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, h, wd, kt, p["warps"],
            p["grid"][0], stream
        )
    if err != 0:
        raise RuntimeError(f"stem_fwd launch failed: CUDA error {err}")
    stem_conv_fwd.launches += 1
    return y


stem_conv_fwd.launches = 0


def stem_conv_wgrad(x: torch.Tensor, g: torch.Tensor, kt: int) -> torch.Tensor:
    """Stem weight gradient [kt,7,7,3,8] float32: the CUDA kernel pair
    (a float32 partial per persistent block, then a fixed-order sum that
    collapses the s2d taps) for a CUDA tensor, the plain conv weight
    gradient for a CPU tensor."""
    if x.device.type != "cuda":
        _raise_unless_cpu(x)
        return stem_wgrad_plain(x, g, kt)
    b, t, h, wd, _ = x.shape
    ho, wo = out_hw(h, wd)
    _check_cuda("x", x, (b, t, h, wd, CHANNELS_IN))
    _check_cuda("g", g, (b, t, ho, wo, FEATURES))
    _check_aligned("x", x, 4)
    _check_aligned("g", g, 16)
    if g.device != x.device:
        raise ValueError("x and g must be on one device")
    p = plan(b, t, h, wd, kt)["wgrad"]
    partial = torch.empty((p["partials"], kt * S2D_TAPS * 16 * FEATURES), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty(
        (kt, KSIZE, KSIZE, CHANNELS_IN, FEATURES), dtype=torch.float32,
        device=x.device,
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().stem_wgrad(
            x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            b, t, h, wd, kt, p["tile"][0], p["taps_per_group"], p["partials"], stream,
        )
    if err != 0:
        raise RuntimeError(f"stem_wgrad launch failed: CUDA error {err}")
    stem_conv_wgrad.launches += 1
    return dw


stem_conv_wgrad.launches = 0


def kernel_eligible(c: int, f: int) -> bool:
    """Shapes the kernels take: the 3-channel clip to the 8-wide fast stem."""
    return c == CHANNELS_IN and f == FEATURES


# -- the autograd Functions: one launch, per chunk (K1'), wgrad-only (K2') -----


def largest_divisor(b: int, chunk: int) -> int:
    """Samples per launch: the largest divisor of ``b`` that is <= ``chunk``
    (``_largest_divisor``, advise_tpu/ops/pallas/stem_conv.py:300); ``b``
    (one launch) for ``chunk <= 0``."""
    if chunk <= 0:
        return b
    cb = min(chunk, b)
    while b % cb:
        cb -= 1
    return cb


def stem_conv_fwd_chunked(x: torch.Tensor, w: torch.Tensor, cb: int) -> torch.Tensor:
    """K1 once per chunk of ``cb`` samples (``cb`` divides B), each launch
    writing its slice of one output tensor."""
    b, t, h, wd, _ = x.shape
    ho, wo = out_hw(h, wd)
    y = torch.empty((b, t, ho, wo, w.shape[-1]), dtype=x.dtype, device=x.device)
    for s in range(0, b, cb):
        stem_conv_fwd(x[s:s + cb], w, out=y[s:s + cb])
    return y


def stem_conv_wgrad_chunked(x: torch.Tensor, g: torch.Tensor, kt: int, cb: int) -> torch.Tensor:
    """K2 once per chunk of ``cb`` samples, the float32 dW of the chunks
    summed in chunk order (the ``lax.scan`` of ``_wgrad``)."""
    dw = stem_conv_wgrad(x[:cb], g[:cb], kt)
    for s in range(cb, x.shape[0], cb):
        dw = dw + stem_conv_wgrad(x[s:s + cb], g[s:s + cb], kt)
    return dw


def _stem_backward(ctx, g, cb):
    """dx through the plain conv's input gradient when asked for, dW from
    K2 over chunks of ``cb`` samples."""
    x, w = ctx.saved_tensors
    g = g.to(x.dtype).contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = stem_dgrad_plain(g, w, x.shape)
    if ctx.needs_input_grad[1]:
        dw = stem_conv_wgrad_chunked(x, g, w.shape[0], cb).to(w.dtype)
    return dx, dw


class StemConvChunked(torch.autograd.Function):
    """``pallas_s2d_stem_chunked``: K1 and K2 over batch chunks of the
    largest divisor of B that is <= ``chunk``; ``chunk <= 0`` is one launch
    of each, the custom VJP ``pallas_s2d_stem``. The input gradient goes
    through the plain conv's, and only when something asks for it: on the
    main path the input is the augmentation output, which carries no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, chunk):
        ctx.save_for_backward(x, w)
        ctx.cb = largest_divisor(x.shape[0], chunk)
        return stem_conv_fwd_chunked(x, w, ctx.cb)

    @staticmethod
    def backward(ctx, g):
        return (*_stem_backward(ctx, g, ctx.cb), None)


class StemConvWgradOnly(torch.autograd.Function):
    """``pallas_s2d_stem_wgrad_only``: the dense conv forward (cuDNN, as the
    JAX package keeps XLA's conv there) and K2 over chunks of
    :data:`WGRAD_CHUNK` samples in the backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return stem_conv_plain(x, w).contiguous()

    @staticmethod
    def backward(ctx, g):
        x = ctx.saved_tensors[0]
        return _stem_backward(ctx, g, largest_divisor(x.shape[0], WGRAD_CHUNK))


def stem_conv_chunked(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
                      chunk: int) -> torch.Tensor:
    """NDHWC clip x [kt,7,7,3,8] weight -> NDHWC stem output, computed in
    ``dtype`` (x and w are cast first, as the JAX module does, so the
    Function behaves the same under autocast), with K1 and K2 launched per
    batch chunk (TPU.PALLAS_STEM_CHUNK); ``chunk <= 0`` is one launch."""
    return StemConvChunked.apply(x.to(dtype).contiguous(), w.to(dtype).contiguous(), int(chunk))


def stem_conv_wgrad_only(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`stem_conv_chunked` with the dense conv forward and the K2 backward
    (TPU.PALLAS_STEM_WGRAD_ONLY)."""
    return StemConvWgradOnly.apply(x.to(dtype).contiguous(), w.to(dtype).contiguous())
