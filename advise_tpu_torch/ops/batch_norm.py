"""SyncBatchNorm's train mode as CUDA kernels, and their plain PyTorch
versions: the statistics, the fold, and the backward's sums and dx.

The kernels (``csrc/batch_norm.cu``) replace no TPU kernel: the JAX
package's SyncBatchNorm (``advise_tpu/models/layers/norm.py``) is a chain
of jnp operations that XLA fuses, where eager PyTorch ran ~60 launches a BN
a step and saved a float32 copy of the activation. They are bound by bytes:
one read of x for the statistics, one read and one write for the fold, and
in the backward one read of g and x for two sums, then another with the
write of dx. The source note says how the design answers that.

Every function takes x as the models hold it, ``[N, C, *S]`` with the
channel dim (1) innermost in memory (the channels-last NDHWC activations,
the heads' ``[B, C]``), seen as ``[rows, C]``; its rows fall into
``splits`` contiguous ranges of ``n = rows / splits``, one per batch slice.
Outputs have x's shape and strides; the statistics are float32
``[2, splits, C]``.

- :func:`bn_stats`: (mean, mean of squares) of each split;
- :func:`bn_apply`: ``y = x * T(w) + T(b)`` with ``w = scale * rsqrt(var +
  eps)``, ``b = -mean * w + bias``, ``var = meansq - mean^2``, in float32
  and w, b rounded to x's type T, y computed in float32 and rounded once;
- :func:`bn_grad_stats`: the means of g and of ``g * xh``, ``xh = (x -
  mean) * rsqrt(var + eps)``, per split, and their totals over every row
  (the bias's and the scale's gradients);
- :func:`bn_dx`: ``dx = scale * rsqrt(var + eps) * (g - mean_g - xh *
  mean_gxh)``, the closed form of the fold's input gradient, rounded once.

A CUDA tensor runs the kernels or raises (device, a dtype other than bf16
and float32, ndim < 2, a channel dim that is not innermost); a CPU tensor
runs the plain version (``*_plain``), in any layout. Each wrapper counts its
calls on the card in ``.launches``; :func:`channels_last` counts the copies
it makes for the card in ``.launches`` too. :func:`plan` is how the kernels run a shape, plain
arithmetic on it that the CPU tests read.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from advise_tpu_torch.ops import build

SOURCE = "batch_norm.cu"
SMS = 132            # streaming multiprocessors of an H100
MAX_THREADS = 256    # threads a block (the kernels' launch bound)
VECTOR_BYTES = 16    # a thread's widest load
BLOCKS = 4 * SMS     # blocks a launch aims at: 4 resident on each SM
DTYPES = (torch.bfloat16, torch.float32)
_lib = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        vp, ci, cll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        geom = [ci, cll, cll, ci, ci, ci, ci, ci, ci, ci, vp]  # bf16, the plan's geometry, the stream
        lib.bn_stats.argtypes = [vp] * 3 + geom
        lib.bn_apply.argtypes = [vp] * 5 + [cf] + geom
        lib.bn_grad_stats.argtypes = [vp] * 3 + [cf] + [vp] * 3 + geom
        lib.bn_dx.argtypes = [vp] * 5 + [cf, vp] + geom
        for fn in (lib.bn_stats, lib.bn_apply, lib.bn_grad_stats, lib.bn_dx):
            fn.restype = ci
        _lib = lib
    return _lib


def plan(rows: int, c: int, splits: int, dtype: torch.dtype, align: int = VECTOR_BYTES) -> dict:
    """How the kernels run x ``[rows, C]`` of ``dtype`` in ``splits`` row
    ranges, every pointer aligned to ``align`` bytes: ``vec`` elements a
    load (16 bytes, narrower where C or ``align`` does not allow it); the
    row's ``c // vec`` vectors in ``ctiles`` channel tiles of ``ct`` (a
    thread each); ``rpi`` rows a block reads at once (``threads = ct *
    rpi``); each split in ``nb`` row blocks of ``rpb`` rows (the last
    shorter), about :data:`BLOCKS` blocks in all; the grid (nb, ctiles,
    splits). Few channels get many row blocks, few rows wide tiles."""
    if rows <= 0 or c <= 0 or splits <= 0 or rows % splits:
        raise ValueError(f"batch norm: {rows} rows of {c} channels do not split into {splits}")
    esize = torch.finfo(dtype).bits // 8
    vec = next(v for v in (8, 4, 2, 1)
               if v * esize <= VECTOR_BYTES and c % v == 0 and align % (v * esize) == 0)
    vectors = c // vec
    ctiles = _cdiv(vectors, MAX_THREADS)
    ct = _cdiv(vectors, ctiles)
    rpi = MAX_THREADS // ct
    rows_split = rows // splits
    nb = max(1, min(_cdiv(BLOCKS, ctiles * splits), _cdiv(rows_split, rpi)))
    rpb = _cdiv(_cdiv(rows_split, nb), rpi) * rpi
    nb = _cdiv(rows_split, rpb)
    return {"vec": vec, "ct": ct, "ctiles": ctiles, "rpi": rpi, "threads": ct * rpi,
            "rows_split": rows_split, "rpb": rpb, "nb": nb, "splits": splits, "c": c,
            "grid": (nb, ctiles, splits), "scratch": splits * nb * 2 * c}


def channels_innermost(x: torch.Tensor) -> bool:
    """Whether x ``[N, C, *S]`` lies in memory as a dense ``[N, *S, C]``."""
    return x.movedim(1, -1).is_contiguous()


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """A CUDA tensor laid out for the kernels: x itself where its channel
    dim is innermost in memory, else a copy laid out so, counted in
    ``channels_last.launches``. Any other tensor as it is: the plain
    versions take every layout and keep x's in their outputs."""
    if x.device.type != "cuda" or channels_innermost(x):
        return x
    channels_last.launches += 1
    return x.movedim(1, -1).contiguous().movedim(-1, 1)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x ``[N, C, *S]`` as ``[rows, C]`` (a view where the channel dim is
    innermost, a copy otherwise)."""
    return x.movedim(1, -1).reshape(-1, x.shape[1])


def _compute_type(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _like(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``rows`` [rows, C] as a tensor of x's shape and strides."""
    out = torch.empty_like(x)
    out.movedim(1, -1).copy_(rows.view(x.movedim(1, -1).shape))
    return out


def rstd(stats: torch.Tensor, eps: float) -> torch.Tensor:
    """rsqrt(meansq - mean^2 + eps) of stats [2, splits, C], in float32."""
    mean, meansq = stats
    return torch.rsqrt(meansq - torch.square(mean) + eps)


def _check_splits(x: torch.Tensor, splits: int) -> None:
    if splits <= 0 or x.shape[0] % splits:
        raise ValueError(f"batch norm: a batch of {x.shape[0]} does not split into {splits}")


def bn_stats_plain(x: torch.Tensor, splits: int) -> torch.Tensor:
    xs = _rows(x).float().view(splits, -1, x.shape[1])
    return torch.stack([xs.mean(1), torch.square(xs).mean(1)])


def fold(mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
         dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """w = scale * rsqrt(var + eps) and b = -mean * w + bias, in float32,
    rounded to ``dtype``: the fold of train mode (per split, from the
    batch's statistics) and of eval mode (from the running ones)."""
    w = torch.rsqrt(var + eps) * weight.float()
    b = -mean * w + bias.float()
    return w.to(dtype), b.to(dtype)


def bn_apply_plain(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    splits, c = stats.shape[1], x.shape[1]
    ct = _compute_type(x.dtype)
    w, b = (t.to(ct)[:, None] for t in fold(stats[0], stats[1] - torch.square(stats[0]), weight, bias, eps,
                                                  x.dtype))
    y = _rows(x).to(ct).view(splits, -1, c) * w + b
    return _like(x, y.to(x.dtype))


def bn_grad_stats_plain(gy: torch.Tensor, x: torch.Tensor, stats: torch.Tensor,
                        eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    splits, c = stats.shape[1], x.shape[1]
    ct = _compute_type(x.dtype)
    gs = _rows(gy).to(ct).view(splits, -1, c)
    xh = (_rows(x).to(ct).view(splits, -1, c) - stats[0][:, None].to(ct)) * rstd(stats, eps)[:, None].to(ct)
    sums = torch.stack([gs.sum(1), (gs * xh).sum(1)])
    return (sums / gs.shape[1]).float(), sums.sum(1).float()


def bn_dx_plain(gy: torch.Tensor, x: torch.Tensor, stats: torch.Tensor, means: torch.Tensor,
                weight: torch.Tensor, eps: float) -> torch.Tensor:
    splits, c = stats.shape[1], x.shape[1]
    ct = _compute_type(x.dtype)
    r = rstd(stats, eps).to(ct)[:, None]
    xh = (_rows(x).to(ct).view(splits, -1, c) - stats[0][:, None].to(ct)) * r
    gs = _rows(gy).to(ct).view(splits, -1, c)
    mg, mgx = (m.to(ct)[:, None] for m in means)
    dx = weight.to(ct) * r * (gs - mg - xh * mgx)
    return _like(x, dx.to(x.dtype))


def _check(x: torch.Tensor, what: str) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"batch norm: {what} must be bfloat16 or float32, got {x.dtype}")
    if x.ndim < 2:
        raise ValueError(f"batch norm: {what} needs [N, C, ...], got {tuple(x.shape)}")
    if not channels_innermost(x):
        raise ValueError(f"batch norm: {what}'s channel dim must be innermost in memory "
                         f"(strides {x.stride()})")


def _same_rows(gy: torch.Tensor, x: torch.Tensor) -> None:
    """g and x both channels-innermost of one shape: the same [rows, C]."""
    if gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device:
        raise ValueError(f"batch norm: g ({gy.dtype} {tuple(gy.shape)} on {gy.device}) must have x's "
                         f"shape, type and device ({x.dtype} {tuple(x.shape)} on {x.device})")


def _on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on any other."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    return True


def _alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two, up to 16, dividing every data pointer."""
    align = VECTOR_BYTES
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


def _geometry(x: torch.Tensor, splits: int, *others: torch.Tensor) -> Tuple[int, tuple]:
    """The scratch floats and the C entry points' geometry arguments for x,
    from :func:`plan` (one plan a shape: the wrappers run on the host's
    clock, which paces the steps)."""
    _check_splits(x, splits)
    return _plan_args(x.numel() // x.shape[1], x.shape[1], splits, x.dtype, _alignment(x, *others))


@functools.lru_cache(maxsize=1024)
def _plan_args(rows: int, c: int, splits: int, dtype: torch.dtype, align: int) -> Tuple[int, tuple]:
    p = plan(rows, c, splits, dtype, align)
    return p["scratch"], (int(dtype == torch.bfloat16), p["rows_split"], p["rpb"], p["c"], p["splits"], p["vec"],
                          p["ct"], p["ctiles"], p["rpi"], p["nb"])


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _params(t: torch.Tensor, c: int, device, what: str) -> torch.Tensor:
    if t.shape != (c,) or t.device != device:
        raise ValueError(f"batch norm: {what} must be [{c}] on {device}, got {tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


def _stats_like(t: torch.Tensor, splits: int, c: int, device, what: str) -> torch.Tensor:
    if t.shape != (2, splits, c) or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"batch norm: {what} must be float32 [2, {splits}, {c}] on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def bn_stats(x: torch.Tensor, splits: int) -> torch.Tensor:
    """(mean, mean of squares) of each of x's ``splits`` row ranges, float32
    [2, splits, C]."""
    _check_splits(x, splits)
    if not _on_card(x, "bn_stats"):
        return bn_stats_plain(x, splits)
    _check(x, "x")
    scratch, geom = _geometry(x, splits)
    part = torch.empty(scratch, dtype=torch.float32, device=x.device)
    stats = torch.empty((2, splits, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch(_library().bn_stats, x.data_ptr(), part.data_ptr(), stats.data_ptr(), *geom, _stream(x))
    bn_stats.launches += 1
    return stats


def bn_apply(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float) -> torch.Tensor:
    """y = x * T(w) + T(b), the fold of ``stats`` with the affine ``weight``
    and ``bias``; y has x's shape, strides and type."""
    if not _on_card(x, "bn_apply"):
        return bn_apply_plain(x, stats, weight, bias, eps)
    _check(x, "x")
    c, splits = x.shape[1], stats.shape[1]
    stats = _stats_like(stats, splits, c, x.device, "stats")
    weight, bias = (_params(t, c, x.device, n) for t, n in ((weight, "weight"), (bias, "bias")))
    y = torch.empty_like(x)
    _, geom = _geometry(x, splits, y)
    _launch(_library().bn_apply, x.data_ptr(), y.data_ptr(), stats.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), float(eps), *geom, _stream(x))
    bn_apply.launches += 1
    return y


def bn_grad_stats(gy: torch.Tensor, x: torch.Tensor, stats: torch.Tensor,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean of g, mean of g * xh) of each split, float32 [2, splits, C], and
    (sum of g, sum of g * xh) over every row, float32 [2, C]."""
    if not _on_card(x, "bn_grad_stats"):
        return bn_grad_stats_plain(gy, x, stats, eps)
    _check(x, "x")
    _check(gy, "g")
    _same_rows(gy, x)
    c, splits = x.shape[1], stats.shape[1]
    stats = _stats_like(stats, splits, c, x.device, "stats")
    scratch, geom = _geometry(x, splits, gy)
    part = torch.empty(scratch, dtype=torch.float32, device=x.device)
    means = torch.empty((2, splits, c), dtype=torch.float32, device=x.device)
    totals = torch.empty((2, c), dtype=torch.float32, device=x.device)
    _launch(_library().bn_grad_stats, gy.data_ptr(), x.data_ptr(), stats.data_ptr(), float(eps),
            part.data_ptr(), means.data_ptr(), totals.data_ptr(), *geom, _stream(x))
    bn_grad_stats.launches += 1
    return means, totals


def bn_dx(gy: torch.Tensor, x: torch.Tensor, stats: torch.Tensor, means: torch.Tensor,
          weight: torch.Tensor, eps: float) -> torch.Tensor:
    """dx = scale * r * (g - mean_g - xh * mean_gxh) from the means of
    :func:`bn_grad_stats`; dx has x's shape, strides and type."""
    if not _on_card(x, "bn_dx"):
        return bn_dx_plain(gy, x, stats, means, weight, eps)
    _check(x, "x")
    _check(gy, "g")
    _same_rows(gy, x)
    c, splits = x.shape[1], stats.shape[1]
    stats = _stats_like(stats, splits, c, x.device, "stats")
    means = _stats_like(means, splits, c, x.device, "means")
    weight = _params(weight, c, x.device, "weight")
    dx = torch.empty_like(x)
    _, geom = _geometry(x, splits, gy, dx)
    _launch(_library().bn_dx, gy.data_ptr(), x.data_ptr(), stats.data_ptr(), means.data_ptr(),
            weight.data_ptr(), float(eps), dx.data_ptr(), *geom, _stream(x))
    bn_dx.launches += 1
    return dx


COUNTED = (bn_stats, bn_apply, bn_grad_stats, bn_dx, channels_last)  # each with its .launches
for _fn in COUNTED:
    _fn.launches = 0
