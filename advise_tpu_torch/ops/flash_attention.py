"""K4: flash attention, forward and backward, as CUDA kernels and their
plain PyTorch versions.

Counterpart of ``advise_tpu/ops/flash_attention.py`` ``flash_mha`` (JAX's
library Pallas TPU flash attention with its custom-VJP backward), which
``MultiScaleAttention`` calls under TPU.FLASH_ATTENTION. Layouts are the JAX
function's: q ``[b, h, nq, d]``, k and v ``[b, h, nk, d]``; the output is
``softmax(q k^T * scale) v`` in v's dtype, accumulated in float32.

- :func:`flash_mha` is the entry point: a ``torch.autograd.Function`` whose
  forward is :func:`flash_mha_fwd` and whose backward is
  :func:`flash_mha_bwd`.
- Each of the two wrappers routes a CUDA tensor by :func:`route`: bf16 at a
  head dim up to 576 to the tensor-core kernels of ``csrc/flash_attention.cu``,
  float32 at any head dim and bf16 above 576 to the float32 pair of
  ``csrc/flash_attention_f32.cu`` (:func:`flash_f32_fwd`,
  :func:`flash_f32_bwd`), and raises on any other dtype. It runs its plain
  version (:func:`flash_fwd_plain`, :func:`flash_bwd_plain`) for a CPU
  tensor. There is no fallback from a CUDA tensor. Each wrapper that
  launches kernels counts its launches in ``.launches``: one per forward,
  one per backward (whose kernels, D, dK/dV, the split reduce where there
  are splits, and dQ, run as one call).
- :func:`plan` is how the tensor-core kernels run a shape: the template
  width, each kernel's warps, grid and shared memory, and the dK/dV
  kernel's query-range splits with their float32 scratch; :func:`f32_plan`
  the float32 pair's grids and shared memory. Both are plain arithmetic, so
  the CPU tests read them.
- :func:`flash_mha_plain` is the plain dense chain (float32 ``q * scale @
  k^T``, softmax, ``@ v``) that the kernels are held against on the card.

The forward saves the row log-sum-exp in base 2 (``lse = log2 sum_j
2^(s_ij log2 e)``), and the backward recomputes the probabilities from it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import re
from typing import Tuple

import torch

from advise_tpu_torch.ops import build

SOURCE = "flash_attention.cu"
SOURCE_F32 = "flash_attention_f32.cu"
LOG2E = 1.4426950408889634
SMS = 132  # streaming multiprocessors of an H100
SMEM_LIMIT = 232448  # dynamic shared memory a block may use
MAX_WARPS = 8
MAX_SPLITS = 16
# the dK/dV split count's cost model: a block's sustained bf16 rate on one
# SM (about a third of the 7.5 TFLOP/s peak of an SM) and the scratch's
# memory rate
SM_FLOPS = 2.5e12
HBM_BYTES_PER_S = 3.0e12
# tile widths per template width DP (csrc/flash_attention.cu Tiles<DP> holds
# the same; the card tests compare them): forward and dQ (BK keys a loop
# tile, DSPLIT warpgroups sharing 64 query rows, their columns split), dK/dV
# (BKV keys a block, BQ queries a loop tile, WC warps sharing 16 keys)
TILES = {
    64: {"fwd": (64, 1), "dq": (64, 1), "dkdv": (128, 64, 1)},
    80: {"fwd": (64, 1), "dq": (64, 1), "dkdv": (128, 64, 1)},
    144: {"fwd": (64, 1), "dq": (64, 1), "dkdv": (64, 64, 2)},
    192: {"fwd": (64, 1), "dq": (64, 1), "dkdv": (64, 64, 2)},
    288: {"fwd": (64, 1), "dq": (32, 1), "dkdv": (64, 32, 2)},
    576: {"fwd": (32, 2), "dq": (16, 2), "dkdv": (32, 32, 4)},
}
# the float32 pair (csrc/flash_attention_f32.cu holds the same): rows a
# block owns, output columns updated a pass, and the float32 output columns
# a block holds in shared memory (forward and dQ; dK and dV each)
F32_ROWS = 32
F32_VC = 128
F32_OUT_COLS = 1024
F32_OUT_COLS_KV = 512
F32_SCRATCH = 4 * 32 * 33 * 4 + 32 * 128 * 4 + 3 * 32 * 4  # sizeof(Scratch)
_lib = None
_lib_f32 = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [vp] * 5 + [ci] * 5 + [cf, vp]
        lib.flash_fwd.restype = ci
        lib.flash_bwd.argtypes = [vp] * 12 + [ci] * 5 + [cf, ci, vp]
        lib.flash_bwd.restype = ci
        lib.flash_tiles.argtypes = [ci, ctypes.POINTER(ci)]
        lib.flash_tiles.restype = ci
        lib.flash_occupancy.argtypes = [ci, ctypes.POINTER(ci)]
        lib.flash_occupancy.restype = ci
        _lib = lib
    return _lib


def _library_f32():
    global _lib_f32
    if _lib_f32 is None:
        lib = build.load(SOURCE_F32)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_f32_fwd.argtypes = [vp] * 5 + [ci] * 4 + [cf, ci, vp]
        lib.flash_f32_fwd.restype = ci
        lib.flash_f32_bwd.argtypes = [vp] * 10 + [ci] * 4 + [cf, ci, vp]
        lib.flash_f32_bwd.restype = ci
        lib.flash_f32_cols.argtypes = [ci, ci]
        lib.flash_f32_cols.restype = ci
        _lib_f32 = lib
    return _lib_f32


def compiled_tiles(dp: int) -> dict:
    """The tile widths the built library holds for template width ``dp``, in
    :data:`TILES`' form (builds the library on first use)."""
    out = (ctypes.c_int * 6)()
    if _library().flash_tiles(int(dp), out) != 0:
        raise ValueError(f"flash attention: no kernels compiled for width {dp}")
    return {"fwd": (out[0], out[1]), "dq": (out[2], out[1]), "dkdv": tuple(out[3:6])}


def occupancy(p: dict) -> dict:
    """Blocks of each kernel of plan ``p`` that one SM holds at once, from
    the CUDA occupancy calculator on the current card."""
    out = (ctypes.c_int * 3)()
    err = _library().flash_occupancy(p["dp"], out)
    if err != 0:
        raise RuntimeError(f"flash_occupancy failed: CUDA error {err}")
    return {"fwd": out[0], "dkdv": out[1], "dq": out[2]}


def kernel_usage() -> dict:
    """{(kernel, template width or None): registers a thread, spill bytes
    and static shared memory} of the built library, from ptxas -v."""
    usage = {}
    for name, u in build.ptxas_usage(SOURCE).items():
        m = re.search(r"(flash_[a-z]+(?:_[a-z]+)*?_kernel)(?:ILi(\d+)E)?", name)
        if m:
            usage[(m.group(1), int(m.group(2)) if m.group(2) else None)] = u
    return usage


def padded_dim(d: int) -> int:
    """The template width the kernels take head dim ``d`` at: the least
    width of :data:`TILES` that holds it."""
    for dp in sorted(TILES):
        if d <= dp:
            return dp
    raise ValueError(f"flash attention: head dim {d} is above the widest kernel ({max(TILES)})")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel pair a CUDA tensor of ``dtype`` at head dim ``d`` takes:
    "wgmma" (bf16 up to the widest template width) or "f32" (float32 at any
    head dim, bf16 above it). Raises TypeError for any other dtype."""
    if dtype == torch.bfloat16 and d <= max(TILES):
        return "wgmma"
    if dtype in (torch.bfloat16, torch.float32):
        return "f32"
    raise TypeError(f"flash attention: no kernel for {dtype}; it takes torch.bfloat16 or torch.float32")


def f32_cols(d: int, limit: int) -> int:
    """Output columns a block of the float32 pair holds: all of d up to
    ``limit``, else an equal split of d, in multiples of F32_VC."""
    return _cdiv(_cdiv(d, _cdiv(d, limit)), F32_VC) * F32_VC


@functools.lru_cache(maxsize=None)
def f32_plan(bh: int, nq: int, nk: int, d: int) -> dict:
    """How the float32 pair runs ``bh`` slices of (nq, nk, d): each kernel's
    grid (x, y, z: d split where a block cannot hold it) and dynamic shared
    memory, 256 threads a block. Pure arithmetic on the shapes."""
    cols, kv_cols = f32_cols(d, F32_OUT_COLS), f32_cols(d, F32_OUT_COLS_KV)
    rows = F32_ROWS
    return {
        "fwd": {"grid": (_cdiv(nq, rows), bh, _cdiv(d, cols)), "cols": cols,
                "smem": F32_SCRATCH + 4 * rows * cols},
        "bwd_pre": {"grid": (_cdiv(bh * nq, 8), 1, 1), "smem": 0},
        "dkdv": {"grid": (_cdiv(nk, rows), bh, _cdiv(d, kv_cols)), "cols": kv_cols,
                 "smem": F32_SCRATCH + 2 * 4 * rows * kv_cols},
        "dq": {"grid": (_cdiv(nq, rows), bh, _cdiv(d, cols)), "cols": cols,
               "smem": F32_SCRATCH + 4 * rows * cols},
    }


def fwd_smem(dp: int, bq: int, bk: int) -> int:
    # 32-column atoms of 64-byte rows, and 1 KB to align them
    return 1024 + 64 * _cdiv(dp, 32) * (bq + 4 * bk)


def dq_smem(dp: int, bq: int, bk: int) -> int:
    return 1024 + 64 * _cdiv(dp, 32) * (2 * bq + 4 * bk)


def dkdv_smem(dp: int, bkv: int, bq: int) -> int:
    return 2 * (2 * bkv + 4 * bq) * (dp + 8) + 4 * bkv * (bq + 8) + 16 * bq


def _splits(bh: int, nq: int, nk: int, d: int, dp: int) -> int:
    """Query-range splits of the dK/dV kernel: the count (1 to 16, at most
    one per query tile) whose waves of blocks plus the float32 partials'
    write and read take the least time under the SM_FLOPS model."""
    bkv, bq, _ = TILES[dp]["dkdv"]
    base = bh * _cdiv(nk, bkv)
    block_s = 8.0 * nq * bkv * dp / SM_FLOPS  # one block's whole query loop
    best = None
    for s in range(1, min(MAX_SPLITS, _cdiv(nq, bq)) + 1):
        scratch_s = 0.0 if s == 1 else 2 * 2 * s * bh * nk * d * 4 / HBM_BYTES_PER_S
        cost = _cdiv(base * s, SMS) * block_s / s + scratch_s
        if best is None or cost < best[0]:
            best = (cost, s)
    return best[1]


@functools.lru_cache(maxsize=None)
def plan(bh: int, nq: int, nk: int, d: int) -> dict:
    """How the kernels run ``bh`` slices of (nq, nk, d): per kernel its tile
    rows, warps, grid (x, y, z) and dynamic shared memory, the dK/dV splits
    and the bytes of their float32 scratch. Pure arithmetic on the shapes."""
    dp = padded_dim(d)
    tiles = TILES[dp]
    out = {"dp": dp}
    for name, smem in (("fwd", fwd_smem), ("dq", dq_smem)):
        bk, dsplit = tiles[name]  # two warpgroups of 64 rows, DSPLIT to a row
        rows = 128 // dsplit
        out[name] = {"rows": rows, "bk": bk, "dsplit": dsplit, "warps": MAX_WARPS,
                     "grid": (_cdiv(nq, rows), bh, 1), "smem": smem(dp, rows, bk)}
    bkv, bq, wc = tiles["dkdv"]
    splits = _splits(bh, nq, nk, d, dp)
    out["dkdv"] = {"rows": bkv, "bq": bq, "wc": wc, "warps": MAX_WARPS,
                   "grid": (_cdiv(nk, bkv), bh, splits), "smem": dkdv_smem(dp, bkv, bq)}
    out["splits"] = splits
    out["scratch_bytes"] = 2 * splits * bh * nk * d * 4 if splits > 1 else 0
    return out


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q * scale @ k^T) @ v in float32, returned in v's dtype."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(v.dtype)


def flash_fwd_plain(q, k, v, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function: (o in v's dtype, lse in base 2)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return o.to(v.dtype), lse * LOG2E


def flash_bwd_plain(q, k, v, o, lse, do, scale: float):
    """The backward kernels' function: dq, dk, dv from the probabilities
    recomputed from ``lse`` and D = rowsum(do * o)."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp2(s * LOG2E - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = torch.sum(gf * o.float(), dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name: str, x: torch.Tensor, shape, dtype=torch.bfloat16,
           aligned: bool = True) -> torch.Tensor:
    if x.dtype != dtype:
        raise TypeError(f"flash attention: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"flash attention: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    x = x.contiguous()
    if aligned and x.shape[-1] % 8 == 0 and x.data_ptr() % 16:
        raise ValueError(f"flash attention: {name} is not 16-byte aligned")
    return x


def _device_kind(*xs: torch.Tensor) -> str:
    kinds = {x.device.type for x in xs}
    if len({x.device for x in xs}) != 1:
        raise ValueError(f"flash attention: tensors on several devices {[x.device for x in xs]}")
    kind = kinds.pop()
    if kind not in ("cuda", "cpu"):
        raise RuntimeError(f"flash attention: no kernel for device {xs[0].device}")
    return kind


def _current(device: torch.device):
    """Make ``device`` the current card for a launch (a no-op when it is)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [b, h, nq, d] in v's dtype, lse [b, h, nq] float32 in base 2): the
    forward kernel for CUDA tensors, the plain version for CPU tensors."""
    if _device_kind(q, k, v) == "cpu":
        return flash_fwd_plain(q, k, v, scale)
    if q.ndim != 4:
        raise ValueError(f"flash attention: q must be [b, h, nq, d], got {tuple(q.shape)}")
    if route(q.dtype, q.shape[-1]) == "f32":
        return flash_f32_fwd(q, k, v, scale)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    q = _check("q", q, (b, h, nq, d))
    k = _check("k", k, (b, h, nk, d))
    v = _check("v", v, (b, h, nk, d))
    if nq == 0 or nk == 0:
        raise ValueError("flash attention: empty query or key set")
    if scale < 0:  # the kernel takes scale >= 0: the same softmax of (-q) k^T |scale|
        q, scale = -q, -scale
    o = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    p = plan(b * h, nq, nk, d)
    with _current(q.device):
        err = _library().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b * h, nq, nk, d, p["dp"], float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_mha_fwd.launches += 1
    return o, lse


def flash_mha_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) in q's, k's and v's dtypes: the three backward kernels
    (D, then dK/dV, then dQ) for CUDA tensors, the plain version for CPU
    tensors."""
    if _device_kind(q, k, v, o, lse, do) == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, scale)
    if route(q.dtype, q.shape[-1]) == "f32":
        return flash_f32_bwd(q, k, v, o, lse, do, scale)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    q = _check("q", q, (b, h, nq, d))
    k = _check("k", k, (b, h, nk, d))
    v = _check("v", v, (b, h, nk, d))
    o = _check("o", o, (b, h, nq, d))
    do = _check("do", do, (b, h, nq, d))
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, nq):
        raise ValueError(f"flash attention: lse must be float32 [b, h, nq], got {lse.dtype} {tuple(lse.shape)}")
    lse = lse.contiguous()
    p = plan(b * h, nq, nk, d)
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = None
    if p["splits"] > 1:  # float32 partial dK, dV of each query range
        part = torch.empty((2, p["splits"], b * h, nk, d), dtype=torch.float32, device=q.device)
    with _current(q.device):
        err = _library().flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part[0].data_ptr(),
            None if part is None else part[1].data_ptr(),
            b * h, nq, nk, d, p["dp"], float(scale), p["splits"],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err}")
    flash_mha_bwd.launches += 1
    return dq, dk, dv


flash_mha_fwd.launches = 0
flash_mha_bwd.launches = 0


def _f32_inputs(q, k, v, *more):
    """Shapes, dtype and contiguity of the float32 pair's inputs: q [b, h,
    nq, d], k and v [b, h, nk, d], ``more`` of q's shape, all of q's dtype
    (float32, or bf16 at any head dim)."""
    if q.ndim != 4:
        raise ValueError(f"flash attention: q must be [b, h, nq, d], got {tuple(q.shape)}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention: the float32 pair takes float32 or bf16, got {q.dtype}")
    if nq == 0 or nk == 0:
        raise ValueError("flash attention: empty query or key set")
    shapes = [(b, h, nq, d), (b, h, nk, d), (b, h, nk, d)] + [(b, h, nq, d)] * len(more)
    out = [_check(name, x, shape, q.dtype, aligned=False)  # scalar loads: any address
           for name, x, shape in zip(("q", "k", "v", "o", "do"), (q, k, v, *more), shapes)]
    return out, (b, h, nq, nk, d)


def flash_f32_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of the float32 pair: (o in q's dtype, lse float32 in base
    2), every product and sum in float32; the plain version for CPU
    tensors."""
    if _device_kind(q, k, v) == "cpu":
        return flash_fwd_plain(q, k, v, scale)
    (q, k, v), (b, h, nq, nk, d) = _f32_inputs(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    with _current(q.device):
        err = _library_f32().flash_f32_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b * h, nq, nk, d, float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_f32_fwd launch failed: CUDA error {err}")
    flash_f32_fwd.launches += 1
    return o, lse


def flash_f32_bwd(q, k, v, o, lse, do, scale: float):
    """The backward of the float32 pair (D, dK/dV, dQ kernels as one call):
    (dq, dk, dv) in q's dtype; the plain version for CPU tensors."""
    if _device_kind(q, k, v, o, lse, do) == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, scale)
    (q, k, v, o, do), (b, h, nq, nk, d) = _f32_inputs(q, k, v, o, do)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, nq):
        raise ValueError(f"flash attention: lse must be float32 [b, h, nq], got {lse.dtype} {tuple(lse.shape)}")
    lse = lse.contiguous()
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with _current(q.device):
        err = _library_f32().flash_f32_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, nq, nk, d, float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_f32_bwd launch failed: CUDA error {err}")
    flash_f32_bwd.launches += 1
    return dq, dk, dv


flash_f32_fwd.launches = 0
flash_f32_bwd.launches = 0


class FlashMHA(torch.autograd.Function):
    """Flash attention with the kernels' own backward: saves q, k, v, o and
    lse (no [nq, nk] tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_mha_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q @ k^T * scale) @ v through the flash kernels (CUDA) or their
    plain versions (CPU), differentiable in q, k and v."""
    return FlashMHA.apply(q, k, v, float(scale))
