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
  head dim up to 768 to the bf16 kernels of ``csrc/flash_attention.cu``,
  float32 at any head dim and bf16 above 768 to the float32 pair of
  ``csrc/flash_attention_f32.cu`` (also tensor cores, in 3xTF32; :func:`flash_f32_fwd`,
  :func:`flash_f32_bwd`), and raises on any other dtype. It runs its plain
  version (:func:`flash_fwd_plain`, :func:`flash_bwd_plain`) for a CPU
  tensor. There is no fallback from a CUDA tensor. Each wrapper that
  launches kernels counts its launches in ``.launches``: one per forward,
  one per backward (whose kernels, D, dK/dV, the split reduce where there
  are splits, and dQ, run as one call).
- :func:`plan` is how the bf16 kernels run a shape: the template width,
  each kernel's warps, grid and shared memory, the dK/dV kernel's
  query-range splits with their float32 scratch, and at width 768 the
  forward's split of its last query tiles over key ranges (their float32
  partials) and the bf16 dS scratch of the dQ GEMM; :func:`f32_plan` the same
  for the float32 pair: the source's make_plan (:func:`f32_kernel_plan`:
  tiles, warps, column parts, shared memory; :func:`compiled_f32_plan` reads
  the built library's for the card tests) with the dK/dV splits. Both are
  plain arithmetic, so the CPU tests read them.
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
MAX_WARPS = 8  # the dK/dV kernel's warps
MAX_SPLITS = 16
# the dK/dV split count's cost model: a block's sustained bf16 rate on one
# SM (about a third of the 7.5 TFLOP/s peak of an SM) and the scratch's
# memory rate
SM_FLOPS = 2.5e12
HBM_BYTES_PER_S = 3.0e12
# tile widths per template width DP (csrc/flash_attention.cu Tiles<DP> holds
# the same; the card tests compare them): forward and dQ (BK keys a loop
# tile; DSPLIT 1: two warpgroups of 64 query rows each, else DSPLIT
# warpgroups sharing 64 rows, their columns split; DSPLIT 3 also splits S's
# contraction, and its dQ is a GEMM on dS with BK keys a tile), dK/dV (BKV
# keys a block, BQ queries a loop tile, WC warps sharing 16 keys; under 8
# query columns a warp, the S^T and dP^T n-tiles share out d)
TILES = {
    64: {"fwd": (64, 1), "dq": (64, 1), "dkdv": (128, 64, 1)},
    80: {"fwd": (64, 1), "dq": (64, 1), "dkdv": (128, 64, 1)},
    144: {"fwd": (64, 1), "dq": (64, 1), "dkdv": (64, 64, 2)},
    192: {"fwd": (64, 1), "dq": (64, 1), "dkdv": (64, 64, 2)},
    288: {"fwd": (64, 1), "dq": (32, 1), "dkdv": (64, 32, 2)},
    576: {"fwd": (32, 2), "dq": (16, 2), "dkdv": (32, 32, 4)},
    768: {"fwd": (16, 3), "dq": (64, 3), "dkdv": (16, 16, 8)},
}
# the float32 pair, 3xTF32 on the tensor cores (csrc/flash_attention_f32.cu
# holds the same): a row's pitch in shared memory is its width + F32_PAD
# floats; up to F32_RES_MAX columns one operand of a kernel stays resident,
# above it the contraction over d streams in chunks of F32_DC columns (per
# kernel: the source's DC_OF) and the output columns split into parts of at
# most F32_RES_MAX; a two-stage ring
F32_PAD = 4
F32_DC = {"fwd": 144, "dq": 32, "dkdv": 144}
F32_RES_MAX = 288
F32_STAGES = 2
# per kernel and tier (head dim rounded to 8: <= 72, <= 144, above; bf16
# always the last): accumulator columns a warp holds (CW), keys a loop tile
# (dK/dV: queries), warps a block (CW_OF, BK_OF, WARPS_OF of the source)
F32_TILES = {
    "fwd": ((72, 64, 8), (144, 32, 8), (288, 32, 8)),
    "dq": ((72, 32, 8), (144, 32, 8), (288, 16, 4)),
    "dkdv": ((72, 32, 8), (144, 32, 8), (144, 16, 8)),
}
F32_KERNELS = ("fwd", "dq", "dkdv")  # the source's Kernel enum, in order
F32_PLAN_KEYS = ("cw", "bk", "warps", "wc", "rows", "stream", "kc", "cols", "parts", "smem")
# the fragment mapping of the pair's mma.sync m16n8k8 TF32 (acc_to_a and
# load_b of the source): register i of a P or dS A operand is accumulator
# register F32_ACC_TO_A[i], and B register j of lane t reads row
# F32_B_ROWS[j][t] of each 8-row slab of V, K, dO or Q
F32_ACC_TO_A = (0, 2, 1, 3)
F32_B_ROWS = ((0, 2, 4, 6), (1, 3, 5, 7))
# the dK/dV split count's cost model: one SM's float32-equivalent rate in
# 3xTF32 (a third of its share of the 495 TFLOP/s TF32 peak, over the
# three MMAs a product takes) and the shared memory of an SM
F32_SM_FLOPS = 495e12 / SMS / 3 / 3
SM_SMEM = 233472
_lib = None
_lib_f32 = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [vp] * 6 + [ci] * 5 + [cf, ci, ci, vp]
        lib.flash_fwd.restype = ci
        lib.flash_bwd.argtypes = [vp] * 13 + [ci] * 5 + [cf, ci, vp]
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
        lib.flash_f32_bwd.argtypes = [vp] * 12 + [ci] * 4 + [cf, ci, ci, vp]
        lib.flash_f32_bwd.restype = ci
        lib.flash_f32_plan.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        lib.flash_f32_plan.restype = ci
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
    "wgmma" (bf16 up to the widest template width, 768) or "f32" (float32 at
    any head dim, bf16 above it). Raises TypeError for any other dtype."""
    if dtype == torch.bfloat16 and d <= max(TILES):
        return "wgmma"
    if dtype in (torch.bfloat16, torch.float32):
        return "f32"
    raise TypeError(f"flash attention: no kernel for {dtype}; it takes torch.bfloat16 or torch.float32")


def f32_kernel_plan(kernel: str, d: int, bf16: bool = False) -> dict:
    """How kernel ``kernel`` ("fwd", "dq" or "dkdv") of the float32 pair
    runs head dim ``d``: the source's make_plan, key for key
    (:data:`F32_PLAN_KEYS`)."""
    d8 = _cdiv(d, 8) * 8
    tier = 2 if bf16 or d8 > 144 else 1 if d8 > 72 else 0  # the source's tier_of
    cw, bk, warps = F32_TILES[kernel][tier]
    stream = int(d8 > F32_RES_MAX)
    parts = _cdiv(d, F32_RES_MAX) if stream else 1
    cols = _cdiv(_cdiv(d, parts), 8) * 8 if stream else d8
    kc = F32_DC[kernel] if stream else d8
    wc = _cdiv(cols, cw) if kernel == "dkdv" else 1
    rows = 16 * warps // wc
    pc, po = kc + F32_PAD, cols + F32_PAD
    if kernel == "fwd":  # Q resident; units: K (or chunks of Q and K), then V
        res = 0 if stream else rows * pc
        slot = max((rows * pc if stream else 0) + bk * pc, bk * po)
    elif kernel == "dq":  # Q, dO resident; units: K and V (or chunks, then K)
        res = 0 if stream else 2 * rows * pc
        slot = max(2 * (rows + bk) * pc, bk * po) if stream else 2 * bk * pc
    else:  # K, V resident; units: Q and dO (or chunks, then Q and dO); lse, D
        res = 0 if stream else 2 * rows * pc
        slot = (max(2 * (rows + bk) * pc, 2 * bk * po) if stream else 2 * bk * pc) + 2 * bk
    return {"cw": cw, "bk": bk, "warps": warps, "wc": wc, "rows": rows, "stream": stream,
            "kc": kc, "cols": cols, "parts": parts, "smem": 4 * (res + F32_STAGES * slot)}


def _f32_splits(bh: int, nq: int, nk: int, d: int, p: dict) -> int:
    """Query-range splits of the float32 dK/dV kernel: the count (1 to 16,
    at most one per query tile) whose waves of blocks plus the float32
    partials' write and read take the least time under the F32_SM_FLOPS
    model."""
    base = _cdiv(nk, p["rows"]) * bh * p["parts"]
    per_sm = max(1, min(SM_SMEM // (p["smem"] + 1024), 8 // p["warps"]))
    wave_s = per_sm * 8.0 * nq * p["rows"] * d / F32_SM_FLOPS  # a wave's blocks, unsplit
    best = None
    for s in range(1, min(MAX_SPLITS, _cdiv(nq, p["bk"])) + 1):
        scratch_s = 0.0 if s == 1 else 2 * 2 * s * bh * nk * d * 4 / HBM_BYTES_PER_S
        cost = _cdiv(base * s, SMS * per_sm) * wave_s / s + scratch_s
        if best is None or cost < best[0]:
            best = (cost, s)
    return best[1]


@functools.lru_cache(maxsize=None)
def f32_plan(bh: int, nq: int, nk: int, d: int, bf16: bool = False) -> dict:
    """How the float32 pair runs ``bh`` slices of (nq, nk, d): per kernel
    its :func:`f32_kernel_plan` with its grid (x, y, z: column parts, for
    dK/dV times the query-range splits), the splits and the bytes of their
    float32 scratch. Pure arithmetic on the shapes."""
    out = {}
    for kernel, n in (("fwd", nq), ("dq", nq), ("dkdv", nk)):
        p = f32_kernel_plan(kernel, d, bf16)
        p["grid"] = (_cdiv(n, p["rows"]), bh, p["parts"])
        out[kernel] = p
    splits = _f32_splits(bh, nq, nk, d, out["dkdv"])
    gx, gy, gz = out["dkdv"]["grid"]
    out["dkdv"]["grid"] = (gx, gy, gz * splits)
    out["bwd_pre"] = {"grid": (_cdiv(bh * nq, 8), 1, 1), "smem": 0}
    out["splits"] = splits
    out["scratch_bytes"] = 2 * splits * bh * nk * d * 4 if splits > 1 else 0
    return out


def compiled_f32_plan(kernel: str, d: int, bf16: bool = False) -> dict:
    """The launch plan the built float32 library computes for ``kernel`` at
    head dim ``d``, in :func:`f32_kernel_plan`'s form (builds the library on
    first use)."""
    out = (ctypes.c_int * len(F32_PLAN_KEYS))()
    if _library_f32().flash_f32_plan(F32_KERNELS.index(kernel), int(d), int(bf16), out) != 0:
        raise ValueError(f"flash attention: no float32 plan for {kernel} at head dim {d}")
    return dict(zip(F32_PLAN_KEYS, out))


def f32_kernel_usage() -> dict:
    """{(kernel, "float32" or "bf16", CW, BK or None): registers a thread,
    spill bytes and static shared memory} of the built float32 library,
    from ptxas -v."""
    usage = {}
    for name, u in build.ptxas_usage(SOURCE_F32).items():
        m = re.search(r"(flash_f32_[a-z]+_kernel)I(f|13__nv_bfloat16)(?:Li(\d+)ELi(\d+)E)?", name)
        if m:
            dtype = "float32" if m.group(2) == "f" else "bf16"
            cw, bk = (int(m.group(3)), int(m.group(4))) if m.group(3) else (None, None)
            usage[(m.group(1), dtype, cw, bk)] = u
    return usage


def block_rows(dsplit: int) -> int:
    """Query rows of a forward or dQ block: two warpgroups of 64 at DSPLIT
    1, else 64 that the DSPLIT warpgroups share."""
    return 128 if dsplit == 1 else 64


def block_warps(dsplit: int) -> int:
    """Warps of a forward or dQ block: two warpgroups, or DSPLIT of them."""
    return 4 * max(2, dsplit)


def fwd_smem(dp: int, bk: int, dsplit: int) -> int:
    # 32-column atoms of 64-byte rows, and 1 KB to align them: Q and two
    # stages of K and V; DSPLIT 3: the warpgroups' float32 partial S tiles
    return (1024 + 64 * _cdiv(dp, 32) * (block_rows(dsplit) + 4 * bk)
            + (4 * dsplit * 64 * bk if dsplit > 2 else 0))


def dq_smem(dp: int, bk: int, dsplit: int) -> int:
    if dsplit > 2:  # the GEMM on dS: two stages of a dS tile (64 x bk) and a K tile (bk x dp)
        return 1024 + 2 * 64 * (_cdiv(bk, 32) * 64 + _cdiv(dp, 32) * bk)
    return 1024 + 64 * _cdiv(dp, 32) * (2 * block_rows(dsplit) + 4 * bk)


def dkdv_smem(dp: int, bkv: int, bq: int, wc: int) -> int:
    # K, V, two stages of Q and dO, P^T and dS^T, lse and D; under 8 query
    # columns a warp, the 8 warps' partial n-tiles
    return (2 * (2 * bkv + 4 * bq) * (dp + 8) + 4 * bkv * (bq + 8) + 16 * bq
            + (4 * MAX_WARPS * 32 * 4 if bq // wc < 8 else 0))


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


def _fwd_tail(bh: int, nq: int, nk: int, dp: int) -> dict:
    """DSPLIT 3's forward: its query tiles, slice-major on a 1-D grid, run
    whole, one block each, but for the tiles past the last full wave of
    SMS blocks (one block an SM), each of which runs as ``ksplit`` blocks
    over contiguous key ranges (as many as the SMs over those tiles, at
    most one a key tile) whose float32 partials (O, row max and sum: 64 x
    dp + 128 floats) a combine kernel sums in range order. Elsewhere the
    forward's 2-D grid, no split."""
    bk, dsplit = TILES[dp]["fwd"]
    if dsplit <= 2:
        return {"whole": None, "ksplit": 1, "part_bytes": 0}
    tiles = bh * _cdiv(nq, block_rows(dsplit))
    rem = tiles % SMS if tiles > SMS else 0
    ksplit = min(_cdiv(nk, bk), SMS // rem) if rem else 1
    if ksplit <= 1:
        rem, ksplit = 0, 1
    whole = tiles - rem
    return {"whole": whole, "ksplit": ksplit, "grid": (whole + rem * ksplit, 1, 1),
            "part_bytes": 4 * rem * ksplit * (64 * dp + 128)}


@functools.lru_cache(maxsize=None)
def plan(bh: int, nq: int, nk: int, d: int) -> dict:
    """How the kernels run ``bh`` slices of (nq, nk, d): per kernel its tile
    rows, warps, grid (x, y, z) and dynamic shared memory, the dK/dV splits
    and the bytes of their float32 scratch, and the bytes of the bf16 dS
    scratch [bh, nq, nk rounded up to the dK/dV kernel's keys] that the dQ
    GEMM reads at DSPLIT 3 (0 elsewhere). Pure arithmetic on the shapes."""
    dp = padded_dim(d)
    tiles = TILES[dp]
    out = {"dp": dp}
    for name, smem in (("fwd", fwd_smem), ("dq", dq_smem)):
        bk, dsplit = tiles[name]
        rows = block_rows(dsplit)
        out[name] = {"rows": rows, "bk": bk, "dsplit": dsplit, "warps": block_warps(dsplit),
                     "grid": (_cdiv(nq, rows), bh, 1), "smem": smem(dp, bk, dsplit)}
    out["fwd"].update(_fwd_tail(bh, nq, nk, dp))
    bkv, bq, wc = tiles["dkdv"]
    splits = _splits(bh, nq, nk, d, dp)
    out["dkdv"] = {"rows": bkv, "bq": bq, "wc": wc, "warps": MAX_WARPS,
                   "grid": (_cdiv(nk, bkv), bh, splits), "smem": dkdv_smem(dp, bkv, bq, wc)}
    out["splits"] = splits
    out["scratch_bytes"] = 2 * splits * bh * nk * d * 4 if splits > 1 else 0
    out["ds_bytes"] = 2 * bh * nq * _cdiv(nk, bkv) * bkv if tiles["dq"][1] > 2 else 0
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
    f = p["fwd"]
    part = None
    if f["part_bytes"]:  # float32 partials of the split tiles' key ranges
        part = torch.empty(f["part_bytes"] // 4, dtype=torch.float32, device=q.device)
    with _current(q.device):
        err = _library().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            None if part is None else part.data_ptr(), b * h, nq, nk, d, p["dp"], float(scale),
            f["whole"] or 0, f["ksplit"], torch.cuda.current_stream().cuda_stream)
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
    part = ds = None
    if p["splits"] > 1:  # float32 partial dK, dV of each query range
        part = torch.empty((2, p["splits"], b * h, nk, d), dtype=torch.float32, device=q.device)
    if p["ds_bytes"]:  # dS, bf16, for the dQ GEMM
        ds = torch.empty(p["ds_bytes"] // 2, dtype=torch.bfloat16, device=q.device)
    with _current(q.device):
        err = _library().flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part[0].data_ptr(),
            None if part is None else part[1].data_ptr(),
            None if ds is None else ds.data_ptr(),
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
    # any address: the kernels copy 16 bytes at a time only where every
    # operand is 16-byte aligned, 4 otherwise
    out = [_check(name, x, shape, q.dtype, aligned=False)
           for name, x, shape in zip(("q", "k", "v", "o", "do"), (q, k, v, *more), shapes)]
    return out, (b, h, nq, nk, d)


def flash_f32_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of the float32 pair: (o in q's dtype, lse float32 in base
    2), every product in 3xTF32 and every sum in float32; the plain version
    for CPU tensors."""
    if _device_kind(q, k, v) == "cpu":
        return flash_fwd_plain(q, k, v, scale)
    (q, k, v), (b, h, nq, nk, d) = _f32_inputs(q, k, v)
    if scale < 0:  # the kernel takes scale >= 0: the same softmax of (-q) k^T |scale|
        q, scale = -q, -scale
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
    bf16 = q.dtype == torch.bfloat16
    p = f32_plan(b * h, nq, nk, d, bf16)
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = None
    if p["splits"] > 1:  # float32 partial dK, dV of each query range
        part = torch.empty((2, p["splits"], b * h, nk, d), dtype=torch.float32, device=q.device)
    with _current(q.device):
        err = _library_f32().flash_f32_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part[0].data_ptr(),
            None if part is None else part[1].data_ptr(),
            b * h, nq, nk, d, float(scale), p["splits"], int(bf16),
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
