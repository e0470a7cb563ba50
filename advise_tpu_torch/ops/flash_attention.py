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
- Each of the two wrappers launches its kernels of ``csrc/flash_attention.cu``
  for a CUDA tensor (bf16 only; it raises on anything else) and runs its plain
  version (:func:`flash_fwd_plain`, :func:`flash_bwd_plain`) for a CPU
  tensor. There is no fallback from a CUDA tensor. Each counts its launches
  in ``.launches``: one per forward, one per backward (whose three kernels
  run as one call).
- :func:`flash_mha_plain` is the plain dense chain (float32 ``q * scale @
  k^T``, softmax, ``@ v``) that the kernels are held against on the card.

The forward saves the row log-sum-exp in base 2 (``lse = log2 sum_j
2^(s_ij log2 e)``), and the backward recomputes the probabilities from it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from advise_tpu_torch.ops import build

SOURCE = "flash_attention.cu"
LOG2E = 1.4426950408889634
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [vp] * 5 + [ci] * 4 + [cf, vp]
        lib.flash_fwd.restype = ci
        lib.flash_bwd.argtypes = [vp] * 10 + [ci] * 4 + [cf, vp]
        lib.flash_bwd.restype = ci
        lib.flash_tiles.argtypes = [ci, ctypes.POINTER(ci)]
        lib.flash_tiles.restype = ci
        _lib = lib
    return _lib


def tile_config(d: int) -> dict:
    """The kernels' tiles at head dim ``d`` (built on first use): forward
    (BQ, BK), dK/dV (BK, BQ) and dQ (BQ, BK)."""
    out = (ctypes.c_int * 6)()
    if _library().flash_tiles(int(d), out) != 0:
        raise ValueError(f"flash attention: no tile configuration fits head dim {d}")
    return {"fwd": (out[0], out[1]), "dkdv": (out[2], out[3]), "dq": (out[4], out[5])}


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


def _check(name: str, x: torch.Tensor, shape) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash attention: {name} must be torch.bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"flash attention: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    x = x.contiguous()
    if x.shape[-1] % 8 == 0 and x.data_ptr() % 16:
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


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [b, h, nq, d] in v's dtype, lse [b, h, nq] float32 in base 2): the
    forward kernel for CUDA tensors, the plain version for CPU tensors."""
    if _device_kind(q, k, v) == "cpu":
        return flash_fwd_plain(q, k, v, scale)
    if q.ndim != 4:
        raise ValueError(f"flash attention: q must be [b, h, nq, d], got {tuple(q.shape)}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    q = _check("q", q, (b, h, nq, d))
    k = _check("k", k, (b, h, nk, d))
    v = _check("v", v, (b, h, nk, d))
    if nq == 0 or nk == 0:
        raise ValueError("flash attention: empty query or key set")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b * h, nq, nk, d, float(scale), torch.cuda.current_stream().cuda_stream)
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
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _library().flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, nq, nk, d, float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err}")
    flash_mha_bwd.launches += 1
    return dq, dk, dv


flash_mha_fwd.launches = 0
flash_mha_bwd.launches = 0


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
