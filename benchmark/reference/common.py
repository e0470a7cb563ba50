"""What the plain references share: the precision they compute in, the
per-leaf norms that the comparison reads, and the optimizer chain.

Everything here is plain PyTorch. It imports nothing of the measured
package: the optimizer chain is a frozen copy of
``advise_tpu_torch/solver/optimizer.py`` (SGDLars without LARS) at commit
5ad1cbe, written out for float32 tensors on one device.

Departures from the program, here and in every family that uses this file:

- float32 throughout, with TF32 off for convolutions and matrix products
  (:func:`fp32_math`); the program computes in bf16 under autocast.
- :class:`Precision` ``bf16`` runs the forward under bf16 autocast, a
  witness of what bf16 alone does to the numbers compared;
- :class:`Precision` ``bf16fold`` adds batch normalisation's bf16 fold
  to that, a second witness;
- :class:`Precision` ``fp8`` and ``int8`` are the precisions below bf16
  that a configuration's ``control`` names, not references: computed in
  float8 as fp8 training computes, every convolution's and linear layer's
  input, weight and output are rounded to e4m3 with one scale a tensor
  (its largest magnitude over 448), and the gradients that reach them to
  e5m2 (scale: the largest magnitude over 57344); in int8, each of those
  tensors and gradients is rounded to the 255 symmetric steps of one scale
  a tensor (its largest magnitude over 127); the products are taken in
  float32 between.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]
E4M3_MAX = 448.0
E5M2_MAX = 57344.0
INT8_MAX = 127.0
NAMES = ("fp32", "fp8", "int8", "bf16", "bf16fold")


@contextlib.contextmanager
def fp32_math():
    """TF32 off for cuDNN and cuBLAS while the reference runs; the previous
    settings come back after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Precision:
    """How a reference computes: ``fp32`` as it is written; ``fp8`` and
    ``int8`` (controls) in those types around its products; ``bf16`` and
    ``bf16fold`` are witnesses (see the module's docstring)."""

    def __init__(self, name: str = "fp32"):
        if name not in NAMES:
            raise ValueError(f"precision {name!r}: one of {NAMES}")
        self.name = name

    def autocast(self, device):
        """bf16: the forward under ``torch.autocast`` in bf16, as the program
        runs it (a witness for the comparison, not the reference)."""
        return torch.autocast(torch.device(device).type, dtype=torch.bfloat16,
                              enabled=self.name in ("bf16", "bf16fold"))

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """fp8: x rounded to e4m3 in the forward, the gradient that reaches
        it to e5m2 in the backward; int8: both to int8 steps."""
        if self.name == "fp8":
            return _Fp8.apply(x)
        if self.name == "int8":
            return _Int8.apply(x)
        return x

    def conv3d(self, x, w, stride=1, padding=0, dilation=1, groups=1, bias=None):
        return self.q(F.conv3d(self.q(x), self.q(w), bias, stride, padding, dilation, groups))

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def affine(self, x, mean, var, eps, scale, shift, shape):
        """Batch normalisation's normalise and affine: in float32, or under
        ``bf16fold`` as one multiply-add in bf16 with the per-channel factor
        and shift rounded to bf16 first (a witness of that form)."""
        w = torch.rsqrt(var + eps) * scale.view(shape)
        if self.name == "bf16fold":
            b = shift.view(shape) - mean * w
            return x.to(torch.bfloat16) * w.to(torch.bfloat16) + b.to(torch.bfloat16)
        return (x - mean) * w + shift.view(shape)


def round_fp8(x: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    """x rounded to the float8 type ``dtype`` under one scale, its largest
    magnitude over the type's ``largest``."""
    scale = x.abs().amax().clamp(min=1e-30) / largest
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2, E5M2_MAX)


def round_int8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to int8 under one symmetric scale, its largest magnitude
    over 127."""
    scale = x.abs().amax().clamp(min=1e-30) / INT8_MAX
    return torch.round(x / scale).clamp_(-INT8_MAX, INT8_MAX) * scale


class _Int8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_int8(x)

    @staticmethod
    def backward(ctx, g):
        return round_int8(g)


def leaf_norms(tensors: Tensors) -> Dict[str, float]:
    """{name: float64 2-norm} of each tensor, read to the host in one copy."""
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].detach().double()) for n in names])
    return dict(zip(names, norms.cpu().tolist()))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


class SGD:
    """SGD with coupled weight decay and a momentum trace, optionally
    Nesterov, and an optional clip by global norm first: the direction is
    ``t`` (or ``g + m t`` under Nesterov) with ``t = g + m t``, ``g`` the
    clipped gradient plus ``wd * p``; the step subtracts ``lr * direction``."""

    def __init__(self, wds: Dict[str, float], momentum: float, nesterov: bool, clip_norm: float = 0.0):
        self.wds, self.momentum, self.nesterov, self.clip_norm = wds, momentum, nesterov, clip_norm

    def init(self, params: Tensors):
        return {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}

    def received(self, grads: Tensors) -> Tensors:
        """The gradient as the chain holds it after its clip."""
        if self.clip_norm <= 0:
            return dict(grads)
        norm = global_norm(grads.values())
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm), self.clip_norm / norm)
        return {n: g * scale for n, g in grads.items()}

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state, lr: float):
        g = {n: v + self.wds[n] * params[n] for n, v in self.received(grads).items()}
        trace = {n: g[n] + self.momentum * state["trace"][n] for n in g}
        for n, p in params.items():
            d = g[n] + self.momentum * trace[n] if self.nesterov else trace[n]
            p.sub_(lr * d)
        return {"trace": trace}
