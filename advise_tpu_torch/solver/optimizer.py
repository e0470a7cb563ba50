"""The optimizer chains on named parameters (counterpart of
``advise_tpu/solver/optimizer.py``): SGD, Adam and AdamW, each with LARS,
and the per-parameter lr scales of SOLVER.LAYER_DECAY.

As in the JAX package the transformation produces an lr-free *direction*
and the step applies ``p -= lr * lr_scale * direction``, so momentum
buffers accumulate unscaled directions. The SGD chain, in order:

1. clip by global norm (SOLVER.CLIP_GRAD_NORM > 0);
2. coupled weight decay, ``g += wd * p`` with per-parameter wd;
3. LARS (SOLVER.LARS_ON): ``g *= ||p|| / ||g||`` on the JAX leaves with
   ndim > 1 (a reversible segment's blocks as one stacked leaf), and a
   ratio of 1 where either norm is 0 (``optax.scale_by_trust_ratio``);
4. the momentum trace, ``t = g + momentum * t``, emitting ``t`` or, with
   Nesterov, ``g + momentum * t``.

This is not torch's usual LARS: the trust ratio sits after the weight decay
and before the momentum, and the lr comes last. The Adam chains
(:class:`Adam`) put LARS in the same place, just before the last
transformation: 'adamw' is Adam, then LARS, then ``+ wd * p``; 'adam' is
``+ wd * p``, then LARS, then Adam.

Weight-decay groups follow the JAX tree: its reversible MViT stacks a
segment's parameters on a leading axis, so a LayerNorm scale or a bias there
is 2-D and decays under SOLVER.ZERO_WD_1D_PARAM; the port's per-block copies
(``rev_seg{n}_f.{k}.``) are counted with that axis, and LARS takes its
norms over the group of them (:func:`trust_groups`). The layer-decay scales
are read off each parameter's Flax path (:func:`flax_path`).
"""

from __future__ import annotations

import logging
import re
from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]
logger = logging.getLogger(__name__)

# parameter-path fragments that never receive weight decay
_NO_DECAY_PATTERNS = ("pos_embed", "cls_token", "rel_pos", "mask_token")
# a block of a reversible segment, whose JAX parameter has a stacking axis
_STACKED = re.compile(r"(^|\.)rev_seg\d+_[fg]\.\d+\.")


def adjust_base_lr(cfg) -> None:
    """In place: linear lr scaling of BASE_LR, COSINE_END_LR and
    WARMUP_START_LR by the global batch over 64, DATA.BATCHSIZE_PER_GPU x
    NUM_WORLDS (``advise_tpu/solver/optimizer.py:34``, reference
    utils/solver.py:7-16)."""
    scale = cfg.DATA.BATCHSIZE_PER_GPU * cfg.NUM_WORLDS / 64.0
    old = (cfg.SOLVER.BASE_LR, cfg.SOLVER.COSINE_END_LR, cfg.SOLVER.WARMUP_START_LR)
    cfg.SOLVER.BASE_LR *= scale
    cfg.SOLVER.COSINE_END_LR *= scale
    cfg.SOLVER.WARMUP_START_LR *= scale
    logger.info("Adjusting (BASE_LR, COSINE_END_LR, WARMUP_START_LR) from %s to %s (scale %.3f)",
                old, (cfg.SOLVER.BASE_LR, cfg.SOLVER.COSINE_END_LR, cfg.SOLVER.WARMUP_START_LR),
                scale)


def _path_str(name: str) -> str:
    """Torch parameter name -> the JAX package's path string."""
    return name.replace(".", "/")


_STACKED_BLOCK = re.compile(r"(^|\.)(rev_seg\d+_[fg])\.\d+\.")
_BLOCK_INDEX = re.compile(r"blocks?_?(\d+)")


def flax_path(name: str, p: torch.Tensor) -> str:
    """The JAX package's path string of the parameter the torch parameter
    ``name`` comes from (the inverse of ``utils/convert.py param_key``): a
    reversible segment's block index dropped (JAX stacks the segment), a
    conv or dense ``weight`` as ``kernel``, a norm's as ``scale``."""
    parts = _STACKED_BLOCK.sub(r"\1\2.", name).split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel" if p.ndim > 1 else "scale"
    return "/".join(parts)


def classify_params(cfg, params: Tensors) -> Dict[str, str]:
    """Label per parameter: 'frozen' | 'bn' | 'no_decay' | 'one_d' | 'default'."""

    def label(name: str, p: torch.Tensor) -> str:
        s = _path_str(name).lower()
        if "spatial_encoder" in s and not cfg.TM.FROM_SCRATCH:
            return "frozen"
        if cfg.LINEAR_PROBING and "head" not in s:
            return "frozen"
        if "/bn" in s or s.endswith(("bn/weight", "bn/bias")) or "_bn/" in s:
            return "bn"
        if cfg.MVIT.ZERO_DECAY_POS_CLS and any(pat in s for pat in _NO_DECAY_PATTERNS):
            return "no_decay"
        ndim = p.ndim + (1 if _STACKED.search(name) else 0)
        if ndim <= 1 and cfg.SOLVER.ZERO_WD_1D_PARAM:
            return "one_d"
        return "default"

    return {n: label(n, p) for n, p in params.items()}


def wd_tree(cfg, params: Tensors) -> Dict[str, float]:
    wd_map = {
        "default": cfg.SOLVER.WEIGHT_DECAY,
        "bn": cfg.BN.WEIGHT_DECAY,
        "no_decay": 0.0,
        "one_d": 0.0,
        "frozen": 0.0,
    }
    return {n: wd_map[l] for n, l in classify_params(cfg, params).items()}


def lr_scales(cfg, params: Tensors) -> Dict[str, float]:
    """Per-parameter lr multipliers (``layer_decay_scales`` of the JAX
    package): 0 for frozen parameters; else 1, or with SOLVER.LAYER_DECAY d
    != 1 ``d ** (MVIT.DEPTH + 1 - i)``, where on the parameter's Flax path
    i is 1 + the number after the first ``block``/``blocks``(``_``), or
    DEPTH + 1 for a path with ``head`` or ``projection`` (the regex comes
    first), else 0."""
    decay, depth = cfg.SOLVER.LAYER_DECAY, cfg.MVIT.DEPTH

    def scale(name: str, p: torch.Tensor) -> float:
        if decay == 1.0:
            return 1.0
        path = flax_path(name, p)
        m = _BLOCK_INDEX.search(path)
        if m:
            i = int(m.group(1)) + 1
        elif "head" in path or "projection" in path:
            i = depth + 1
        else:
            i = 0
        return decay ** (depth + 1 - i)

    labels = classify_params(cfg, params)
    return {n: 0.0 if labels[n] == "frozen" else scale(n, p) for n, p in params.items()}


SqReduce = Optional[Callable[[Tensors], Tensors]]


def _sum_sq(tensors: Tensors, reduce_sq: SqReduce = None) -> Tensors:
    """{name: the float32 sum of squares of the tensor}; ``reduce_sq``
    (``parallel/auto_shard.py AutoLayout.reduce_sq``) turns a rank's sums
    over its slices into the whole tensors' sums."""
    sq = {n: torch.sum(torch.square(t.float())) for n, t in tensors.items()}
    return sq if reduce_sq is None else reduce_sq(sq)


def global_grad_norm(grads: Tensors, reduce_sq: SqReduce = None) -> torch.Tensor:
    """Global 2-norm over all gradients, in float32 (over the whole tensors
    of a sharded layout with its ``reduce_sq``)."""
    return torch.sqrt(sum(_sum_sq(grads, reduce_sq).values()))


def trust_groups(names) -> Dict[str, list]:
    """The parameters that share one JAX leaf, keyed by that leaf's path: a
    reversible segment's per-block copies (``rev_seg{n}_f.{k}.``) form one
    group, every other parameter a group of its own."""
    groups: Dict[str, list] = {}
    for n in names:
        groups.setdefault(_STACKED_BLOCK.sub(r"\1\2.", n), []).append(n)
    return groups


def trust_ratio(updates: Tensors, params: Tensors, reduce_sq: SqReduce = None) -> Tensors:
    """LARS's layer-wise trust ratio (``optax.masked(scale_by_trust_ratio(),
    ndim > 1)``) per JAX leaf: ``u * ||p|| / ||u||``, the norms taken over
    the whole leaf, on leaves with ndim > 1; ``u`` where either norm is 0
    and on the others. A reversible segment's blocks are one stacked leaf in
    JAX (:func:`trust_groups`): one norm over the stack, the ratio applied
    to every block, and the mask read at the stacked ndim, so a block's 1-D
    LayerNorm scale gets a ratio too."""
    out = dict(updates)
    groups = {leaf: names for leaf, names in trust_groups(updates).items()
              if params[names[0]].ndim + (1 if _STACKED.search(names[0]) else 0) > 1}
    chosen = [n for names in groups.values() for n in names]
    p_sq = _sum_sq({n: params[n] for n in chosen}, reduce_sq)
    u_sq = _sum_sq({n: updates[n] for n in chosen}, reduce_sq)
    for names in groups.values():
        p_norm = torch.sqrt(sum(p_sq[n] for n in names))
        u_norm = torch.sqrt(sum(u_sq[n] for n in names))
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm), p_norm / u_norm)
        for n in names:
            out[n] = updates[n] * ratio
    return out


class SGDLars:
    """The chain above as ``init(params) -> state`` and
    ``update(grads, state, params) -> (direction, state)`` on dicts of
    tensors keyed by parameter name; the state is {'trace': {...}}."""

    def __init__(self, wds: Dict[str, float], momentum: float, nesterov: bool,
                 lars: bool, clip_norm: float = 0.0):
        self.wds = wds
        self.momentum = momentum
        self.nesterov = nesterov
        self.lars = lars
        self.clip_norm = clip_norm
        self.reduce_sq: SqReduce = None  # set for a sharded layout (parallel/auto_shard.py)

    def init(self, params: Tensors) -> Dict[str, Tensors]:
        return {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Tensors, state: Dict[str, Tensors], params: Tensors):
        g = dict(grads)
        if self.clip_norm > 0:
            norm = global_grad_norm(g, self.reduce_sq)
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            g = {n: v * scale.to(v.dtype) for n, v in g.items()}
        g = {n: v + self.wds[n] * params[n] for n, v in g.items()}
        if self.lars:
            g = trust_ratio(g, params, self.reduce_sq)
        trace = {n: g[n] + self.momentum * state["trace"][n] for n in g}
        if self.nesterov:
            direction = {n: g[n] + self.momentum * trace[n] for n in g}
        else:
            direction = trace
        return direction, {"trace": trace}


class Adam:
    """optax's Adam chains for SOLVER.OPTIMIZING_METHOD adamw (``decoupled``)
    and adam, as ``init(params) -> state`` and ``update(grads, state,
    params) -> (direction, state)``:

    1. clip by global norm (SOLVER.CLIP_GRAD_NORM > 0): g / ||g|| * clip
       when ||g|| >= clip;
    2. adam only: coupled weight decay, g += wd * param;
    3. adamw: the Adam step (4) comes here, before LARS;
    3'. LARS (``lars``): :func:`trust_ratio`;
    4. the Adam moments mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
       and the direction mu_hat / (sqrt(nu_hat) + eps), each bias-corrected
       by 1 - b^count in float32;
    5. adamw only: decoupled weight decay, direction += wd * param (the lr
       multiplies both later).

    The state is {'mu': {...}, 'nu': {...}, 'count': int}."""

    def __init__(self, wds: Dict[str, float], b1: float, b2: float, eps: float = 1e-8,
                 clip_norm: float = 0.0, decoupled: bool = True, lars: bool = False):
        self.wds = wds
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip_norm = clip_norm
        self.decoupled = decoupled
        self.lars = lars
        self.reduce_sq: SqReduce = None  # set for a sharded layout (parallel/auto_shard.py)

    def init(self, params: Tensors) -> Dict[str, Union[Tensors, int]]:
        return {"mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}, "count": 0}

    def _adam(self, g: Tensors, state):
        count = state["count"] + 1
        b1, b2 = self.b1, self.b2
        names = list(g)
        v = [g[n] for n in names]
        mu = torch._foreach_add(torch._foreach_mul(v, 1 - b1),
                                torch._foreach_mul([state["mu"][n] for n in names], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(v, v), 1 - b2),
                                torch._foreach_mul([state["nu"][n] for n in names], b2))
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, c2)), self.eps)
        direction = torch._foreach_div(torch._foreach_div(mu, c1), den)
        return dict(zip(names, direction)), {"mu": dict(zip(names, mu)), "nu": dict(zip(names, nu)), "count": count}

    def _plus_decay(self, g: Tensors, params: Tensors) -> Tensors:
        """g + wd * param, each leaf with its own wd."""
        names = list(g)
        decay = torch._foreach_mul([params[n] for n in names], [self.wds[n] for n in names])
        return dict(zip(names, torch._foreach_add([g[n] for n in names], decay)))

    @torch.no_grad()
    def update(self, grads: Tensors, state, params: Tensors):
        """Each step of the chain runs over all leaves at once (``torch._foreach_*``:
        the same elementwise operations in the same order as leaf by leaf, a few
        launches instead of ~14 a leaf)."""
        g = dict(grads)
        if self.clip_norm > 0:
            norm = global_grad_norm(g, self.reduce_sq)
            keep = norm < self.clip_norm
            names = list(g)
            scaled = torch._foreach_mul(torch._foreach_div([g[n] for n in names], norm), self.clip_norm)
            g = {n: torch.where(keep, g[n], s) for n, s in zip(names, scaled)}
        if not self.decoupled:
            g = self._plus_decay(g, params)
            if self.lars:
                g = trust_ratio(g, params, self.reduce_sq)
            return self._adam(g, state)
        direction, state = self._adam(g, state)
        if self.lars:
            direction = trust_ratio(direction, params, self.reduce_sq)
        return self._plus_decay(direction, params), state


class OptimizerBundle(NamedTuple):
    tx: Union[SGDLars, Adam]  # grads -> lr-free direction
    lr_scales: Dict[str, float]  # per-parameter lr multipliers


def build_tx(cfg, params: Tensors) -> OptimizerBundle:
    """SOLVER.OPTIMIZING_METHOD sgd, adamw or adam (each with LARS_ON) over
    named parameters, with the lr scales of :func:`lr_scales`."""
    method = cfg.SOLVER.OPTIMIZING_METHOD
    wds = wd_tree(cfg, params)
    lars, clip = cfg.SOLVER.LARS_ON, cfg.SOLVER.CLIP_GRAD_NORM
    if method in ("sgd", "simple_sgd"):
        if cfg.SOLVER.DAMPENING != 0.0:
            raise NotImplementedError("dampening unsupported")
        tx = SGDLars(wds, cfg.SOLVER.MOMENTUM, cfg.SOLVER.NESTEROV, lars, clip)
    elif method in ("adamw", "simple_adamw", "mt_adamw", "adam"):
        tx = Adam(wds, cfg.SOLVER.BETAS[0], cfg.SOLVER.BETAS[1], 1e-8, clip,
                  decoupled=method != "adam", lars=lars)
    else:
        raise NotImplementedError(f"SOLVER.OPTIMIZING_METHOD={method}")
    return OptimizerBundle(tx=tx, lr_scales=lr_scales(cfg, params))


@torch.no_grad()
def apply_direction(params: Tensors, direction: Tensors, lr: float,
                    scales: Dict[str, float]) -> None:
    """In place: p -= lr * scale * direction (the lr applied last)."""
    for n, p in params.items():
        p.sub_(lr * scales[n] * direction[n])
