"""Initializers and the common transformer blocks (counterpart of
``advise_tpu/models/layers/common.py``): dropout, DropPath, Mlp,
TwoStreamFusion.

Modules record how their weights are initialized (``weight_init``, and
``bias_value`` for a constant bias; ``param_inits`` for free parameters)
when they are built; :func:`init_weights` then draws every weight from one
explicit ``torch.Generator``, so a model is a function of its seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# the std of a unit normal truncated to [-2, 2] (Flax's variance_scaling
# divides by it so that the truncated draw keeps the requested variance)
_TRUNC_STD = 0.87962566103423978


def msra_init(w: torch.Tensor, generator: torch.Generator) -> None:
    """Caffe2 MSRA fill: normal with std sqrt(2 / fan_out), fan_out over the
    conv kernel (Flax ``variance_scaling(2.0, 'fan_out', 'normal')``)."""
    nn.init.kaiming_normal_(w, mode="fan_out", nonlinearity="relu", generator=generator)


def zeros_init(w: torch.Tensor, generator: torch.Generator) -> None:
    nn.init.zeros_(w)


def constant_init(value: float):
    """Flax ``initializers.constant(value)`` (the layer-scale gammas)."""

    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.constant_(w, value)

    return init


def layer_scale_gamma(module: nn.Module, name: str, dim: int, value: float) -> None:
    """A layer-scale gamma [dim] on ``module`` starting at ``value`` (none
    when 0; MVIT.LAYER_SCALE_INIT_VALUE)."""
    if value > 0:
        setattr(module, name, nn.Parameter(torch.zeros(dim)))
        module.param_inits = {**getattr(module, "param_inits", {}), name: constant_init(value)}


def xavier_init(w: torch.Tensor, generator: torch.Generator) -> None:
    nn.init.xavier_uniform_(w, generator=generator)


def fc_init(std: float):
    """Reference fc init: normal(0, std), zero bias."""

    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.normal_(w, 0.0, std, generator=generator)

    return init


def trunc_normal_init(std: float, corrected: bool = False):
    """Flax ``truncated_normal(stddev=std)``: a normal of std ``std``
    truncated at two standard deviations, so that the draw's own std is
    0.88 ``std``; ``corrected`` first widens the normal by 1 / 0.88, so that
    the truncated draw has std ``std``, as Flax's ``variance_scaling``
    does."""

    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        s = std / _TRUNC_STD if corrected else std
        nn.init.trunc_normal_(w, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)

    return init


def lecun_normal_init(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default kernel init: truncated normal with variance 1 / fan_in
    (fan_in over the input channels and the kernel window)."""
    fan_in, _ = nn.init._calculate_fan_in_and_fan_out(w)
    trunc_normal_init((1.0 / fan_in) ** 0.5, corrected=True)(w, generator)


trunc02 = trunc_normal_init(0.02)


def divided_init(init, div: float):
    """``init`` with the drawn weight divided by ``div`` (MAE's depth
    rescale, MASK.SCALE_INIT_BY_DEPTH); ``init`` itself when ``div`` is 1."""
    if div == 1.0:
        return init

    def scaled(w: torch.Tensor, generator: torch.Generator) -> None:
        init(w, generator)
        w.div_(div)

    return scaled


def conv3d(dim_in: int, dim_out: int, kernel, stride=1, padding=0,
           dilation=1, groups: int = 1, init=msra_init) -> nn.Conv3d:
    """Bias-free Conv3d whose weight is drawn by ``init`` (MSRA by default;
    ``zeros_init`` for RESNET.ZERO_INIT_FINAL_CONV)."""
    conv = nn.Conv3d(
        dim_in, dim_out, kernel, stride=stride, padding=padding,
        dilation=dilation, groups=groups, bias=False,
    )
    conv.weight_init = init
    return conv


def dense(dim_in: int, dim_out: int, bias: bool = True, init=xavier_init,
          bias_value: float = 0.0) -> nn.Linear:
    fc = nn.Linear(dim_in, dim_out, bias=bias)
    fc.weight_init = init
    fc.bias_value = bias_value
    return fc


def layer_norm(dim: int) -> nn.LayerNorm:
    """Flax ``nn.LayerNorm()``: epsilon 1e-6, scale and bias."""
    return nn.LayerNorm(dim, eps=1e-6)


def draw_keep(batch: int, rate: float, generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
    """A stochastic-depth keep mask [batch] (True with probability 1 - rate)
    from ``generator`` on its device; None when ``rate`` is 0."""
    if rate <= 0.0:
        return None
    if generator is None:
        raise ValueError("drop path in training needs a torch.Generator")
    return torch.rand(batch, generator=generator, device=generator.device) < (1.0 - rate)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            part: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Flax ``nn.Dropout`` in training: keep each value with probability
    1 - rate and scale it by 1 / (1 - rate), the mask drawn from
    ``generator`` on its device (never the global RNG). ``part`` (size,
    index): ``x`` is part ``index`` of ``size`` of a tensor split on its
    last dim, and its mask that part of the whole tensor's draw."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    if part is None:
        mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    else:
        size, index = part
        n = x.shape[-1]
        whole = torch.rand(x.shape[:-1] + (n * size,), generator=generator, device=generator.device)
        mask = whole[..., index * n:(index + 1) * n] < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def draw_seeds(n: int, generator: Optional[torch.Generator]):
    """``n`` seeds (Python ints) drawn from ``generator`` in one call: a
    block seeds its own dropout generator from one (:func:`seeded_generator_from`),
    so a recomputation of the block (REMAT, the reversible backward) draws
    the masks it drew the first time."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    return torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()


def seeded_generator_from(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed``; None for None."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


class DropPath(nn.Module):
    """Stochastic depth per sample with its keep mask [B] given from outside
    (:func:`draw_keep`), so a recomputation (REMAT, the reversible backward)
    replays it bit for bit. ``keep`` None is the identity."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        if keep is None or self.rate == 0.0:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(keep.to(x.device).view(shape), x / (1.0 - self.rate), zero)


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> GELU (tanh approximation, Flax's ``nn.gelu``)
    -> dropout -> fc2 -> dropout, both layers with Flax's default init,
    fc2's divided by ``fc2_init_div``; the dropouts (training, ``drop_rate``
    > 0) draw from ``generator``. Split over 'model' (``tp``, set by
    ``parallel/auto_shard.py``) the rank holds its share of the hidden
    units: the input enters through ``copy_to``, the hidden dropout's mask
    is the whole layer's draw cut to the share, and fc2's partial products
    are summed over 'model' before its bias."""

    tp = None  # (axes, size, index) once split over 'model'

    def __init__(self, dim_in: int, hidden: int, dim_out: int, fc2_init_div: float = 1.0,
                 drop_rate: float = 0.0):
        super().__init__()
        self.drop_rate = drop_rate
        self.fc1 = dense(dim_in, hidden, init=lecun_normal_init)
        self.fc2 = dense(hidden, dim_out, init=divided_init(lecun_normal_init, fc2_init_div))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        from advise_tpu_torch.parallel.collectives import copy_to, reduce_from

        drop = self.training and self.drop_rate > 0.0
        tp = self.tp
        x = F.gelu(self.fc1(x if tp is None else copy_to(x, tp[0])), approximate="tanh")
        if drop:
            x = dropout(x, self.drop_rate, generator, part=None if tp is None else tp[1:])
        if tp is None:
            x = self.fc2(x)
        else:
            x = reduce_from(F.linear(x, self.fc2.weight), tp[0]) + self.fc2.bias
        if drop:
            x = dropout(x, self.drop_rate, generator)
        return x


class TwoStreamFusion(nn.Module):
    """Fuse the two halves of a channel-concatenated stream: add / max / min /
    avg, or concat (the identity). The concat_linear modes are not ported
    yet."""

    def __init__(self, mode: str):
        super().__init__()
        if mode not in ("add", "max", "min", "avg", "concat"):
            raise NotImplementedError(f"TwoStreamFusion mode {mode} is not ported yet")
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "concat":
            return x
        a, b = torch.chunk(x, 2, dim=-1)
        if self.mode == "add":
            return a + b
        if self.mode == "max":
            return torch.maximum(a, b)
        if self.mode == "min":
            return torch.minimum(a, b)
        return (a + b) / 2.0


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every recorded weight from ``generator`` in module order; biases
    start at their ``bias_value`` (zero unless recorded), free parameters
    from their ``param_inits``, and norms at their own reset (ones, or zeros
    for a final BN under RESNET.ZERO_INIT_FINAL_BN)."""
    for m in model.modules():
        for name, param_init in getattr(m, "param_inits", {}).items():
            param_init(getattr(m, name), generator)
        init = getattr(m, "weight_init", None)
        if init is not None:
            init(m.weight, generator)
            if m.bias is not None:
                nn.init.constant_(m.bias, getattr(m, "bias_value", 0.0))
        elif hasattr(m, "reset_parameters") and not isinstance(m, (nn.Conv3d, nn.Linear)):
            m.reset_parameters()
    return model
