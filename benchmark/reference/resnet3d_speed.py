"""Plain float32 reference of the speed-pretext train step over a Slow-only
3D ResNet: the 'simple' augmentation, the model, the BCE loss, the backward
and SGD.

Frozen at commit 5ad1cbe from the measured package's
``models/resnet3d.py``, ``models/layers/{stem,resnet,heads,norm}.py``
(forward in training mode), ``engine/steps.py`` (``speed_task_loss``,
``make_task_train_step``), ``models/losses.py`` (``bce_logit``),
``solver/optimizer.py`` (SGDLars without LARS, with its weight-decay
groups), ``ops/fused_aug.py`` (``sample_simple_aug``,
``fused_simple_aug_plain``) and ``data/device_aug.py``
(``sample_crop_offsets``, ``uniform_from``). It imports none of them.
Parameter names are the program's, so that weights and readings pair up by
name.

Departures from the program:

- float32 with TF32 off (``common.fp32_math``); the program runs the model
  in bf16 under autocast, its batch statistics in float32;
- batch normalisation normalises as ``(x - mean) * rsqrt(var + eps) *
  scale + bias`` in float32, where the program folds it into one
  multiply-add in the input's type; running statistics are not kept;
- no activation checkpointing (the program recomputes each stage under
  TPU.REMAT), which changes no value;
- the fused augmentation kernel (K3) is its plain arithmetic here.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from reference.common import SGD, Precision, Tensors, leaf_norms

OPS = 4  # brightness, contrast, saturation, hue: the codes of the aug's order
LUMA = (0.299, 0.587, 0.114)


# ---- the 'simple' augmentation ---------------------------------------------

def uniform_from(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    lo_t = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def sample_aug(n: int, h: int, w: int, size: int, color, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The per-clip draws, in the program's order: crop tops, lefts, the
    three factors, whether the chain applies, the order of the ops."""
    p, b, c, s = (float(v) for v in color[:4])
    dev = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    out = {name: torch.randint(0, max(dim - size, 1), (n,), generator=generator, device=dev, dtype=torch.int32)
           for name, dim in (("tops", h), ("lefts", w))}
    out["bfac"] = uniform_from(rand(n), max(0.0, 1 - b), 1 + b)
    out["cfac"] = uniform_from(rand(n), max(0.0, 1 - c), 1 + c)
    out["sfac"] = uniform_from(rand(n), max(0.0, 1 - s), 1 + s)
    out["apply"] = (rand(n) < p).to(torch.int32)
    out["order"] = torch.argsort(rand(n, OPS), dim=1).to(torch.int32)
    return out


def _fma(a, b, c) -> torch.Tensor:
    a, b, c = (torch.as_tensor(v).double() for v in (a, b, c))
    return (a * b + c).float()


def apply_aug(clips_u8: torch.Tensor, p: Dict[str, torch.Tensor], size: int, mean, std) -> torch.Tensor:
    """Crop, colour chain and normalisation of uint8 clips [N, T, H, W, 3]
    into float32 [N, T, S, S, 3]."""
    dev = clips_u8.device
    n = clips_u8.shape[0]
    ar = torch.arange(size, device=dev)
    rows = p["tops"].long()[:, None] + ar
    cols = p["lefts"].long()[:, None] + ar
    idx = torch.arange(n, device=dev)[:, None, None]
    x = clips_u8[idx, :, rows[:, :, None], cols[:, None, :]].permute(0, 3, 1, 2, 4).float()
    k = torch.tensor(LUMA, dtype=torch.float32, device=dev)
    lum = torch.floor((x[..., 0] * k[0] + x[..., 1] * k[1]) + x[..., 2] * k[2])[..., None]
    mean_luma = torch.floor(_fma(x[..., 2], k[2], _fma(x[..., 0], k[0], x[..., 1] * k[1])))
    inv_area = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(size * size))
    cmean = torch.floor(torch.sum(mean_luma, dim=(2, 3)) * inv_area.to(dev) + 0.5)[:, :, None, None, None]
    bc = (-1, 1, 1, 1, 1)
    bf, cf, sf = (p[key].float().view(bc) for key in ("bfac", "cfac", "sfac"))
    chain = [
        lambda y: torch.clamp(torch.floor(_fma(y, bf, 0.5)), 0.0, 255.0),
        lambda y: torch.clamp(torch.floor(_fma(cf, y - cmean, cmean) + 0.5), 0.0, 255.0),
        lambda y: torch.clamp(torch.floor(_fma(sf, y - lum, lum) + 0.5), 0.0, 255.0),
        lambda y: y,
    ]
    y = x
    order = p["order"].long()
    for pos in range(OPS):
        for code, op in enumerate(chain):
            y = torch.where((order[:, pos] == code).view(bc), op(y), y)
    y = torch.where((p["apply"] > 0).view(bc), y, x)
    m = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=dev) * 255.0
    return (y - m) / s


# ---- the model ---------------------------------------------------------------

class BN(nn.Module):
    """Batch statistics over every dim but dim 1, biased variance."""

    def __init__(self, c: int, eps: float, prec: Precision):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps, self.prec = eps, prec

    def forward(self, x):
        xf = x.float()
        red = (0,) + tuple(range(2, x.ndim))
        mean = xf.mean(dim=red, keepdim=True)
        var = torch.square(xf).mean(dim=red, keepdim=True) - torch.square(mean)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return self.prec.affine(xf, mean, var, self.eps, self.weight, self.bias, shape)


class Conv(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1, padding=0, prec: Precision = None):
        super().__init__()
        kernel = (kernel,) * 3 if isinstance(kernel, int) else tuple(kernel)
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.stride, self.padding, self.prec = stride, padding, prec

    def forward(self, x):
        return self.prec.conv3d(x, self.weight, self.stride, self.padding)


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, inner, tk, stride, eps, prec):
        super().__init__()
        self.a = Conv(cin, inner, (tk, 1, 1), 1, (tk // 2, 0, 0), prec)
        self.a_bn = BN(inner, eps, prec)
        self.b = Conv(inner, inner, (1, 3, 3), (1, stride, stride), (0, 1, 1), prec)
        self.b_bn = BN(inner, eps, prec)
        self.c = Conv(inner, cout, 1, 1, 0, prec)
        self.c_bn = BN(cout, eps, prec)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class Block(nn.Module):
    def __init__(self, cin, cout, inner, tk, stride, eps, prec):
        super().__init__()
        self.branch1 = None
        if cin != cout or stride != 1:
            self.branch1 = Conv(cin, cout, 1, (1, stride, stride), 0, prec)
            self.branch1_bn = BN(cout, eps, prec)
        self.branch2 = Bottleneck(cin, cout, inner, tk, stride, eps, prec)

    def forward(self, x):
        short = x if self.branch1 is None else self.branch1_bn(self.branch1(x))
        return F.relu(short + self.branch2(x))


class Stage(nn.Module):
    def __init__(self, cin, cout, inner, tks, stride, eps, prec):
        super().__init__()
        self.n = len(tks)
        for i, tk in enumerate(tks):
            self.add_module(f"pathway0_res{i}", Block(cin if i == 0 else cout, cout, inner, tk,
                                                      stride if i == 0 else 1, eps, prec))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"pathway0_res{i}")(x)
        return x


class Linear(nn.Module):
    def __init__(self, cin, cout, bias, prec):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.prec = prec

    def forward(self, x):
        return self.prec.linear(x, self.weight, self.bias)


class Projection(nn.Module):
    """[Linear (no bias) -> BN -> ReLU] x (n - 1) -> Linear."""

    def __init__(self, cin, cout, hidden, layers, eps, prec):
        super().__init__()
        self.layers = layers
        dim = cin
        for i in range(layers - 1):
            self.add_module(f"fc{i}", Linear(dim, hidden, False, prec))
            self.add_module(f"bn{i}", BN(hidden, eps, prec))
            dim = hidden
        self.add_module(f"fc{layers - 1}", Linear(dim, cout, True, prec))

    def forward(self, x):
        for i in range(self.layers - 1):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
        return getattr(self, f"fc{self.layers - 1}")(x)


class Head(nn.Module):
    def __init__(self, spec, prec):
        super().__init__()
        self.projection = Projection(spec["width"] * 32, spec["num_classes"], spec["mlp_dim"],
                                     spec["mlp_layers"], spec["bn_eps"], prec)


class SlowResNet(nn.Module):
    """Stem, four bottleneck stages, global mean, dropout, MLP head."""

    def __init__(self, spec: dict, prec: Precision):
        super().__init__()
        width, eps = spec["width"], spec["bn_eps"]
        tk = spec["temporal_kernels"]
        stem = nn.Module()
        stem.conv = Conv(3, width, (tk[0], 7, 7), (1, 2, 2), (tk[0] // 2, 3, 3), prec)
        stem.bn = BN(width, eps, prec)
        self.s1 = stem
        for si in range(4):
            n = spec["stage_blocks"][si]
            with_tk = spec["num_block_temp_kernel"][si]
            tks = [tk[si + 1]] * with_tk + [1] * (n - with_tk)
            self.add_module(f"s{si + 2}", Stage(
                width if si == 0 else width * 4 * 2 ** (si - 1), width * 4 * 2 ** si, width * 2 ** si,
                tks, spec["spatial_strides"][si], eps, prec))
        self.head = Head(spec, prec)
        self.dropout = spec["dropout"]
        self.prec = prec

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """x [N, T, H, W, 3] float32 -> logits [N, classes]; ``generator``
        draws the head's dropout mask (none when None)."""
        x = x.permute(0, 4, 1, 2, 3)
        x = F.relu(self.s1.bn(self.s1.conv(x)))
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for si in range(4):
            x = getattr(self, f"s{si + 2}")(x)
        x = x.mean(dim=(2, 3, 4))
        if generator is not None and self.dropout > 0:
            keep = 1.0 - self.dropout
            mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
            x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
        return self.head.projection(x)


def bce_logit(logits: torch.Tensor, labels: torch.Tensor, classes: int) -> torch.Tensor:
    t = F.one_hot(labels.long(), classes).float()
    x = logits.float()
    return (torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))).mean()


# ---- the step ----------------------------------------------------------------

def build_model(spec: dict, device, precision: str = "fp32") -> SlowResNet:
    with torch.device(device):
        return SlowResNet(spec, Precision(precision))


def weight_decays(spec: dict) -> Dict[str, float]:
    """{name: weight decay} by the program's groups: a BN parameter takes the
    BN weight decay, a 1-D one none under ``zero_wd_1d``, every other the
    solver's."""
    return _weight_decays(build_model(spec, "meta"), spec["solver"])


def _weight_decays(model: nn.Module, solver: dict) -> Dict[str, float]:
    bn = {f"{mn}.{pn}" if mn else pn for mn, m in model.named_modules() if isinstance(m, BN)
          for pn, _ in m.named_parameters(recurse=False)}
    out = {}
    for name, p in model.named_parameters():
        if name in bn:
            out[name] = solver["bn_weight_decay"]
        elif p.ndim <= 1 and solver["zero_wd_1d"]:
            out[name] = 0.0
        else:
            out[name] = solver["weight_decay"]
    return out


def param_shapes(spec: dict) -> Dict[str, tuple]:
    model = build_model(spec, "meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def run_steps(spec: dict, weights: Tensors, batches: List, step_seeds: List[int], lr: float, device,
              precision: str = "fp32", half: bool = False) -> dict:
    """The train step ``len(batches)`` times from ``weights``: each batch
    (uint8 clips [B, K, T, H, W, 3], infos with ``spd_label`` [B, K]) goes
    through the aug drawn from a generator seeded with that step's seed, the
    model (its dropout drawn next from the same generator), the loss, the
    backward and SGD. ``half`` keeps only the first half of each batch's
    videos (a fault planted for calibration). Returns each step's loss, the
    first gradient as the optimizer receives it (``g1``) and each leaf's
    norm of it, and the norm of each parameter's change over the steps."""
    model = build_model(spec, device, precision)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    start = {n: p.detach().clone() for n, p in params.items()}
    sol = spec["solver"]
    opt = SGD(_weight_decays(model, sol), sol["momentum"], sol["nesterov"], sol["clip_grad_norm"])
    state = opt.init(params)
    aug = spec["aug"]
    losses, grad1 = [], None
    gen = torch.Generator(device=device)
    for clips_u8, infos, seed in zip((b[0] for b in batches), (b[1] for b in batches), step_seeds):
        labels = infos["spd_label"]
        if half:
            keep = clips_u8.shape[0] // 2
            clips_u8, labels = clips_u8[:keep], labels[:keep]
        gen.manual_seed(seed)
        b, k, t, h, w, c = clips_u8.shape
        drawn = sample_aug(b * k, h, w, aug["crop"], aug["color"], gen)
        clips = apply_aug(clips_u8.reshape(b * k, t, h, w, c), drawn, aug["crop"], aug["mean"], aug["std"])
        with model.prec.autocast(device):
            logits = model(clips, gen)
            loss = bce_logit(logits, labels.reshape(b * k), spec["num_classes"])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if grad1 is None:
            g1 = {n: g.detach() for n, g in opt.received(grads).items()}
            grad1 = leaf_norms(g1)
        state = opt.step(params, grads, state, lr)
        losses.append(float(loss.detach()))
    change = leaf_norms({n: params[n].detach() - start[n] for n in params})
    return {"losses": losses, "grad1": grad1, "change": change, "g1": g1}


def flops_per_step(spec: dict, traffic: dict) -> int:
    """Model FLOPs of one step, forward and backward with nothing
    recomputed, counted by ``torch.utils.flop_counter`` over this
    reference on the meta device at the traffic's shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    model = build_model(spec, "meta")
    n = traffic["videos_per_step"] * traffic["clips_per_video"]
    crop = spec["aug"]["crop"]
    x = torch.empty(n, traffic["frames"], crop, crop, 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        logits = model(x, None)
        loss = logits.float().square().mean()
        torch.autograd.grad(loss, list(model.parameters()))
    return int(counter.get_total_flops())
