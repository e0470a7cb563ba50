"""Plain float32 reference of the MaskFeat train step over MViTv2: the
OnlyCrop augmentation, the model with its masked tokens, the HOG targets,
the masked MSE, the backward and AdamW with its clip.

Written from the papers (MViTv2: Li et al., CVPR 2022, arXiv:2112.01526;
MaskFeat: Wei et al., CVPR 2022, arXiv:2112.09133) and from the measured
package's settings at commit b01a037 (``configs/pretrain/
MaskFeat_MViTv2_L_16x224.yaml``, ``models/{mvit,masked}.py``,
``models/layers/{attention,common,operators}.py``, ``engine/steps.py
masked_task_loss``, ``solver/optimizer.py`` Adam with ``decoupled``,
``data/device_aug.py RRCAug``); it imports none of them. Parameter names
are the program's, so that weights and readings pair up by name.

A block (MViTv2, sec. 3 and 4): LayerNorm; the attention, whose q, k and v
each pass a depthwise 3x3x3 convolution (q at the block's Q stride, k and
v at its KV stride) and a LayerNorm over the head's channels, the cls
token bypassing the convolution; scores ``(q k^T) / sqrt(d)`` plus the
decomposed relative position term ``q_i . (R^t[t(i), t(j)] + R^h[h(i),
h(j)] + R^w[w(i), w(j)])`` (eq. 4; the offsets of q and k scaled to the
finer grid of the two, and the cls token's row and column left out),
softmax, ``@ v``, then the residual pooling ``+ q`` (eq. 5, not on the cls
row), the output projection; the skip, projected from the normalised input
where the block widens (``DIM_MUL_IN_ATT``) and max-pooled at kernel s + 1
where Q pools, plus the attention behind drop path; LayerNorm, the MLP
(GELU) behind drop path. MaskFeat (sec. 3): masked tokens replaced by a
learned mask token before the cls token joins; at the last block a
LayerNorm and a linear layer predict each token's HOG (9 orientation bins
in 8 x 8 cells, the token's cells concatenated); the loss is the MSE over
the masked tokens.

Departures, from the papers or from the program:

- float32 with TF32 off (``common.fp32_math``); the program computes in
  bf16 under autocast (its attention scores and softmax in float32) and
  feeds the model, and the HOG, with clips cast to bf16;
- no activation checkpointing (the program recomputes each block under
  TPU.REMAT), which changes no value; the batch may run in chunks of
  ``chunk`` videos, each chunk's loss the whole batch's masked sum over its
  tokens divided by the whole batch's count of masked tokens, so that the
  summed gradients are those of the whole batch's loss;
- GELU is the tanh approximation (the program's, as Flax's ``nn.gelu``);
  LayerNorm's epsilon 1e-6;
- the relative position tables are used at the length they are built with
  (``2 * max(q, k) - 1`` rows); the program would resize a table whose
  length differs, which no block of this model has;
- the HOG, as the program computes it: the frame edge-padded by one pixel
  (PySlowFast pads by reflection), Sobel gradients, phase ``atan2(gx, gy)``
  in [0, pi) scaled to the bins, each pixel's magnitude weighted by a
  16 x 16 Gaussian window (sigma 8) tiled over the frame and voted into the
  bin under the floor of its phase, and each cell's histogram L2-normalised
  over its channels and bins together (PySlowFast normalises each
  channel's);
- the drop-path keep masks come from the step's generator, after the
  crop's draws, in the program's order: for each block (the attention's,
  then the MLP's) where the rate is above 0; a kept branch is divided by
  1 - rate;
- AdamW in the program's form: the clip by global norm first, then Adam
  (bias-corrected moments, eps 1e-8 outside the square root), then
  ``+ wd * p``, the lr last; weight decay by the program's groups (1-D
  parameters none under ``zero_wd_1d``).

``leave_out`` (in the reference spec; empty for the benchmark) names the
mechanisms a calibration run leaves out of the forward, the faults of
PERF.md's calibration: ``rel_pos`` (the tables are kept, their terms not
added) and ``residual_pooling``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reference.common import Precision, Tensors, global_norm, leaf_norms

Thw = Tuple[int, int, int]


# ---- the schedule ------------------------------------------------------------

def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def patch_grid(spec: dict) -> Thw:
    p = spec["patch"]
    size = (spec["frames"], spec["crop"], spec["crop"])
    return tuple(conv_out(n, k, s, q) for n, k, s, q in zip(size, p["kernel"], p["stride"], p["padding"]))


def blocks(spec: dict) -> List[dict]:
    """Each block's widths, heads, grids and strides: width and heads double
    at each of ``stages`` (where Q pools by ``q_stride``), so the head dim
    stays that of the embedding; K and V pool by ``kv_stride`` divided by
    every Q stride met so far."""
    dim, heads = spec["embed_dim"], spec["num_heads"]
    kernel = tuple(spec["pool_kernel"])
    kv = list(spec["kv_stride"])
    thw = patch_grid(spec)
    out = []
    for i in range(spec["depth"]):
        transition = i in spec["stages"]
        q_stride = tuple(spec["q_stride"]) if transition else (1, 1, 1)
        if transition:
            kv = [max(a // b, 1) for a, b in zip(kv, q_stride)]
        dim_out, heads = (2 * dim, 2 * heads) if transition else (dim, heads)
        q_thw = tuple(conv_out(n, k, s, k // 2) for n, k, s in zip(thw, kernel, q_stride))
        k_thw = tuple(conv_out(n, k, s, k // 2) for n, k, s in zip(thw, kernel, kv))
        out.append(dict(dim=dim, dim_out=dim_out, heads=heads, thw=thw, q_thw=q_thw, k_thw=k_thw,
                        q_stride=q_stride, kv_stride=tuple(kv), rel_sp=2 * max(thw[1] // q_stride[1],
                                                                                 thw[1] // kv[1]) - 1))
        dim, thw = dim_out, q_thw
    return out


def attention_shapes(spec: dict, clips: int) -> List[dict]:
    """The attention cores of one forward pass over ``clips`` clips: batch,
    heads, head dim, q's and k's (t, h, w) grids and whether a cls token
    rides along (the roofline's geometry)."""
    return [dict(b=clips, heads=blk["heads"], d=blk["dim_out"] // blk["heads"], q_thw=blk["q_thw"],
                 k_thw=blk["k_thw"], cls=bool(spec["cls_token"])) for blk in blocks(spec)]


# ---- the augmentation ----------------------------------------------------------

def crop_boxes(n: int, h: int, w: int, scale, ratio, gen: torch.Generator, attempts: int = 10) -> torch.Tensor:
    """RandomResizedCrop's boxes [n, 4] (top, left, height, width): of
    ``attempts`` candidates, each of an area share uniform in ``scale`` and a
    log-uniform aspect ratio in ``ratio``, the first that fits, else the
    whole frame cut to the ratio's range. The four uniforms [n, attempts]
    come from ``gen`` in the order area, ratio, top, left."""
    dev = gen.device
    u = [torch.rand((n, attempts), generator=gen, device=dev) for _ in range(4)]

    def between(x, lo, hi):
        lo_t, hi_t = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (lo, hi))
        return torch.maximum(lo_t, x * (hi_t - lo_t) + lo_t)

    area = h * w * between(u[0], scale[0], scale[1])
    logr = torch.log(torch.tensor(ratio, dtype=torch.float32))
    aspect = torch.exp(between(u[1], logr[0], logr[1]))
    cw = torch.round(torch.sqrt(area * aspect))
    ch = torch.round(torch.sqrt(area / aspect))
    fits = (cw <= w) & (ch <= h)
    top = torch.floor(u[2] * (h - ch + 1))
    left = torch.floor(u[3] * (w - cw + 1))
    first = torch.argmax(fits.to(torch.int8), dim=1, keepdim=True)
    chosen = torch.stack([v.gather(1, first)[:, 0] for v in (top, left, ch, cw)], dim=1)
    if w / h < ratio[0]:
        fw, fh = w, round(w / ratio[0])
    elif w / h > ratio[1]:
        fw, fh = round(h * ratio[1]), h
    else:
        fw, fh = w, h
    whole = torch.tensor([round((h - fh) / 2.0), round((w - fw) / 2.0), fh, fw], dtype=torch.float32, device=dev)
    return torch.where(fits.any(dim=1)[:, None], chosen, whole)


def linear_resize_matrix(n_in: int, n_out: int, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """[N, n_in, n_out]: output pixel x samples the input at (x + 0.5 -
    shift) / scale - 0.5 with the triangle kernel, widened by 1 / scale when
    it shrinks (antialiased), each column normalised to sum 1, and 0 where
    the sample falls outside the input (``jax.image.scale_and_translate``,
    'linear')."""
    dev = scale.device
    pos = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)[None, :] / scale[:, None]
           - (shift / scale)[:, None] - 0.5)
    width = torch.clamp(1.0 / scale, min=1.0)
    dist = torch.abs(pos[:, None, :] - torch.arange(n_in, dtype=torch.float32, device=dev)[None, :, None])
    wts = torch.clamp(1.0 - dist / width[:, None, None], min=0.0)
    total = wts.sum(dim=1, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                      wts / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(wts))
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return torch.where(inside[:, None, :], wts, torch.zeros_like(wts))


def only_crop(clips_u8: torch.Tensor, aug: dict, gen: torch.Generator) -> torch.Tensor:
    """uint8 clips [N, T, H, W, 3] -> float32 [N, T, S, S, 3]: each clip's
    box resized to S x S, clipped to [0, 255], normalised as
    ``(x - mean) * (1 / std)``."""
    n, _, h, w, _ = clips_u8.shape
    size = aug["crop"]
    box = crop_boxes(n, h, w, (aug["min_area"], 1.0), aug["ratio"], gen)
    top, left, bh, bw = (box[:, i] for i in range(4))
    rows = linear_resize_matrix(h, size, size / bh, -top * size / bh)
    cols = linear_resize_matrix(w, size, size / bw, -left * size / bw)
    x = torch.einsum("nthwc,nhy->ntywc", clips_u8.float(), rows)
    x = torch.clamp(torch.einsum("ntywc,nwx->ntyxc", x, cols), 0.0, 255.0)
    mean = torch.tensor(aug["mean"], dtype=torch.float32, device=x.device) * 255.0
    std = torch.tensor(aug["std"], dtype=torch.float32, device=x.device) * 255.0
    return (x - mean) * (1.0 / std)


# ---- HOG -----------------------------------------------------------------------

def hog(frames: torch.Tensor, nbins: int, cell: int, window: int) -> torch.Tensor:
    """frames [N, H, W, C] -> [N, H / cell, W / cell, C * nbins] (see the
    module's departures)."""
    n, h, w, c = frames.shape
    r = torch.arange(-1, h + 1, device=frames.device).clamp(0, h - 1)
    s = torch.arange(-1, w + 1, device=frames.device).clamp(0, w - 1)
    x = frames[:, r][:, :, s]
    dx = x[:, :, 2:] - x[:, :, :-2]  # [N, H + 2, W, C]
    dy = x[:, 2:] - x[:, :-2]  # [N, H, W + 2, C]
    gx = dx[:, :-2] + 2.0 * dx[:, 1:-1] + dx[:, 2:]
    gy = dy[:, :, :-2] + 2.0 * dy[:, :, 1:-1] + dy[:, :, 2:]
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    phase = torch.atan2(gx, gy) / math.pi * nbins
    phase = torch.where(phase < 0, phase + nbins, phase)
    ax = torch.arange(window, dtype=torch.float32, device=frames.device) - (window - 1) / 2.0
    g = torch.exp(-0.5 * (ax / (window // 2)) ** 2)
    g2 = torch.outer(g, g)
    g2 = (g2 / g2.max()).repeat(-(-h // window), -(-w // window))[:h, :w]
    mag = mag * g2[None, :, :, None]
    bins = torch.clamp(torch.floor(phase), 0, nbins - 1)
    votes = (bins[..., None] == torch.arange(nbins, device=frames.device, dtype=bins.dtype)).float() * mag[..., None]
    hist = votes.reshape(n, h // cell, cell, w // cell, cell, c, nbins).sum(dim=(2, 4))
    hist = hist.reshape(n, h // cell, w // cell, c * nbins)
    return hist / (torch.linalg.vector_norm(hist, dim=-1, keepdim=True) + 1e-12)


def hog_targets(clips: torch.Tensor, spec: dict, out_thw: Thw, stride_px: int) -> torch.Tensor:
    """The HOG of every token of the last block's grid: clips [N, T, S, S, 3]
    at the patch's temporal stride -> [N, t * h * w, (stride / cell)^2 * 3 *
    nbins], each token's cells row by row."""
    hp = spec["hog"]
    n = clips.shape[0]
    t, hh, ww = out_thw
    frames = clips[:, ::spec["patch"]["stride"][0]][:, :t]
    if hh * stride_px != clips.shape[2]:
        raise ValueError("the last grid's tokens must tile the crop")
    feat = hog(frames.reshape(n * t, *frames.shape[2:]), hp["nbins"], hp["cell"], hp["window"])
    per = stride_px // hp["cell"]
    feat = feat.reshape(n * t, hh, per, ww, per, -1).permute(0, 1, 3, 2, 4, 5)
    return feat.reshape(n, t * hh * ww, -1)


# ---- the model -----------------------------------------------------------------

class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, prec: Precision):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.prec = prec

    def forward(self, x):
        return self.prec.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mean).mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class DepthwiseConv(nn.Module):
    def __init__(self, c: int, kernel, stride, prec: Precision):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, 1, *kernel))
        self.stride, self.padding = tuple(stride), tuple(k // 2 for k in kernel)
        self.prec = prec

    def forward(self, x):
        return self.prec.conv3d(x, self.weight, self.stride, self.padding, groups=x.shape[1])


def rel_index(q_n: int, k_n: int, device) -> torch.Tensor:
    """[q_n, k_n] rows of a table of 2 * max(q_n, k_n) - 1: query i's offset
    from key j, both scaled to the finer of the two grids."""
    qr, kr = max(k_n / q_n, 1.0), max(q_n / k_n, 1.0)
    i = torch.arange(q_n, dtype=torch.float64)[:, None] * qr
    j = torch.arange(k_n, dtype=torch.float64)[None, :] * kr
    return (i - j + (k_n - 1) * kr).long().to(device)


class Attention(nn.Module):
    def __init__(self, blk: dict, spec: dict, prec: Precision):
        super().__init__()
        dout, self.heads = blk["dim_out"], blk["heads"]
        self.hd = dout // self.heads
        self.blk, self.prec = blk, prec
        self.cls = bool(spec["cls_token"])
        self.leave_out = set(spec.get("leave_out", ()))
        self.residual_pooling = bool(spec["residual_pooling"])
        self.rel_sp, self.rel_t = bool(spec["rel_pos_spatial"]), bool(spec["rel_pos_temporal"])
        self.qkv = Linear(blk["dim"], 3 * dout, prec)
        kernel = tuple(spec["pool_kernel"])
        for name, stride in (("q", blk["q_stride"]), ("k", blk["kv_stride"]), ("v", blk["kv_stride"])):
            self.add_module(f"pool_{name}", DepthwiseConv(self.hd, kernel, stride, prec))
            self.add_module(f"norm_{name}", LayerNorm(self.hd, spec["ln_eps"]))
        self.proj = Linear(dout, dout, prec)
        if self.rel_sp:
            self.rel_pos_h = nn.Parameter(torch.zeros(blk["rel_sp"], self.hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(blk["rel_sp"], self.hd))
        if self.rel_t:
            self.rel_pos_t = nn.Parameter(torch.zeros(2 * blk["thw"][0] - 1, self.hd))

    def pool(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """[B, heads, 1 + L, d] -> pooled, the cls token passed by, then the
        LayerNorm over d."""
        b, h, _, d = x.shape
        sp = 1 if self.cls else 0
        t, hh, ww = self.blk["thw"]
        grid = x[:, :, sp:].reshape(b * h, t, hh, ww, d).permute(0, 4, 1, 2, 3)
        grid = getattr(self, f"pool_{name}")(grid)
        y = grid.permute(0, 2, 3, 4, 1).reshape(b, h, -1, d)
        if sp:
            y = torch.cat([x[:, :, :1], y], dim=2)
        return getattr(self, f"norm_{name}")(y)

    def rel_pos(self, q: torch.Tensor) -> torch.Tensor:
        """The decomposed relative position term [B, heads, Nq, Nk] of the
        non-cls queries and keys (MViTv2 eq. 4)."""
        b, h, _, d = q.shape
        sp = 1 if self.cls else 0
        (qt, qh, qw), (kt, kh, kw) = self.blk["q_thw"], self.blk["k_thw"]
        r = q[:, :, sp:].reshape(b, h, qt, qh, qw, d)
        zero = q.new_zeros(())
        terms = [zero, zero, zero]
        for axis, (name, qn, kn, on) in enumerate((("t", qt, kt, self.rel_t), ("h", qh, kh, self.rel_sp),
                                                   ("w", qw, kw, self.rel_sp))):
            if not on:
                continue
            table = getattr(self, f"rel_pos_{name}")
            if table.shape[0] != 2 * max(qn, kn) - 1:
                raise ValueError(f"rel_pos_{name}: {table.shape[0]} rows for grids {qn} and {kn}")
            rows = table[rel_index(qn, kn, q.device)]  # [qn, kn, d]
            eq = {"t": "bhtyxd,tkd->bhtyxk", "h": "bhtyxd,ykd->bhtyxk", "w": "bhtyxd,xkd->bhtyxk"}[name]
            terms[axis] = torch.einsum(eq, r, rows)
        bias = (terms[0][..., :, None, None] if self.rel_t else 0) \
            + (terms[1][..., None, :, None] if self.rel_sp else 0) \
            + (terms[2][..., None, None, :] if self.rel_sp else 0)
        bias = torch.broadcast_to(bias, (b, h, qt, qh, qw, kt, kh, kw))
        return bias.reshape(b, h, qt * qh * qw, kt * kh * kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, self.hd).permute(2, 0, 3, 1, 4).unbind(0)
        q, k, v = self.pool(q, "q"), self.pool(k, "k"), self.pool(v, "v")
        scores = (q * self.hd ** -0.5) @ k.transpose(-1, -2)
        if (self.rel_sp or self.rel_t) and "rel_pos" not in self.leave_out:
            sp = 1 if self.cls else 0
            scores = scores + F.pad(self.rel_pos(q), (sp, 0, sp, 0))
        out = torch.softmax(scores, dim=-1) @ v
        if self.residual_pooling and "residual_pooling" not in self.leave_out:
            sp = 1 if self.cls else 0
            out = torch.cat([out[:, :, :sp], out[:, :, sp:] + q[:, :, sp:]], dim=2)
        return self.proj(out.transpose(1, 2).reshape(b, out.shape[2], -1))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, prec: Precision):
        super().__init__()
        self.fc1 = Linear(dim, hidden, prec)
        self.fc2 = Linear(hidden, dim, prec)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def drop_path(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    if keep is None:
        return x
    return torch.where(keep.view((-1,) + (1,) * (x.ndim - 1)), x / (1.0 - rate), x.new_zeros(()))


class Block(nn.Module):
    def __init__(self, blk: dict, spec: dict, rate: float, prec: Precision):
        super().__init__()
        self.blk, self.rate, self.cls = blk, rate, bool(spec["cls_token"])
        dim, dout = blk["dim"], blk["dim_out"]
        self.norm1 = LayerNorm(dim, spec["ln_eps"])
        self.attn = Attention(blk, spec, prec)
        if dim != dout:
            self.proj = Linear(dim, dout, prec)
        self.norm2 = LayerNorm(dout, spec["ln_eps"])
        self.mlp = Mlp(dout, int(dout * spec["mlp_ratio"]), prec)

    def skip(self, x: torch.Tensor) -> torch.Tensor:
        """The skip max-pooled at kernel s + 1 where Q pools, the cls token
        passed by."""
        stride = self.blk["q_stride"]
        if math.prod(stride) == 1:
            return x
        sp = 1 if self.cls else 0
        b, _, c = x.shape
        t, hh, ww = self.blk["thw"]
        kernel = tuple(s + 1 if s > 1 else s for s in stride)
        grid = x[:, sp:].reshape(b, t, hh, ww, c).permute(0, 4, 1, 2, 3)
        grid = F.max_pool3d(grid, kernel, stride, tuple(k // 2 for k in kernel))
        y = grid.permute(0, 2, 3, 4, 1).reshape(b, -1, c)
        return torch.cat([x[:, :sp], y], dim=1) if sp else y

    def forward(self, x: torch.Tensor, keeps) -> torch.Tensor:
        xn = self.norm1(x)
        a = self.attn(xn)
        x = self.skip(self.proj(xn) if hasattr(self, "proj") else x)
        x = x + drop_path(a, keeps[0], self.rate)
        return x + drop_path(self.mlp(self.norm2(x)), keeps[1], self.rate)


class PatchEmbed(nn.Module):
    def __init__(self, spec: dict, prec: Precision):
        super().__init__()
        p = spec["patch"]
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(torch.empty(spec["embed_dim"], 3, *p["kernel"]))
        self.proj.bias = nn.Parameter(torch.zeros(spec["embed_dim"]))
        self.stride, self.padding, self.prec = tuple(p["stride"]), tuple(p["padding"]), prec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.prec.conv3d(x.permute(0, 4, 1, 2, 3), self.proj.weight, self.stride, self.padding,
                             bias=self.proj.bias)
        return y.flatten(2).transpose(1, 2)


class Encoder(nn.Module):
    def __init__(self, spec: dict, prec: Precision):
        super().__init__()
        self.spec, self.schedule = spec, blocks(spec)
        if spec["cls_token"]:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, spec["embed_dim"]))
        self.patch_embed = PatchEmbed(spec, prec)
        self.rates = [spec["drop_path"] * i / (spec["depth"] - 1) for i in range(spec["depth"])]
        for i, blk in enumerate(self.schedule):
            self.add_module(f"blocks_{i}", Block(blk, spec, self.rates[i], prec))


class MaskFeat(nn.Module):
    """mask_token, the MViTv2 encoder, the HOG prediction head at the last
    block."""

    def __init__(self, spec: dict, prec: Precision):
        super().__init__()
        self.spec, self.prec = spec, prec
        self.mask_token = nn.Parameter(torch.zeros(1, 1, spec["embed_dim"]))
        self.encoder = Encoder(spec, prec)
        last = self.encoder.schedule[-1]
        self.stride_px = spec["crop"] // last["q_thw"][1]
        per = self.stride_px // spec["hog"]["cell"]
        head = nn.Module()
        head.norm = LayerNorm(last["dim_out"], spec["ln_eps"])
        head.projection = Linear(last["dim_out"], 3 * spec["hog"]["nbins"] * per * per, prec)
        self.add_module(f"pred_head_{spec['depth'] - 1}", head)

    def draw_keeps(self, b: int, gen: Optional[torch.Generator]) -> List[tuple]:
        """Each block's (attention, MLP) keep masks [b], in block order, None
        where the rate is 0 (no draw)."""
        out = []
        for rate in self.encoder.rates:
            pair = []
            for _ in range(2):
                pair.append(None if gen is None or rate <= 0 else
                            torch.rand(b, generator=gen, device=gen.device) < (1.0 - rate))
            out.append(tuple(pair))
        return out

    def forward(self, clips: torch.Tensor, mask: torch.Tensor, keeps) -> torch.Tensor:
        """clips [N, T, S, S, 3], mask [N, t, h, w] on the patch grid (1 =
        masked) -> the HOG predictions [N, tokens of the last grid, out]."""
        enc = self.encoder
        x = enc.patch_embed(clips)
        x = torch.where(mask.reshape(x.shape[0], -1, 1) > 0, self.mask_token.to(x.dtype), x)
        if self.spec["cls_token"]:
            x = torch.cat([enc.cls_token.expand(x.shape[0], -1, -1).to(x.dtype), x], dim=1)
        for i in range(len(enc.schedule)):
            x = getattr(enc, f"blocks_{i}")(x, keeps[i])
        if self.spec["cls_token"]:
            x = x[:, 1:]
        head = getattr(self, f"pred_head_{self.spec['depth'] - 1}")
        return head.projection(head.norm(x))


def token_mask(mask: torch.Tensor, out_thw: Thw) -> torch.Tensor:
    """The patch grid's mask [N, t, h, w] on the last grid: a token is masked
    where any of the patches it covers is (the grids tile)."""
    n, t, h, w = mask.shape
    ot, oh, ow = out_thw
    if t % ot or h % oh or w % ow:
        raise ValueError("the last grid must tile the patch grid")
    m = mask.float().reshape(n, ot, t // ot, oh, h // oh, ow, w // ow)
    return m.amax(dim=(2, 4, 6)).reshape(n, -1)


def masked_mse_sum(pred: torch.Tensor, label: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.mean(torch.square(pred - label), dim=-1) * mask)


# ---- the step ------------------------------------------------------------------

def build_model(spec: dict, device, precision: str = "fp32") -> MaskFeat:
    """The model of ``spec``; raises for a form this file does not write: a
    widening skip taken before the norm, q, k and v without biases, absolute
    position embeddings, or a prediction depth other than the last block."""
    if not spec["dim_mul_in_att"] or not spec["qkv_bias"] or spec["abs_pos"] or (
            spec["pretrain_depth"] != spec["depth"] - 1):
        raise ValueError("reference/mvitv2_maskfeat.py writes DIM_MUL_IN_ATT, QKV_BIAS, no absolute position "
                         "embedding and the prediction at the last block only")
    with torch.device(device):
        return MaskFeat(spec, Precision(precision))


def param_shapes(spec: dict) -> Dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in build_model(spec, "meta").named_parameters()}


def weight_decays(spec: dict) -> Dict[str, float]:
    """{name: weight decay}: none for 1-D parameters under ``zero_wd_1d``,
    none for the position, cls and mask tokens under ``zero_decay_pos_cls``,
    the solver's for every other."""
    sol = spec["solver"]
    out = {}
    for name, shape in param_shapes(spec).items():
        tokens = any(k in name for k in ("pos_embed", "cls_token", "rel_pos", "mask_token"))
        if sol["zero_decay_pos_cls"] and tokens:
            out[name] = 0.0
        elif len(shape) <= 1 and sol["zero_wd_1d"]:
            out[name] = 0.0
        else:
            out[name] = sol["weight_decay"]
    return out


class AdamW:
    """The clip by global norm, Adam, ``+ wd * p``; the step subtracts ``lr``
    times that direction."""

    def __init__(self, wds: Dict[str, float], betas, eps: float, clip_norm: float):
        self.wds, (self.b1, self.b2), self.eps, self.clip_norm = wds, betas, eps, clip_norm

    def init(self, params: Tensors):
        return {"mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}, "count": 0}

    def received(self, grads: Tensors) -> Tensors:
        norm = global_norm(grads.values())
        if self.clip_norm <= 0:
            return dict(grads)
        return {n: torch.where(norm < self.clip_norm, g, g / norm * self.clip_norm) for n, g in grads.items()}

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state, lr: float):
        g = self.received(grads)
        count = state["count"] + 1
        mu = {n: (1 - self.b1) * v + self.b1 * state["mu"][n] for n, v in g.items()}
        nu = {n: (1 - self.b2) * v * v + self.b2 * state["nu"][n] for n, v in g.items()}
        c1, c2 = 1 - self.b1 ** count, 1 - self.b2 ** count
        for n, p in params.items():
            p.sub_(lr * ((mu[n] / c1) / (torch.sqrt(nu[n] / c2) + self.eps) + self.wds[n] * p))
        return {"mu": mu, "nu": nu, "count": count}


def _loss_grads(model: MaskFeat, params: Tensors, clips: torch.Tensor, mask: torch.Tensor, keeps, chunk: int,
                device):
    """The whole batch's masked MSE and its gradients, chunk by chunk."""
    spec = model.spec
    last = model.encoder.schedule[-1]["q_thw"]
    n = clips.shape[0]
    with torch.no_grad():
        labels = hog_targets(clips, spec, last, model.stride_px)
        tokens = token_mask(mask, last)
        count = torch.clamp(tokens.sum(), min=1.0)
    total = torch.zeros((), device=device)
    grads = {name: torch.zeros_like(p) for name, p in params.items()}
    step = chunk if chunk > 0 else n
    for a in range(0, n, step):
        part = slice(a, min(a + step, n))
        ks = [tuple(None if k is None else k[part] for k in pair) for pair in keeps]
        with model.prec.autocast(device):
            pred = model(clips[part], mask[part], ks)
        loss = masked_mse_sum(pred.float(), labels[part], tokens[part]) / count
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        for name, g in zip(params, got):
            if g is not None:
                grads[name] += g
        total = total + loss.detach()
    return total, grads


def run_steps(spec: dict, weights: Tensors, batches: List, step_seeds: List[int], lr: float, device,
              precision: str = "fp32", half: bool = False) -> dict:
    """The train step ``len(batches)`` times from ``weights``: each batch
    (uint8 clips [B, 1, T, H, W, 3], infos with ``mask`` [B, 1, t, h, w])
    goes through the crop drawn from a generator seeded with that step's
    seed, the drop-path keep masks drawn next from it, the model, the loss,
    the backward and AdamW. ``half`` keeps only the first half of each
    batch's videos (a fault planted for calibration). Returns each step's
    loss, the first gradient as the optimizer receives it (``g1``) and each
    leaf's norm of it, and the norm of each parameter's change over the
    steps."""
    model = build_model(spec, device, precision)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    start = {n: p.detach().clone() for n, p in params.items()}
    sol = spec["solver"]
    opt = AdamW(weight_decays(spec), sol["betas"], sol["eps"], sol["clip_grad_norm"])
    state = opt.init(params)
    losses, grad1, g1 = [], None, None
    gen = torch.Generator(device=device)
    for (clips_u8, infos), seed in zip(batches, step_seeds):
        mask = infos["mask"]
        if half:
            keep = clips_u8.shape[0] // 2
            clips_u8, mask = clips_u8[:keep], mask[:keep]
        gen.manual_seed(seed)
        b, k = clips_u8.shape[:2]
        clips = only_crop(clips_u8.reshape(b * k, *clips_u8.shape[2:]), spec["aug"], gen)
        keeps = model.draw_keeps(b * k, gen)
        loss, grads = _loss_grads(model, params, clips, mask.reshape(b * k, *mask.shape[2:]), keeps,
                                  int(spec["chunk"]), device)
        if grad1 is None:
            g1 = {n: g.detach() for n, g in opt.received(grads).items()}
            grad1 = leaf_norms(g1)
        state = opt.step(params, grads, state, lr)
        losses.append(float(loss))
        del grads
    change = leaf_norms({n: params[n].detach() - start[n] for n in params})
    return {"losses": losses, "grad1": grad1, "change": change, "g1": g1}


def flops_per_step(spec: dict, traffic: dict) -> int:
    """Model FLOPs of one step, forward and backward with nothing
    recomputed, counted by ``torch.utils.flop_counter`` over this
    reference's model on the meta device at the traffic's shapes (the HOG
    targets, which need no gradient, left out)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = build_model(spec, "meta")
    n = traffic["videos_per_step"] * traffic["clips_per_video"]
    crop = spec["crop"]
    t, h, w = patch_grid(spec)
    x = torch.empty(n, traffic["frames"], crop, crop, 3, device="meta")
    mask = torch.empty(n, t, h, w, device="meta")
    keeps = [(None, None)] * spec["depth"]
    with FlopCounterMode(display=False) as counter:
        pred = model(x, mask, keeps)
        loss = pred.float().square().mean()
        torch.autograd.grad(loss, list(model.parameters()))
    return int(counter.get_total_flops())
