"""Video Swin Transformer (counterpart of ``advise_tpu/models/swin3d.py``):
3D shifted-window attention, the ``SwinTransformer3D`` backbone and its
``BasicLayer``, which is also AdViSe's ``video_swin`` temporal head.

Grids are channels-last ``[B, D, H, W, C]`` as in Flax. Precision follows
the Flax modules' ``dtype`` (``clip_vit.py``): every Dense and the patch
conv take their input and weights cast to ``dtype``, and each LayerNorm
computes its statistics and normalisation in float32 and returns
``dtype``. The window attention keeps JAX's order: q scaled by
``head_dim ** -0.5`` in ``dtype``, float32 scores, the float32 relative
position bias and the shift mask added, the softmax in float32 and cast to
v's dtype, then ``@ v`` in that dtype. It is einsums in the reference, so
it owes no kernel here (and runs neither SDPA nor K4).

A window is clamped to the grid it sees (``get_window_size``), and the
relative position table of a clamped window is smaller. Flax sizes the
table at ``init``, from the input the model is initialised with; the port
sizes it when the module is built, from the grid each block is built for
(for the backbone: DATA.NUM_FRAMES x AUG.TARGET_SIZE^2, the input JAX's
train state initialises with). A forward whose grid clamps the window
otherwise raises, as a Flax apply with a table of another shape does.

The shift masks and the relative position index are functions of the
static geometry. Each is made once per (geometry, device) in numpy and kept
on the device in a cache of this module, not in a buffer: it is in no
``state_dict``, checkpoint or converter key set, and a
``torch.func.functional_call`` over the parameters (AdViSe's BYOL twins)
reads the same constants.

Module and parameter names are the Flax ones (``layers_{i}``,
``blocks_{j}``, ``attn.qkv``, ``attn.relative_position_bias_table``,
``mlp.fc1``, ``downsample.reduction``, ...), so ``utils/convert.py`` maps a
Flax tree onto the ``state_dict`` with its general rules.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from advise_tpu_torch.models.clip_vit import _cast, layer_norm, linear
from advise_tpu_torch.models.layers.common import DropPath, Mlp, dense, draw_keep, lecun_normal_init, trunc02
from advise_tpu_torch.models.layers.heads import TransformerBasicHead
from advise_tpu_torch.models.layers.norm import head_sync_axes
from advise_tpu_torch.parallel.collectives import copy_to, reduce_from

Triple = Tuple[int, int, int]
Keeps = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def window_partition(x: torch.Tensor, window_size: Sequence[int]) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, wd*wh*ww, C], the window index fastest
    inside the batch."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window_size
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, c)


def window_reverse(windows: torch.Tensor, window_size: Sequence[int], b: int, d: int, h: int,
                   w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    wd, wh, ww = window_size
    x = windows.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, -1)


def get_window_size(x_size, window_size, shift_size=None):
    """The window (and shift) clamped to the input: where the input is no
    larger than the window, the window takes the input's size and the shift
    is 0."""
    use_window = list(window_size)
    use_shift = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            if use_shift is not None:
                use_shift[i] = 0
    if shift_size is None:
        return tuple(use_window)
    return tuple(use_window), tuple(use_shift)


def _region_slices(window: int, shift: int):
    """The three regions of one axis after a cyclic shift (``slice(-w)`` is
    ``[:-w]``); the last two only when the axis is shifted."""
    out = [slice(-window)]
    if shift:
        out += [slice(-window, -shift), slice(-shift, None)]
    return out


def compute_mask(d: int, h: int, w: int, window_size: Sequence[int], shift_size: Sequence[int]) -> np.ndarray:
    """The shifted windows' attention mask [nW, n, n], float32: 0 between
    tokens of one region of the shifted grid, -100 between regions."""
    img_mask = np.zeros((1, d, h, w, 1))
    cnt = 0
    for ds in _region_slices(window_size[0], shift_size[0]):
        for hs in _region_slices(window_size[1], shift_size[1]):
            for ws in _region_slices(window_size[2], shift_size[2]):
                img_mask[:, ds, hs, ws, :] = cnt
                cnt += 1
    wd, wh, ww = window_size
    mask_windows = img_mask.reshape(1, d // wd, wd, h // wh, wh, w // ww, ww, 1).transpose(
        0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww)
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def _rel_pos_index(window_size: Sequence[int]) -> np.ndarray:
    """[n, n] index of each query-key pair's relative position into the bias
    table of ``(2wd-1)(2wh-1)(2ww-1)`` rows."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def device_mask(dp: int, hp: int, wp: int, window: Triple, shift: Triple, device: torch.device) -> torch.Tensor:
    """:func:`compute_mask` on ``device``, made once per geometry."""
    return torch.from_numpy(compute_mask(dp, hp, wp, window, shift)).to(device)


@functools.lru_cache(maxsize=None)
def device_index(window: Triple, device: torch.device) -> torch.Tensor:
    """:func:`_rel_pos_index` flattened, on ``device``, made once per window."""
    return torch.from_numpy(_rel_pos_index(window).reshape(-1)).to(device)


def window_softmax(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
                   scale: float, dtype: torch.dtype) -> torch.Tensor:
    """The window attention's float32 chain: q [B*nW, heads, n, hd] scaled
    in its own dtype, float32 scores against k, the float32 bias [heads, n,
    n] and the shift mask [nW, n, n] (or None) added, the softmax in float32
    cast to ``dtype``."""
    attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2)) + bias[None].float()
    if mask is not None:
        b_, heads, n, _ = attn.shape
        nw = mask.shape[0]
        attn = (attn.reshape(b_ // nw, nw, heads, n, n) + mask[None, :, None]).reshape(b_, heads, n, n)
    return torch.softmax(attn, dim=-1).to(dtype)


class WindowAttention3D(nn.Module):
    """Multi-head self-attention inside windows of ``window_size`` (the
    clamped window), with a learned relative position bias per head. Split
    over 'model' (``tp``, set by ``parallel/auto_shard.py``) the rank holds
    whole heads: qkv's rows and proj's columns of its heads, the input
    through ``copy_to``, the bias table (whole, every rank's) through
    ``copy_to`` and cut to its heads' columns, proj's partial products
    summed over 'model' before its bias."""

    tp = None  # (axes, size, index) once split over 'model'

    def __init__(self, dim: int, window_size: Triple, num_heads: int, qkv_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.dtype = dtype
        wd, wh, ww = self.window_size
        self.qkv = dense(dim, 3 * dim, bias=qkv_bias, init=trunc02)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.param_inits = {"relative_position_bias_table": trunc02}
        self.proj = dense(dim, dim, init=trunc02)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B*nW, n, C]; ``mask`` [nW, n, n] or None."""
        b_, n, c = x.shape
        tp = self.tp
        heads = self.num_heads if tp is None else self.num_heads // tp[1]
        table = self.relative_position_bias_table
        if tp is not None:
            x = copy_to(x, tp[0])
            table = copy_to(table, tp[0])[:, tp[2] * heads:(tp[2] + 1) * heads]
        qkv = linear(self.qkv, x, self.dtype).reshape(b_, n, 3, heads, c // self.num_heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        with torch.autocast(x.device.type, enabled=False):
            idx = device_index(self.window_size, x.device)
            bias = table[idx].reshape(n, n, heads).permute(2, 0, 1)
            out = torch.matmul(window_softmax(q, k, bias, mask, self.scale, v.dtype), v)
        out = out.transpose(1, 2).reshape(b_, n, -1)
        if tp is None:
            return linear(self.proj, out, self.dtype)
        out = F.linear(_cast(out, self.dtype), _cast(self.proj.weight, self.dtype))
        return reduce_from(out, tp[0]) + _cast(self.proj.bias, self.dtype)


class SwinTransformerBlock3D(nn.Module):
    """norm1 -> zero pad to window multiples -> cyclic shift -> window
    attention (masked across shifted regions) -> shift back -> crop ->
    drop path -> residual; norm2 -> Mlp -> drop path -> residual. One
    DropPath module serves both branches, each with its own keep mask.
    ``input_size`` is the grid (D, H, W) the block is built for: it sizes
    the clamped window's bias table."""

    def __init__(self, dim: int, num_heads: int, input_size: Sequence[int], window_size: Triple = (2, 7, 7),
                 shift_size: Triple = (0, 0, 0), mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        self.dtype = dtype
        window, _ = get_window_size(tuple(input_size), self.window_size, self.shift_size)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention3D(dim, window, num_heads, qkv_bias, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, keep_attn: Optional[torch.Tensor] = None,
                keep_mlp: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, d, h, w, c = x.shape
        window, shift = get_window_size((d, h, w), self.window_size, self.shift_size)
        if window != self.attn.window_size:
            raise ValueError(f"a grid of {(d, h, w)} clamps the window {self.window_size} to {window}; "
                             f"this block's bias table is for {self.attn.window_size}")
        shortcut = x
        x = layer_norm(self.norm1, x, self.dtype)
        pads = [(window[i] - s % window[i]) % window[i] for i, s in enumerate((d, h, w))]
        x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        _, dp, hp, wp, _ = x.shape
        mask = None
        if any(shift):
            x = torch.roll(x, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
            mask = device_mask(dp, hp, wp, window, shift, x.device)
        x = self.attn(window_partition(x, window), mask)
        x = window_reverse(x, window, b, dp, hp, wp)
        if any(shift):
            x = torch.roll(x, shifts=shift, dims=(1, 2, 3))
        x = x[:, :d, :h, :w]
        x = shortcut + self.drop_path(x, keep_attn)
        y = layer_norm(self.norm2, x, self.dtype)
        tp = self.mlp.tp  # split over 'model' (parallel/auto_shard.py): fc2's parts summed before its bias
        if tp is not None:
            y = copy_to(y, tp[0])
        y = F.gelu(linear(self.mlp.fc1, y, self.dtype), approximate="tanh")
        if tp is None:
            y = linear(self.mlp.fc2, y, self.dtype)
        else:
            y = reduce_from(F.linear(y, _cast(self.mlp.fc2.weight, self.dtype)), tp[0])
            y = y + _cast(self.mlp.fc2.bias, self.dtype)
        return x + self.drop_path(y, keep_mlp)


class PatchMerging(nn.Module):
    """2x spatial downsampling: pad odd H/W, concatenate the four 2x2
    neighbours (x0 [0::2, 0::2], x1 [1::2, 0::2], x2 [0::2, 1::2], x3
    [1::2, 1::2]), LayerNorm, a bias-free Dense to 2C."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = dense(4 * dim, 2 * dim, bias=False, init=trunc02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:4]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return linear(self.reduction, layer_norm(self.norm, x, self.dtype), self.dtype)


def merged_size(size: Sequence[int]) -> Triple:
    """The grid after :class:`PatchMerging`."""
    d, h, w = size
    return d, (h + 1) // 2, (w + 1) // 2


class BasicLayer(nn.Module):
    """One Swin stage: ``depth`` blocks, shift (0, 0, 0) and ``window // 2``
    alternating, then PatchMerging with ``downsample``. ``drop_path`` is one
    rate or one per block. With ``remat`` (TPU.REMAT) each block runs under
    ``torch.utils.checkpoint``, its drop-path masks given from outside so
    that the recomputation replays them."""

    def __init__(self, dim: int, depth: int, num_heads: int, input_size: Sequence[int],
                 window_size: Triple = (2, 7, 7), mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path=0.0, downsample: bool = False, dtype: Optional[torch.dtype] = None,
                 remat: bool = False):
        super().__init__()
        shift = tuple(ws // 2 for ws in window_size)
        self.rates = list(drop_path) if isinstance(drop_path, (list, tuple)) else [drop_path] * depth
        self.remat = remat
        self.depth = depth
        for i in range(depth):
            self.add_module(f"blocks_{i}", SwinTransformerBlock3D(
                dim, num_heads, input_size, tuple(window_size), (0, 0, 0) if i % 2 == 0 else shift,
                mlp_ratio, qkv_bias, float(self.rates[i]), dtype))
        self.downsample = PatchMerging(dim, dtype) if downsample else None

    def keeps(self, batch: int, generator: Optional[torch.Generator]) -> List[Keeps]:
        """Two keep masks a block (attention, MLP), in block order."""
        return [(draw_keep(batch, r, generator), draw_keep(batch, r, generator)) for r in self.rates]

    def forward(self, x: torch.Tensor, keeps: Optional[Sequence[Keeps]] = None) -> torch.Tensor:
        for i in range(self.depth):
            blk = getattr(self, f"blocks_{i}")
            k = keeps[i] if keeps is not None else (None, None)
            x = checkpoint(blk, x, *k, use_reentrant=False) if self.remat else blk(x, *k)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


def swin_input_size(cfg) -> Triple:
    """The clip geometry a config's model is built for: DATA.NUM_FRAMES x
    AUG.TARGET_SIZE^2, as JAX's train state initialises it."""
    return cfg.DATA.NUM_FRAMES, cfg.AUG.TARGET_SIZE, cfg.AUG.TARGET_SIZE


class SwinTransformer3D(nn.Module):
    """Video Swin: patch embedding (a strided conv with bias) -> LayerNorm ->
    the stages (stochastic depth linear in the block index up to
    DROP_PATH_RATE) -> LayerNorm -> the mean over (T, H, W) and, under
    MODEL_NAME ContrastiveModel, the CONTRASTIVE.DIM TransformerBasicHead (an
    MLP projector with CONTRASTIVE.NUM_MLP_LAYERS > 1), else a
    classification Dense (softmax in evaluation when MODEL.HEAD_ACT says
    so). The hyperparameters are cfg.SWIN's, the clip geometry
    :func:`swin_input_size`'s. ``forward(x, views, generator)``: clips [B, T,
    H, W, 3]; ``views`` splits the head's BN statistics; ``generator`` draws
    the drop-path and dropout masks in training."""

    def __init__(self, cfg, norm=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        s = cfg.SWIN
        self.patch_size = tuple(s.PATCH_SIZE)
        embed_dim, depths = s.EMBED_DIM, tuple(s.DEPTHS)
        self.dtype = dtype
        t, h, w = swin_input_size(cfg)
        grid = (t // self.patch_size[0], h // self.patch_size[1], w // self.patch_size[2])
        self.patch_embed = nn.Conv3d(3, embed_dim, self.patch_size, stride=self.patch_size)
        self.patch_embed.weight_init = lecun_normal_init
        self.norm_embed = nn.LayerNorm(embed_dim, eps=1e-5)
        dpr = [float(r) for r in np.linspace(0, s.DROP_PATH_RATE, sum(depths))]
        self.num_layers = len(depths)
        dim, at = embed_dim, 0
        for i, (depth, heads) in enumerate(zip(depths, s.NUM_HEADS)):
            last = i == len(depths) - 1
            self.add_module(f"layers_{i}", BasicLayer(
                dim, depth, heads, grid, tuple(s.WINDOW_SIZE), s.MLP_RATIO, drop_path=dpr[at:at + depth],
                downsample=not last, dtype=dtype, remat=bool(cfg.TPU.REMAT)))
            at += depth
            if not last:
                dim *= 2
                grid = merged_size(grid)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.contrastive = cfg.MODEL.MODEL_NAME == "ContrastiveModel"
        self.act_func = cfg.MODEL.HEAD_ACT
        if self.contrastive:
            c = cfg.CONTRASTIVE
            self.head = TransformerBasicHead(
                dim, c.DIM, dropout_rate=cfg.MODEL.DROPOUT_RATE, act_func=cfg.MODEL.HEAD_ACT,
                detach_final_fc=cfg.MODEL.DETACH_FINAL_FC, num_mlp_layers=c.NUM_MLP_LAYERS,
                mlp_dim=c.MLP_DIM, bn_mlp=c.BN_MLP, bn_sync_axes=head_sync_axes(norm, c.BN_SYNC_MLP))
        else:
            self.head = dense(dim, cfg.MODEL.NUM_CLASSES, init=trunc02)

    def keeps(self, batch: int, generator: Optional[torch.Generator]) -> List[List[Keeps]]:
        """This forward's drop-path masks, per stage, drawn before any block
        runs (none in evaluation)."""
        if not self.training:
            return [None] * self.num_layers
        return [getattr(self, f"layers_{i}").keeps(batch, generator) for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor, views: int = 1, generator: Optional[torch.Generator] = None):
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        conv = self.patch_embed
        x = F.conv3d(x.permute(0, 4, 1, 2, 3).to(dt), conv.weight.to(dt), conv.bias.to(dt),
                     stride=self.patch_size).permute(0, 2, 3, 4, 1)
        x = layer_norm(self.norm_embed, x, self.dtype)
        keeps = self.keeps(x.shape[0], generator)
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x, keeps[i])
        x = layer_norm(self.norm, x, self.dtype)
        x = x.mean(dim=(1, 2, 3))
        if self.contrastive:
            return self.head(x, generator, views)
        x = linear(self.head, x, self.dtype)
        if not self.training and self.act_func == "softmax":
            x = torch.softmax(x, dim=-1)
        return x
