"""Pooled multiscale attention (counterpart of
``advise_tpu/models/layers/attention.py``): token pooling, MultiScaleAttention
with the flash / dense dispatch, and MultiScaleBlock.

Tokens are ``[B, N, C]``; the pools run on ``[B * heads, c, T, H, W]`` views
of the channel-last grid. The attention pools q, k and v (MVIT.MODE) with
depthwise convs and LayerNorms ('conv'; 'conv_unshared' also pools a
transition's residual over one fold, not one per head), or with a max or
average pool (padding k // 2: Flax pads a max pool with -inf and counts the
padding in an average, as torch's pools do) and no norm; the cls token
bypasses the pool. MVIT.SEPARATE_QKV projects q, k and v with three Dense
layers; MVIT.POOL_FIRST pools the input folded into heads and then projects
q, k and v at their pooled lengths. MViTv2's options: the decomposed
relative position biases (MVIT.REL_POS_SPATIAL / REL_POS_TEMPORAL, their
tables linearly resized, antialiased when they shrink, as
``jax.image.resize`` does), residual pooling (``out + q``) and
DIM_MUL_IN_ATT (the attention widens, the skip is projected from the
normalised input). MVIT.LAYER_SCALE_INIT_VALUE scales each branch by a
learned per-channel gamma; MVIT.DROPOUT_RATE drops after the attention's
projection and in the MLP, from a generator the block seeds from a number
the model drew before any block ran (so a recomputation draws the same
masks). A block with a relative position bias runs the dense chain, never
flash attention, as in JAX; every pooling mode keeps K4 otherwise.

The sequence-parallel branch (``seq_axis``, from MVIT.SEQ_SHARD under
TPU.MESH_SEQ; JAX ``attention.py:260-308``): with no cls token and no
relative position bias, and q's tokens dividing over the group, each rank
takes its slice of q. Square attention (as many keys as queries) goes
round the ring (``parallel/ring_attention.py``); pooled-KV attention keeps
the whole k and v and runs the block's own chain (K4 or the dense chain,
JAX's ``_dense_attention``) on the q slice. The slices are gathered over
the group, the gather's backward summing the cotangents, as JAX transposes
``all_gather``. Without a group of more than one rank it is the plain path.

Tensor parallelism (TPU.PARTITION_MODE 'auto' with MESH_MODEL,
``parallel/auto_shard.py`` sets ``tp``): the rank holds whole heads, the
rows of qkv (q, k, v) and the columns of proj that belong to them
(Megatron's split); the input enters through ``copy_to`` (its cotangent
summed over 'model'), the pools' weights and norms and the relative
position tables, shared by the heads, through ``copy_to`` too, and proj's
partial products are summed over 'model' (``reduce_from``) before its
bias. A transition's residual pools over all heads' folds, as without the
split.

Under bf16 autocast q, k and v are cast back to the compute dtype after
their pools and LayerNorms (autocast runs ``layer_norm`` in float32, where
Flax's ``LayerNorm(dtype=bf16)`` returns bf16), so the flash kernel sees
bf16 as the JAX kernel does.

The attention's core, from the pooled q, k and v through the residual
pooling, runs in a span of ``utils/host_times.py HOST_TIMES`` named by its
route (:attr:`MultiScaleAttention.route`): ``attn.k4``, ``attn.relpos``
(the dense chain with relative position biases) or ``attn.dense``. The
span covers the forward pass and a recomputation (REMAT) where they run,
and the core's backward on autograd's thread: an identity autograd
Function at each end of the core (:class:`_CoreEnd`, :class:`_CoreStart`)
opens the span in its backward and closes it in the other's. Under a
profiler each span is a ``record_function`` of its name.
:data:`ATTENTION_CALLS` counts the core's calls by route: ``<route>`` in
the forward pass, ``<route>.recompute`` inside a backward (REMAT),
``<route>.backward``. Neither changes a value.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.layers.common import (
    DropPath,
    Mlp,
    dense,
    divided_init,
    dropout,
    layer_norm,
    layer_scale_gamma,
    lecun_normal_init,
    seeded_generator_from,
    trunc02,
    zeros_init,
)
from advise_tpu_torch.ops.flash_attention import flash_mha
from advise_tpu_torch.parallel.collectives import (
    all_gather_dim,
    copy_to,
    reduce_from,
    replica_index,
    world_size,
)
from advise_tpu_torch.parallel.ring_attention import ring_attention
from advise_tpu_torch.utils.host_times import HOST_TIMES

Thw = Tuple[int, int, int]
ATTENTION_CALLS: collections.Counter = collections.Counter()  # process-wide, never reset here


class _BackwardSpan:
    """The route's span over the core's backward: opened by the core's end,
    closed by its start, both on autograd's thread."""

    def __init__(self, route: str):
        self.route, self.cm = route, None

    def open(self) -> None:
        ATTENTION_CALLS[self.route + ".backward"] += 1
        self.cm = HOST_TIMES(self.route)
        self.cm.__enter__()

    def close(self) -> None:
        cm, self.cm = self.cm, None
        if cm is not None:
            cm.__exit__(None, None, None)


class _CoreEnd(torch.autograd.Function):
    """The identity on the core's output; its backward opens the span."""

    @staticmethod
    def forward(ctx, span: _BackwardSpan, out: torch.Tensor):
        ctx.span = span
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        ctx.span.open()
        return None, g


class _CoreStart(torch.autograd.Function):
    """The identity on the core's q, k and v; its backward closes the span."""

    @staticmethod
    def forward(ctx, span: _BackwardSpan, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        ctx.span = span
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        ctx.span.close()
        return None, gq, gk, gv


def pool_tokens(x: torch.Tensor, thw: Sequence[int], kernel: Sequence[int],
                stride: Sequence[int], has_cls: bool, conv=None, norm=None,
                mode: str = "max") -> Tuple[torch.Tensor, Thw]:
    """attention_pool on [B, H, L, c]: the depthwise ``conv`` then ``norm``
    (modules, or functions of one tensor), or, without a conv, a max or (``mode`` 'avg') an average pool, padding
    k // 2 counted in the average; the cls token bypasses the pool."""
    if not kernel:
        return x, tuple(thw)
    b, h, _, c = x.shape
    cls_tok = None
    if has_cls:
        cls_tok, x = x[:, :, :1], x[:, :, 1:]
    t, hh, ww = thw
    grid = x.reshape(b * h, t, hh, ww, c).permute(0, 4, 1, 2, 3)
    if conv is None and mode == "avg":
        # zeros padded first: torch's avg_pool3d refuses a window wider
        # than the unpadded input, which Flax's pads to cover
        pad = [p for k in reversed(tuple(kernel)) for p in (k // 2, k // 2)]
        grid = F.avg_pool3d(F.pad(grid, pad), tuple(kernel), tuple(stride))
    elif conv is None:
        grid = F.max_pool3d(grid, tuple(kernel), tuple(stride), tuple(k // 2 for k in kernel))
    else:
        grid = conv(grid)
    new_thw = tuple(grid.shape[2:])
    x = grid.permute(0, 2, 3, 4, 1).reshape(b, h, -1, c)
    if has_cls:
        x = torch.cat([cls_tok, x], dim=2)
    if norm is not None:
        x = norm(x)
    return x, new_thw


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of ``jax.image.resize(..., 'linear')``
    along one axis: half-pixel sample positions, the triangle kernel
    widened by n_in / n_out when the axis shrinks (antialiasing), each
    column normalised to sum 1."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


_ON_DEVICE: dict = {}  # (what, sizes, device, dtype) -> a constant made on the host once


def _on_device(what: str, sizes: Tuple[int, int], device, dtype, make) -> torch.Tensor:
    """``make(*sizes)`` (a host tensor) on ``device``, copied there once per
    key: a copy from pageable host memory each forward would wait for the
    device's queue to drain, once per table in every block and
    recomputation."""
    key = (what, sizes, torch.device(device), dtype)
    out = _ON_DEVICE.get(key)
    if out is None:
        out = _ON_DEVICE[key] = make(*sizes).to(device, dtype)
    return out


def rel_pos_table(rel_pos: torch.Tensor, d: int) -> torch.Tensor:
    """The table [L, head_dim] linearly resized to length ``d``."""
    if rel_pos.shape[0] == d:
        return rel_pos
    w = _on_device("resize", (rel_pos.shape[0], d), rel_pos.device, rel_pos.dtype,
                   lambda n_in, n_out: torch.from_numpy(_resize_weights(n_in, n_out)))
    return w.t() @ rel_pos


def rel_dist(q_n: int, k_n: int) -> torch.Tensor:
    """[q_n, k_n] int64 indices into a table of 2 * max(q_n, k_n) - 1 rows:
    the offset of query i from key j, each scaled to the finer grid."""
    q_ratio = max(k_n / q_n, 1.0)
    k_ratio = max(q_n / k_n, 1.0)
    dist = np.arange(q_n)[:, None] * q_ratio - np.arange(k_n)[None, :] * k_ratio
    return torch.from_numpy((dist + (k_n - 1) * k_ratio).astype(np.int64))


def rel_index(q_n: int, k_n: int, device) -> torch.Tensor:
    """:func:`rel_dist` on ``device``."""
    return _on_device("dist", (q_n, k_n), device, torch.int64, rel_dist)


def _add_block(attn: torch.Tensor, block: torch.Tensor, sp: int) -> torch.Tensor:
    """``attn`` with its token-by-token part (past ``sp`` cls rows and
    columns) replaced by ``block``."""
    if not sp:
        return block
    return torch.cat([attn[:, :, :sp], torch.cat([attn[:, :, sp:, :sp], block], dim=3)], dim=2)


def add_rel_pos_spatial(attn: torch.Tensor, q: torch.Tensor, has_cls: bool, q_shape, k_shape,
                        rel_h: torch.Tensor, rel_w: torch.Tensor) -> torch.Tensor:
    """The scores [B, H, Nq, Nk] plus q's products with the height and width
    tables at each query-key offset (the cls token's rows and columns
    untouched)."""
    sp = 1 if has_cls else 0
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    rh = rel_pos_table(rel_h, 2 * max(q_h, k_h) - 1)[rel_index(q_h, k_h, rel_h.device)]
    rw = rel_pos_table(rel_w, 2 * max(q_w, k_w) - 1)[rel_index(q_w, k_w, rel_w.device)]
    b, nh, _, dim = q.shape
    r_q = q[:, :, sp:].reshape(b, nh, q_t, q_h, q_w, dim)
    rel_h_q = torch.einsum("bythwc,hkc->bythwk", r_q, rh.to(r_q.dtype))
    rel_w_q = torch.einsum("bythwc,wkc->bythwk", r_q, rw.to(r_q.dtype))
    block = attn[:, :, sp:, sp:].reshape(b, nh, q_t, q_h, q_w, k_t, k_h, k_w)
    block = (block + rel_h_q[:, :, :, :, :, None, :, None]
             + rel_w_q[:, :, :, :, :, None, None, :]).reshape(b, nh, q_t * q_h * q_w, k_t * k_h * k_w)
    return _add_block(attn, block, sp)


def add_rel_pos_temporal(attn: torch.Tensor, q: torch.Tensor, has_cls: bool, q_shape, k_shape,
                         rel_t: torch.Tensor) -> torch.Tensor:
    """The scores plus q's products with the temporal table at each offset."""
    sp = 1 if has_cls else 0
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    rt = rel_pos_table(rel_t, 2 * max(q_t, k_t) - 1)[rel_index(q_t, k_t, rel_t.device)]
    b, nh, _, dim = q.shape
    r_q = q[:, :, sp:].reshape(b, nh, q_t, q_h, q_w, dim)
    rel = torch.einsum("bythwc,tkc->bythwk", r_q, rt.to(r_q.dtype))
    block = attn[:, :, sp:, sp:].reshape(b, nh, q_t, q_h, q_w, k_t, k_h, k_w)
    block = (block + rel[:, :, :, :, :, :, None, None]).reshape(b, nh, q_t * q_h * q_w, k_t * k_h * k_w)
    return _add_block(attn, block, sp)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    bias=None) -> torch.Tensor:
    """The JAX module's dense chain: float32 scores of ``q * scale`` and k,
    ``bias(scores)`` added (the relative position terms), softmax,
    probabilities cast to v's dtype, then ``@ v`` in that dtype."""
    with torch.autocast(q.device.type, enabled=False):
        attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
        if bias is not None:
            attn = bias(attn)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        return torch.matmul(attn, v)


def _no_trivial_pool(kernel, stride):
    kernel, stride = tuple(kernel), tuple(stride)
    if kernel and math.prod(kernel) == 1 and math.prod(stride) == 1:
        return ()
    return kernel


class MultiScaleAttention(nn.Module):
    """Pooled multi-head attention on tokens of width ``dim``, ``dim_out``
    wide: the qkv projection (``separate_qkv``: q, k and v apart), the
    pooling of q and of k, v (``mode``), attention through K4 (``flash``)
    or the dense chain (with the relative position biases of a block
    ``input_size`` on the grid), ``+ q`` under ``residual_pooling``, output
    projection (its init divided by ``proj_init_div``), dropout at
    ``drop_rate``. With ``pool_first`` the input is folded into heads and
    pooled first, and q, k and v are projected after."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, qkv_bias: bool = False,
                 kernel_q: Sequence[int] = (), kernel_kv: Sequence[int] = (),
                 stride_q: Sequence[int] = (), stride_kv: Sequence[int] = (),
                 has_cls_embed: bool = True, flash: bool = False,
                 flash_native_dim_only: bool = False, dtype: Optional[torch.dtype] = None,
                 input_size: Sequence[int] = (), rel_pos_spatial: bool = False,
                 rel_pos_temporal: bool = False, rel_pos_zero_init: bool = False,
                 residual_pooling: bool = False, proj_init_div: float = 1.0,
                 mode: str = "conv", pool_first: bool = False, separate_qkv: bool = False,
                 drop_rate: float = 0.0, seq_axis: Optional[str] = None):
        super().__init__()
        if mode not in ("conv", "conv_unshared", "avg", "max"):
            raise NotImplementedError(f"MVIT.MODE={mode}")
        self.num_heads = num_heads
        self.seq_axis = (seq_axis if seq_axis and not (rel_pos_spatial or rel_pos_temporal or has_cls_embed)
                         else None)
        self.tp = None  # (axes, size, index) once parallel/auto_shard.py splits the heads
        self.dim_out = dim_out
        self.mode, self.pool_first, self.separate_qkv = mode, pool_first, separate_qkv
        self.drop_rate = drop_rate
        head_dim = dim_out // num_heads
        self.scale = head_dim ** -0.5
        self.kernel_q = _no_trivial_pool(kernel_q, stride_q)
        self.kernel_kv = _no_trivial_pool(kernel_kv, stride_kv)
        self.stride_q, self.stride_kv = tuple(stride_q), tuple(stride_kv)
        self.has_cls_embed = has_cls_embed
        self.rel_pos_spatial, self.rel_pos_temporal = rel_pos_spatial, rel_pos_temporal
        self.residual_pooling = residual_pooling
        self.flash = (flash and not rel_pos_spatial and not rel_pos_temporal
                      and not (flash_native_dim_only and head_dim > 128 and head_dim % 128))
        self.route = ("attn.k4" if self.flash else
                      "attn.relpos" if rel_pos_spatial or rel_pos_temporal else "attn.dense")
        self.dtype = dtype
        if pool_first or separate_qkv:
            for name in ("q", "k", "v"):
                self.add_module(name, dense(dim, dim_out, bias=qkv_bias, init=trunc02, bias_value=0.02))
        else:
            self.qkv = dense(dim, 3 * dim_out, bias=qkv_bias, init=trunc02, bias_value=0.02)
        dim_conv = dim // num_heads if pool_first else head_dim
        for name, kernel, stride in (("q", self.kernel_q, self.stride_q),
                                     ("k", self.kernel_kv, self.stride_kv),
                                     ("v", self.kernel_kv, self.stride_kv)):
            if not kernel or mode in ("avg", "max"):
                continue
            conv = nn.Conv3d(dim_conv, dim_conv, kernel, stride=stride,
                             padding=tuple(k // 2 for k in kernel), groups=dim_conv, bias=False)
            conv.weight_init = lecun_normal_init
            self.add_module(f"pool_{name}", conv)
            self.add_module(f"norm_{name}", layer_norm(dim_conv))
        self.proj = dense(dim_out, dim_out, init=divided_init(trunc02, proj_init_div), bias_value=0.02)
        self.param_inits = {}
        rel_init = zeros_init if rel_pos_zero_init else trunc02
        if rel_pos_spatial or rel_pos_temporal:
            if len(input_size) != 3:
                raise ValueError("relative position biases need the block's input_size (t, h, w)")
        if rel_pos_spatial:
            size = input_size[1]
            rel_sp_dim = 2 * max(size // (self.stride_q[1] if self.stride_q else 1),
                                 size // (self.stride_kv[1] if self.stride_kv else 1)) - 1
            for name in ("rel_pos_h", "rel_pos_w"):
                setattr(self, name, nn.Parameter(torch.zeros(rel_sp_dim, head_dim)))
                self.param_inits[name] = rel_init
        if rel_pos_temporal:
            self.rel_pos_t = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
            self.param_inits["rel_pos_t"] = rel_init

    def _pool(self, x, thw, name, split: bool = False):
        """Pool q, k or v (``name``); ``split``: x holds this rank's heads,
        so the pool's weights, shared by every head, enter through
        ``copy_to`` over 'model'."""
        kernel, stride = (self.kernel_q, self.stride_q) if name == "q" else (self.kernel_kv, self.stride_kv)
        conv, norm = getattr(self, f"pool_{name}", None), getattr(self, f"norm_{name}", None)
        if split and conv is not None:
            axes = self.tp[0]
            c = conv
            conv = lambda g: F.conv3d(g, copy_to(c.weight, axes), None, c.stride, c.padding, c.dilation,  # noqa: E731
                                      c.groups)
        if split and norm is not None:
            axes, ln = self.tp[0], norm
            norm = lambda t: F.layer_norm(t, ln.normalized_shape, copy_to(ln.weight, axes),  # noqa: E731
                                          copy_to(ln.bias, axes), ln.eps)
        return pool_tokens(x, thw, kernel, stride, self.has_cls_embed, conv, norm, self.mode)

    def _attend(self, q, k, v, q_shape, k_shape):
        """K4, or the dense chain with the relative position biases."""
        if self.flash:
            return flash_mha(q, k, v, self.scale)
        return dense_attention(q, k, v, self.scale, self._rel_pos_bias(q, q_shape, k_shape))

    def _seq_attention(self, q, k, v, q_shape, k_shape):
        """The sequence-parallel branch (module docstring), or None where
        the block takes the plain path."""
        nseq = world_size(self.seq_axis) if self.seq_axis else 1
        nq, nk = q.shape[2], k.shape[2]
        if nseq <= 1 or nq % nseq:
            return None
        my = replica_index(self.seq_axis)
        rows = slice(my * (nq // nseq), (my + 1) * (nq // nseq))
        if nk == nq:
            out = ring_attention(q[:, :, rows], k[:, :, rows], v[:, :, rows], self.seq_axis, self.scale)
        else:
            out = self._attend(q[:, :, rows], k, v, q_shape, k_shape)
        return all_gather_dim(out, self.seq_axis, 2)

    def _rel_pos_bias(self, q, q_shape, k_shape):
        if not (self.rel_pos_spatial or self.rel_pos_temporal):
            return None

        def table(t):
            return t if self.tp is None else copy_to(t, self.tp[0])

        def bias(attn):
            if self.rel_pos_spatial:
                attn = add_rel_pos_spatial(attn, q, self.has_cls_embed, q_shape, k_shape,
                                           table(self.rel_pos_h), table(self.rel_pos_w))
            if self.rel_pos_temporal:
                attn = add_rel_pos_temporal(attn, q, self.has_cls_embed, q_shape, k_shape,
                                            table(self.rel_pos_t))
            return attn

        return bias

    def _core(self, q, k, v, q_shape, k_shape):
        """Attention of the pooled q, k and v, then ``+ q`` under residual
        pooling, in the route's span (module docstring)."""
        recompute = torch._C._current_graph_task_id() != -1
        ATTENTION_CALLS[self.route + (".recompute" if recompute else "")] += 1
        span = None
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            span = _BackwardSpan(self.route)
        with HOST_TIMES(self.route):
            if span is not None:
                q, k, v = _CoreStart.apply(span, q, k, v)
            out = self._seq_attention(q, k, v, q_shape, k_shape)
            if out is None:
                out = self._attend(q, k, v, q_shape, k_shape)
            if self.residual_pooling:
                if self.has_cls_embed:
                    out = torch.cat([out[:, :, :1], out[:, :, 1:] + q[:, :, 1:]], dim=2)
                else:
                    out = out + q
            return out if span is None else _CoreEnd.apply(span, out)

    def forward(self, x: torch.Tensor, thw: Sequence[int], x_res: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``x_res``: a residual stream to pool through the SAME pool_q conv and
        norm_q as q (MVIT.REV.RES_PATH 'conv'); when given, returns (out,
        q_shape, pooled residual), else (out, q_shape). ``generator`` draws
        the dropout mask in training."""
        b, n, _ = x.shape
        tp = self.tp
        nh = self.num_heads if tp is None else self.num_heads // tp[1]

        def heads(t):
            return t.reshape(b, t.shape[1], nh, -1).transpose(1, 2)

        if self.pool_first:
            q = k = v = x.reshape(b, n, self.num_heads, -1).transpose(1, 2)
        else:
            x_in = x if tp is None else copy_to(x, tp[0])
            if self.separate_qkv:
                q, k, v = heads(self.q(x_in)), heads(self.k(x_in)), heads(self.v(x_in))
            else:
                q, k, v = self.qkv(x_in).reshape(b, n, 3, nh, -1).permute(2, 0, 3, 1, 4).unbind(0)

        res_pooled = None
        if x_res is not None:
            rc = x_res.shape[-1]
            fold = 1 if self.mode == "conv_unshared" else self.num_heads
            r = x_res.reshape(b, n, fold, rc // fold).transpose(1, 2)
            r, _ = self._pool(r, thw, "q")
            res_pooled = r.transpose(1, 2).reshape(b, -1, rc)

        split = tp is not None and not self.pool_first  # the pools act on this rank's heads
        q, q_shape = self._pool(q, thw, "q", split)
        k, k_shape = self._pool(k, thw, "k", split)
        v, _ = self._pool(v, thw, "v", split)
        if self.pool_first:
            q, k, v = (heads(getattr(self, name)(
                t.transpose(1, 2).reshape(b, t.shape[2], -1) if tp is None
                else copy_to(t.transpose(1, 2).reshape(b, t.shape[2], -1), tp[0])))
                for name, t in (("q", q), ("k", k), ("v", v)))
        if self.dtype is not None:
            q, k, v = q.to(self.dtype), k.to(self.dtype), v.to(self.dtype)
        out = self._core(q, k, v, q_shape, k_shape)
        out = out.transpose(1, 2).reshape(b, out.shape[2], -1)
        if tp is None:
            out = self.proj(out)
        else:
            out = reduce_from(F.linear(out, self.proj.weight), tp[0]) + self.proj.bias
        if self.training and self.drop_rate > 0.0:
            out = dropout(out, self.drop_rate, generator)
        if x_res is not None:
            return out, q_shape, res_pooled
        return out, q_shape


class MultiScaleBlock(nn.Module):
    """norm1 -> attention (+ the residual max-pooled with kernel stride + 1
    where Q pools, projected when the width changes) -> norm2 -> MLP, each
    branch behind its own drop path; the keep masks come from the caller
    (``keeps`` = (attention's, MLP's)). With ``dim_mul_in_att`` the
    attention is ``dim_out`` wide and the skip is projected from the
    normalised input before its pool; otherwise the MLP's skip is projected
    from the second norm. ``init_div`` divides the initial weights of the
    attention's projection and of fc2. With ``layer_scale_init_value`` > 0
    each branch is scaled by a learned per-channel gamma (``gamma_1`` the
    attention's, ``gamma_2`` the MLP's) starting at that value; the
    dropouts at ``drop_rate`` draw from a generator seeded by the caller's
    ``seed``."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_path: float = 0.0,
                 kernel_q=(), kernel_kv=(), stride_q=(), stride_kv=(),
                 has_cls_embed: bool = True, flash: bool = False,
                 flash_native_dim_only: bool = False, dtype: Optional[torch.dtype] = None,
                 input_size: Sequence[int] = (), rel_pos_spatial: bool = False,
                 rel_pos_temporal: bool = False, rel_pos_zero_init: bool = False,
                 residual_pooling: bool = False, dim_mul_in_att: bool = False,
                 init_div: float = 1.0, mode: str = "conv", pool_first: bool = False,
                 separate_qkv: bool = False, layer_scale_init_value: float = 0.0,
                 drop_rate: float = 0.0, seq_axis: Optional[str] = None):
        super().__init__()
        self.stride_q = tuple(stride_q)
        self.has_cls_embed = has_cls_embed
        self.dim_mul_in_att = dim_mul_in_att
        att_dim = dim_out if dim_mul_in_att else dim
        self.norm1 = layer_norm(dim)
        self.attn = MultiScaleAttention(dim, att_dim, num_heads, qkv_bias, kernel_q, kernel_kv,
                                        stride_q, stride_kv, has_cls_embed, flash,
                                        flash_native_dim_only, dtype, input_size, rel_pos_spatial,
                                        rel_pos_temporal, rel_pos_zero_init, residual_pooling,
                                        proj_init_div=init_div, mode=mode, pool_first=pool_first,
                                        separate_qkv=separate_qkv, drop_rate=drop_rate,
                                        seq_axis=seq_axis)
        if dim != dim_out:
            self.proj = dense(dim, dim_out, init=trunc02, bias_value=0.02)
        self.drop_path = DropPath(drop_path)
        self.norm2 = layer_norm(att_dim)
        self.mlp = Mlp(att_dim, int(att_dim * mlp_ratio), dim_out, fc2_init_div=init_div,
                       drop_rate=drop_rate)
        layer_scale_gamma(self, "gamma_1", att_dim, layer_scale_init_value)
        layer_scale_gamma(self, "gamma_2", dim_out, layer_scale_init_value)

    def forward(self, x: torch.Tensor, thw: Sequence[int], keeps=(None, None),
                seed: Optional[int] = None):
        gen = seeded_generator_from(seed, x.device)
        x_norm = self.norm1(x)
        x_block, thw_new = self.attn(x_norm, thw, generator=gen)
        if self.dim_mul_in_att and hasattr(self, "proj"):
            x = self.proj(x_norm)
        stride = self.stride_q
        if stride and math.prod(stride) > 1:
            kernel = tuple(s + 1 if s > 1 else s for s in stride)
            x = pool_tokens(x[:, None], thw, kernel, stride, self.has_cls_embed)[0][:, 0]
        if hasattr(self, "gamma_1"):
            x_block = self.gamma_1 * x_block
        x = x + self.drop_path(x_block, keeps[0])
        x_norm2 = self.norm2(x)
        x_mlp = self.mlp(x_norm2, gen)
        if not self.dim_mul_in_att and hasattr(self, "proj"):
            x = self.proj(x_norm2)
        if hasattr(self, "gamma_2"):
            x_mlp = self.gamma_2 * x_mlp
        return x + self.drop_path(x_mlp, keeps[1]), thw_new
