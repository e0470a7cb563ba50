"""Pooled multiscale attention (counterpart of
``advise_tpu/models/layers/attention.py``): token pooling, MultiScaleAttention
with the flash / dense dispatch, and MultiScaleBlock.

Tokens are ``[B, N, C]``; the pools run on ``[B * heads, c, T, H, W]`` views
of the channel-last grid. The attention pools q, k and v with depthwise
convs and LayerNorms (MVIT.MODE 'conv'). Not ported yet (they raise): the
relative position biases, POOL_FIRST, the other pooling modes,
SEPARATE_QKV, RESIDUAL_POOLING, DIM_MUL_IN_ATT, layer scale and dropout.
The ring-attention branch (MVIT.SEQ_SHARD) is a no-op on one card, as JAX's
``nseq == 1`` branch is.

Under bf16 autocast q, k and v are cast back to the compute dtype after
their pools and LayerNorms (autocast runs ``layer_norm`` in float32, where
Flax's ``LayerNorm(dtype=bf16)`` returns bf16), so the flash kernel sees
bf16 as the JAX kernel does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.layers.common import (
    DropPath,
    Mlp,
    dense,
    layer_norm,
    lecun_normal_init,
    trunc02,
)
from advise_tpu_torch.ops.flash_attention import flash_mha

Thw = Tuple[int, int, int]


def pool_tokens(x: torch.Tensor, thw: Sequence[int], kernel: Sequence[int],
                stride: Sequence[int], has_cls: bool, conv: Optional[nn.Module] = None,
                norm: Optional[nn.Module] = None) -> Tuple[torch.Tensor, Thw]:
    """attention_pool on [B, H, L, c]: the depthwise ``conv`` then ``norm``,
    or, without a conv, a max pool (padding k // 2); the cls token bypasses
    the pool."""
    if not kernel:
        return x, tuple(thw)
    b, h, _, c = x.shape
    cls_tok = None
    if has_cls:
        cls_tok, x = x[:, :, :1], x[:, :, 1:]
    t, hh, ww = thw
    grid = x.reshape(b * h, t, hh, ww, c).permute(0, 4, 1, 2, 3)
    if conv is None:
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


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The JAX module's dense chain: float32 scores of ``q * scale`` and k,
    softmax, probabilities cast to v's dtype, then ``@ v`` in that dtype."""
    with torch.autocast(q.device.type, enabled=False):
        attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        return torch.matmul(attn, v)


def _no_trivial_pool(kernel, stride):
    kernel, stride = tuple(kernel), tuple(stride)
    if kernel and math.prod(kernel) == 1 and math.prod(stride) == 1:
        return ()
    return kernel


class MultiScaleAttention(nn.Module):
    """Pooled multi-head attention on tokens of width ``dim``, ``dim_out``
    wide: qkv projection, conv pooling of q and of k, v, attention through
    K4 (``flash``) or the dense chain, output projection."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, qkv_bias: bool = False,
                 kernel_q: Sequence[int] = (), kernel_kv: Sequence[int] = (),
                 stride_q: Sequence[int] = (), stride_kv: Sequence[int] = (),
                 has_cls_embed: bool = True, flash: bool = False,
                 flash_native_dim_only: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dim_out = dim_out
        head_dim = dim_out // num_heads
        self.scale = head_dim ** -0.5
        self.kernel_q = _no_trivial_pool(kernel_q, stride_q)
        self.kernel_kv = _no_trivial_pool(kernel_kv, stride_kv)
        self.stride_q, self.stride_kv = tuple(stride_q), tuple(stride_kv)
        self.has_cls_embed = has_cls_embed
        self.flash = flash and not (flash_native_dim_only and head_dim > 128 and head_dim % 128)
        self.dtype = dtype
        self.qkv = dense(dim, 3 * dim_out, bias=qkv_bias, init=trunc02, bias_value=0.02)
        for name, kernel, stride in (("q", self.kernel_q, self.stride_q),
                                     ("k", self.kernel_kv, self.stride_kv),
                                     ("v", self.kernel_kv, self.stride_kv)):
            if not kernel:
                continue
            conv = nn.Conv3d(head_dim, head_dim, kernel, stride=stride,
                             padding=tuple(k // 2 for k in kernel), groups=head_dim, bias=False)
            conv.weight_init = lecun_normal_init
            self.add_module(f"pool_{name}", conv)
            self.add_module(f"norm_{name}", layer_norm(head_dim))
        self.proj = dense(dim_out, dim_out, init=trunc02, bias_value=0.02)

    def _pool(self, x, thw, name):
        kernel, stride = (self.kernel_q, self.stride_q) if name == "q" else (self.kernel_kv, self.stride_kv)
        return pool_tokens(x, thw, kernel, stride, self.has_cls_embed,
                           getattr(self, f"pool_{name}", None), getattr(self, f"norm_{name}", None))

    def forward(self, x: torch.Tensor, thw: Sequence[int], x_res: Optional[torch.Tensor] = None):
        """``x_res``: a residual stream to pool through the SAME pool_q conv and
        norm_q as q (MVIT.REV.RES_PATH 'conv'); when given, returns (out,
        q_shape, pooled residual), else (out, q_shape)."""
        b, n, _ = x.shape
        nh = self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, nh, -1).permute(2, 0, 3, 1, 4).unbind(0)

        res_pooled = None
        if x_res is not None:
            rc = x_res.shape[-1]
            r = x_res.reshape(b, n, nh, rc // nh).transpose(1, 2)
            r, _ = self._pool(r, thw, "q")
            res_pooled = r.transpose(1, 2).reshape(b, -1, rc)

        q, q_shape = self._pool(q, thw, "q")
        k, _ = self._pool(k, thw, "k")
        v, _ = self._pool(v, thw, "v")
        if self.dtype is not None:
            q, k, v = q.to(self.dtype), k.to(self.dtype), v.to(self.dtype)
        out = flash_mha(q, k, v, self.scale) if self.flash else dense_attention(q, k, v, self.scale)
        out = self.proj(out.transpose(1, 2).reshape(b, -1, self.dim_out))
        if x_res is not None:
            return out, q_shape, res_pooled
        return out, q_shape


class MultiScaleBlock(nn.Module):
    """norm1 -> attention (+ the residual max-pooled with kernel stride + 1
    where Q pools, projected when the width changes) -> norm2 -> MLP, each
    branch behind its own drop path; the keep masks come from the caller
    (``keeps`` = (attention's, MLP's))."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_path: float = 0.0,
                 kernel_q=(), kernel_kv=(), stride_q=(), stride_kv=(),
                 has_cls_embed: bool = True, flash: bool = False,
                 flash_native_dim_only: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride_q = tuple(stride_q)
        self.has_cls_embed = has_cls_embed
        self.norm1 = layer_norm(dim)
        self.attn = MultiScaleAttention(dim, dim, num_heads, qkv_bias, kernel_q, kernel_kv,
                                        stride_q, stride_kv, has_cls_embed, flash,
                                        flash_native_dim_only, dtype)
        if dim != dim_out:
            self.proj = dense(dim, dim_out, init=trunc02, bias_value=0.02)
        self.drop_path = DropPath(drop_path)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim_out)

    def forward(self, x: torch.Tensor, thw: Sequence[int], keeps=(None, None)):
        x_block, thw_new = self.attn(self.norm1(x), thw)
        stride = self.stride_q
        if stride and math.prod(stride) > 1:
            kernel = tuple(s + 1 if s > 1 else s for s in stride)
            x = pool_tokens(x[:, None], thw, kernel, stride, self.has_cls_embed)[0][:, 0]
        x = x + self.drop_path(x_block, keeps[0])
        x_norm2 = self.norm2(x)
        x_mlp = self.mlp(x_norm2)
        if hasattr(self, "proj"):
            x = self.proj(x_norm2)
        return x + self.drop_path(x_mlp, keeps[1]), thw_new
