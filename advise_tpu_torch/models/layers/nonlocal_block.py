"""Non-local block (counterpart of ``advise_tpu/models/layers/nonlocal_block.py``):
self-attention over the (T, H, W) grid, embedded-gaussian ('softmax') or
'dot_product', with an optional VALID max-pool of the keys and values, an
optional fold of temporal groups into the batch, and a zero-initialized
output BN, so that the block starts as the identity.

As in the JAX module, the query-key scores are float32 whatever the
activations' dtype (``preferred_element_type``), and the attention weights
are cast to the values' dtype before the second product.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.layers.common import msra_init


def _conv1(dim_in: int, dim_out: int) -> nn.Conv3d:
    """A 1x1x1 conv with a zero bias and an MSRA weight."""
    conv = nn.Conv3d(dim_in, dim_out, 1)
    conv.weight_init = msra_init
    return conv


class Nonlocal(nn.Module):
    def __init__(self, dim: int, dim_inner: int, norm: Callable,
                 pool_size: Optional[Sequence[int]] = None,
                 instantiation: str = "softmax", group_size: int = 1):
        super().__init__()
        if instantiation not in ("softmax", "dot_product"):
            raise NotImplementedError(instantiation)
        self.dim_inner = dim_inner
        self.pool = (tuple(pool_size) if pool_size is not None and any(s > 1 for s in pool_size)
                     else None)
        self.instantiation = instantiation
        self.group_size = group_size
        self.theta = _conv1(dim, dim_inner)
        self.phi = _conv1(dim, dim_inner)
        self.g = _conv1(dim, dim_inner)
        self.out = _conv1(dim_inner, dim)
        self.out_bn = norm(dim, zero_init_scale=True)

    def forward(self, x: torch.Tensor, views: int = 1) -> torch.Tensor:
        """x [B, C, T, H, W] -> the same shape, x plus the attention's output."""
        b, c, t, h, w = x.shape
        res = x
        g = self.group_size
        if g > 1:  # time (g, t // g), groups folded into the batch
            x = x.reshape(b, c, g, t // g, h, w).transpose(1, 2).reshape(b * g, c, t // g, h, w)
        kv = F.max_pool3d(x, self.pool, self.pool) if self.pool is not None else x
        bb, d = x.shape[0], self.dim_inner

        def tokens(y):  # [bb, d, t, h, w] -> [bb, t*h*w, d]
            return y.flatten(2).transpose(1, 2)

        q, k, v = tokens(self.theta(x)), tokens(self.phi(kv)), tokens(self.g(kv))
        with torch.autocast(x.device.type, enabled=False):
            attn = torch.bmm(q.float(), k.float().transpose(1, 2))
            if self.instantiation == "softmax":
                attn = torch.softmax(attn * (d ** -0.5), dim=-1)
            else:
                attn = attn / attn.shape[-1]
        out = torch.bmm(attn.to(v.dtype), v)  # [bb, t*h*w, d]
        out = out.transpose(1, 2).reshape(bb, d, *x.shape[2:])
        out = self.out_bn(self.out(out), views)
        if g > 1:
            out = out.reshape(b, g, c, t // g, h, w).transpose(1, 2).reshape(b, c, t, h, w)
        return res + out
