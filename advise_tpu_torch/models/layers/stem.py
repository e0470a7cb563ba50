"""The ResNet basic stem, X3D's stem and MViT's PatchEmbed (counterpart of
``advise_tpu/models/layers/stem.py`` ResNetBasicStem with the
SpaceToDepthStemConv routing, X3DStem and PatchEmbed).

Tensors inside the model are NCDHW in shape with a channels-last
(NDHWC) memory layout, so the stem kernel reads and writes its NDHWC
operands as views, without transposes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.layers.common import conv3d, lecun_normal_init
from advise_tpu_torch.ops.stem_conv import (
    kernel_eligible,
    stem_conv_chunked,
    stem_conv_wgrad_only,
)


class ResNetBasicStem(nn.Module):
    """conv(t,7,7)/s(1,2,2) -> BN -> ReLU -> maxpool(1,3,3)/s(1,2,2).

    ``kernel`` (TPU.PALLAS_STEM) routes the conv through the stem kernel
    (``ops/stem_conv.py``) in ``dtype`` when the shape is one the kernel
    takes (3 -> 8 channels: the SlowFast fast stem); the slow stem stays a
    plain conv, as in the JAX package. With the kernel, ``wgrad_only``
    (TPU.PALLAS_STEM_WGRAD_ONLY) takes the dense forward and the kernel
    weight gradient, else ``chunk`` > 0 (TPU.PALLAS_STEM_CHUNK) launches
    both kernels per batch chunk, in that order of precedence
    (advise_tpu/models/layers/stem.py:135-142); without it both are inert.
    The weight keeps the plain conv's parameter either way."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel: int,
                 norm: Callable, kernel: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 wgrad_only: bool = False, chunk: int = 0):
        super().__init__()
        self.conv = conv3d(
            dim_in, dim_out, (temp_kernel, 7, 7), stride=(1, 2, 2),
            padding=(temp_kernel // 2, 3, 3),
        )
        self.bn = norm(dim_out)
        self.kernel = kernel and kernel_eligible(dim_in, dim_out)
        self.dtype = dtype
        self.wgrad_only = wgrad_only
        self.chunk = int(chunk)

    def forward(self, x: torch.Tensor, views: int = 1) -> torch.Tensor:
        if self.kernel:
            w = self.conv.weight.permute(2, 3, 4, 1, 0)  # [kt,7,7,C,F]
            x_ndhwc, dtype = x.permute(0, 2, 3, 4, 1), self.dtype or x.dtype
            if self.wgrad_only:
                y = stem_conv_wgrad_only(x_ndhwc, w, dtype)
            else:
                y = stem_conv_chunked(x_ndhwc, w, dtype, self.chunk)
            x = y.permute(0, 4, 1, 2, 3)
        else:
            x = self.conv(x)
        x = F.relu(self.bn(x, views))
        return F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class X3DStem(nn.Module):
    """Channel-separated stem: a (1,3,3)/s(1,2,2) conv ``conv_xy``, then a
    depthwise (t,1,1) conv ``conv`` (groups = channels), BN, ReLU."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel: int, norm: Callable):
        super().__init__()
        self.conv_xy = conv3d(dim_in, dim_out, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
        self.conv = conv3d(dim_out, dim_out, (temp_kernel, 1, 1),
                           padding=(temp_kernel // 2, 0, 0), groups=dim_out)
        self.bn = norm(dim_out)

    def forward(self, x: torch.Tensor, views: int = 1) -> torch.Tensor:
        return F.relu(self.bn(self.conv(self.conv_xy(x)), views))


class PatchEmbed(nn.Module):
    """MViT's conv patchify: a (kt, kh, kw) conv with bias, 3 -> ``dim_out``
    channels (a cuDNN conv, as the JAX package leaves it to XLA), flattened
    to tokens. Takes clips [B, T, H, W, 3] and returns ([B, t*h*w, C],
    (t, h, w))."""

    def __init__(self, dim_in: int, dim_out: int, kernel, stride, padding):
        super().__init__()
        self.proj = nn.Conv3d(dim_in, dim_out, tuple(kernel), stride=tuple(stride),
                              padding=tuple(padding))
        self.proj.weight_init = lecun_normal_init

    def forward(self, x: torch.Tensor):
        x = self.proj(x.permute(0, 4, 1, 2, 3))
        b, c, t, h, w = x.shape
        return x.permute(0, 2, 3, 4, 1).reshape(b, t * h * w, c), (t, h, w)
