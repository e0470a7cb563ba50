"""3D-ResNet internals (counterpart of ``advise_tpu/models/layers/resnet.py``):
the basic, bottleneck and X3D transforms, the residual block with
drop-connect, and the stage with its Nonlocal blocks, with TPU.REMAT as
``torch.utils.checkpoint`` per stage or per block.

Checkpointing recomputes the forward in the backward. The BN modules
record statistics instead of updating running buffers in place
(``layers/norm.py``), so the running statistics still move once per step.
Drop-connect's keep masks are drawn by the stage from the caller's
generator before any block runs, so a recomputation replays them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from advise_tpu_torch.models.layers.common import conv3d, draw_keep, msra_init, zeros_init
from advise_tpu_torch.models.layers.nonlocal_block import Nonlocal
from advise_tpu_torch.models.layers.operators import SE


class BasicTransform(nn.Module):
    """(tk x 3 x 3) -> (1 x 3 x 3); the stride sits on the first conv."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int,
                 stride: int, norm: Callable, dilation: int = 1,
                 zero_init_final_bn: bool = False,
                 zero_init_final_conv: bool = False):
        super().__init__()
        tk = temp_kernel_size
        self.a = conv3d(dim_in, dim_out, (tk, 3, 3), stride=(1, stride, stride),
                        padding=(tk // 2, 1, 1))
        self.a_bn = norm(dim_out)
        self.b = conv3d(dim_out, dim_out, (1, 3, 3), padding=(0, dilation, dilation),
                        dilation=(1, dilation, dilation),
                        init=zeros_init if zero_init_final_conv else msra_init)
        self.b_bn = norm(dim_out, zero_init_scale=zero_init_final_bn)

    def forward(self, x: torch.Tensor, views: int = 1) -> torch.Tensor:
        x = F.relu(self.a_bn(self.a(x), views))
        return self.b_bn(self.b(x), views)


class BottleneckTransform(nn.Module):
    """(tk x 1 x 1) -> (1 x 3 x 3) -> (1 x 1 x 1); the stride sits on the
    3x3 conv unless stride_1x1."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel_size: int, stride: int, norm: Callable,
                 num_groups: int = 1, stride_1x1: bool = False,
                 dilation: int = 1, zero_init_final_bn: bool = False,
                 zero_init_final_conv: bool = False):
        super().__init__()
        tk = temp_kernel_size
        s1, s3 = (stride, 1) if stride_1x1 else (1, stride)
        self.a = conv3d(dim_in, dim_inner, (tk, 1, 1), stride=(1, s1, s1),
                        padding=(tk // 2, 0, 0))
        self.a_bn = norm(dim_inner)
        self.b = conv3d(dim_inner, dim_inner, (1, 3, 3), stride=(1, s3, s3),
                        padding=(0, dilation, dilation),
                        dilation=(1, dilation, dilation), groups=num_groups)
        self.b_bn = norm(dim_inner)
        self.c = conv3d(dim_inner, dim_out, 1,
                        init=zeros_init if zero_init_final_conv else msra_init)
        self.c_bn = norm(dim_out, zero_init_scale=zero_init_final_bn)

    def forward(self, x: torch.Tensor, views: int = 1) -> torch.Tensor:
        x = F.relu(self.a_bn(self.a(x), views))
        x = F.relu(self.b_bn(self.b(x), views))
        return self.c_bn(self.c(x), views)


class X3DTransform(nn.Module):
    """X3D bottleneck: 1x1x1 -> channelwise (tk x 3 x 3) with the stride ->
    BN -> SE on even ``block_idx`` -> swish (or ReLU) -> 1x1x1 -> BN."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel_size: int, stride: int, norm: Callable,
                 se_ratio: float = 0.0625, swish_inner: bool = True,
                 block_idx: int = 0, dilation: int = 1,
                 zero_init_final_bn: bool = False,
                 zero_init_final_conv: bool = False):
        super().__init__()
        tk = temp_kernel_size
        self.a = conv3d(dim_in, dim_inner, 1)
        self.a_bn = norm(dim_inner)
        self.b = conv3d(dim_inner, dim_inner, (tk, 3, 3), stride=(1, stride, stride),
                        padding=(tk // 2, dilation, dilation),
                        dilation=(1, dilation, dilation), groups=dim_inner)
        self.b_bn = norm(dim_inner)
        self.se = SE(dim_inner, se_ratio) if se_ratio > 0.0 and block_idx % 2 == 0 else None
        self.swish_inner = swish_inner
        self.c = conv3d(dim_inner, dim_out, 1,
                        init=zeros_init if zero_init_final_conv else msra_init)
        self.c_bn = norm(dim_out, zero_init_scale=zero_init_final_bn)

    def forward(self, x: torch.Tensor, views: int = 1) -> torch.Tensor:
        x = F.relu(self.a_bn(self.a(x), views))
        x = self.b_bn(self.b(x), views)
        if self.se is not None:
            x = self.se(x)
        x = F.silu(x) if self.swish_inner else F.relu(x)
        return self.c_bn(self.c(x), views)


class ResBlock(nn.Module):
    """Residual block with a projection shortcut when the shape changes, and
    drop-connect on the branch in training: per sample, the branch divided
    by the keep probability where the given keep mask is set, else 0."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel_size: int, stride: int, norm: Callable,
                 trans_func_name: str = "bottleneck_transform",
                 num_groups: int = 1, stride_1x1: bool = False,
                 dilation: int = 1, drop_connect_rate: float = 0.0,
                 zero_init_final_bn: bool = False,
                 zero_init_final_conv: bool = False,
                 se_ratio: float = 0.0, block_idx: int = 0):
        super().__init__()
        self.drop_connect_rate = drop_connect_rate
        self.branch1 = None
        if dim_in != dim_out or stride != 1:
            self.branch1 = conv3d(dim_in, dim_out, 1, stride=(1, stride, stride))
            self.branch1_bn = norm(dim_out)
        final = dict(zero_init_final_bn=zero_init_final_bn,
                     zero_init_final_conv=zero_init_final_conv)
        if trans_func_name == "basic_transform":
            self.branch2 = BasicTransform(
                dim_in, dim_out, temp_kernel_size, stride, norm, dilation=dilation, **final)
        elif trans_func_name == "bottleneck_transform":
            self.branch2 = BottleneckTransform(
                dim_in, dim_out, dim_inner, temp_kernel_size, stride, norm,
                num_groups=num_groups, stride_1x1=stride_1x1, dilation=dilation, **final)
        elif trans_func_name == "x3d_transform":
            self.branch2 = X3DTransform(
                dim_in, dim_out, dim_inner, temp_kernel_size, stride, norm,
                se_ratio=se_ratio, block_idx=block_idx, dilation=dilation, **final)
        else:
            raise NotImplementedError(f"RESNET.TRANS_FUNC={trans_func_name}")

    def forward(self, x: torch.Tensor, views: int = 1,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep`` [B] bool: drop-connect's mask (:func:`draw_keep`), None
        outside training or at rate 0."""
        shortcut = x
        if self.branch1 is not None:
            shortcut = self.branch1_bn(self.branch1(x), views)
        out = self.branch2(x, views)
        if keep is not None and self.drop_connect_rate > 0.0:
            shape = (out.shape[0],) + (1,) * (out.ndim - 1)
            zero = torch.zeros((), dtype=out.dtype, device=out.device)
            out = torch.where(keep.to(out.device).view(shape),
                              out / (1.0 - self.drop_connect_rate), zero)
        return F.relu(shortcut + out)


def _maybe_checkpoint(fn, *args, on: bool):
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class ResStage(nn.Module):
    """One stage of p pathways x n blocks; per-pathway hyperparameters come
    as lists. A Nonlocal block (``pathway{p}_nonlocal{i}``, inner width
    dim_out // 2) follows each block i of ``nonlocal_inds[p]``. ``remat`` is
    None, 'stage' or 'block' (models/utils.py); under 'block' the Nonlocal
    blocks run outside the blocks' checkpoints, as in the JAX stage."""

    def __init__(self, dim_in: Sequence[int], dim_out: Sequence[int],
                 dim_inner: Sequence[int],
                 temp_kernel_sizes: Sequence[Sequence[int]],
                 stride: Sequence[int], num_blocks: Sequence[int],
                 num_groups: Sequence[int],
                 num_block_temp_kernel: Sequence[int], norm: Callable,
                 nonlocal_inds: Sequence[Sequence[int]] = ((),),
                 nonlocal_group: Sequence[int] = (1,),
                 nonlocal_pool=None, instantiation: str = "softmax",
                 trans_func_name: str = "bottleneck_transform",
                 stride_1x1: bool = False, dilation: Sequence[int] = (1,),
                 drop_connect_rate: float = 0.0,
                 zero_init_final_bn: bool = False,
                 zero_init_final_conv: bool = False,
                 remat: Optional[str] = None):
        super().__init__()
        self.num_blocks = list(num_blocks)
        self.remat = remat
        self.drop_connect_rate = drop_connect_rate
        self.nonlocal_inds = [tuple(inds) for inds in nonlocal_inds]
        for p in range(len(num_blocks)):
            # cycle the kernel basis; blocks past num_block_temp_kernel use 1
            tks = (list(temp_kernel_sizes[p]) * num_blocks[p])[
                : num_block_temp_kernel[p]
            ] + [1] * (num_blocks[p] - num_block_temp_kernel[p])
            for i in range(num_blocks[p]):
                self.add_module(f"pathway{p}_res{i}", ResBlock(
                    dim_in[p] if i == 0 else dim_out[p], dim_out[p],
                    dim_inner[p], tks[i], stride[p] if i == 0 else 1, norm,
                    trans_func_name=trans_func_name,
                    num_groups=num_groups[p], stride_1x1=stride_1x1,
                    dilation=dilation[p],
                    drop_connect_rate=drop_connect_rate,
                    zero_init_final_bn=zero_init_final_bn,
                    zero_init_final_conv=zero_init_final_conv,
                    se_ratio=0.0625 if trans_func_name == "x3d_transform" else 0.0,
                    block_idx=i,
                ))
                if i in self.nonlocal_inds[p]:
                    self.add_module(f"pathway{p}_nonlocal{i}", Nonlocal(
                        dim_out[p], dim_out[p] // 2, norm,
                        pool_size=nonlocal_pool[p] if nonlocal_pool is not None else None,
                        instantiation=instantiation, group_size=nonlocal_group[p],
                    ))

    def draw_keeps(self, inputs: Sequence[torch.Tensor],
                   generator: Optional[torch.Generator]) -> List[List[Optional[torch.Tensor]]]:
        """Drop-connect's keep masks of this forward, per pathway and block,
        in block order; None outside training or at rate 0."""
        if not (self.training and self.drop_connect_rate > 0.0):
            return [[None] * n for n in self.num_blocks]
        return [[draw_keep(x.shape[0], self.drop_connect_rate, generator) for _ in range(n)]
                for x, n in zip(inputs, self.num_blocks)]

    def _run(self, views: int, keeps, *inputs):
        outputs = []
        for p, x in enumerate(inputs):
            for i in range(self.num_blocks[p]):
                block = getattr(self, f"pathway{p}_res{i}")
                x = _maybe_checkpoint(block, x, views, keeps[p][i], on=self.remat == "block")
                if i in self.nonlocal_inds[p]:
                    x = getattr(self, f"pathway{p}_nonlocal{i}")(x, views)
            outputs.append(x)
        return outputs

    def forward(self, inputs: Sequence[torch.Tensor], views: int = 1,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws drop-connect's masks in training."""
        keeps = self.draw_keeps(inputs, generator)
        return _maybe_checkpoint(self._run, views, keeps, *inputs, on=self.remat == "stage")
