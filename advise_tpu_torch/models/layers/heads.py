"""Heads (counterpart of ``advise_tpu/models/layers/heads.py``): the MLP
projector (with or without BN), the BYOL predictor stack on the ResNet
basic head and on the X3D head, and the transformer head (linear, or the
contrastive MLP projector)."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.layers.common import conv3d, dense, dropout, fc_init, lecun_normal_init
from advise_tpu_torch.models.layers.norm import SyncBatchNorm


class MLPHead(nn.Module):
    """[Linear -> BN -> ReLU] x (n-1) -> Linear, Xavier-uniform init; the
    hidden Linears drop their bias when BN follows them; the BN syncs over
    ``sync_axes``."""

    def __init__(self, dim_in: int, dim_out: int, mlp_dim: int,
                 num_layers: int, bn_on: bool = False, use_bias: bool = True,
                 sync_axes: Tuple[str, ...] = ()):
        super().__init__()
        self.num_layers = num_layers
        self.bn_on = bn_on
        dim = dim_in
        for i in range(num_layers - 1):
            self.add_module(f"fc{i}", dense(dim, mlp_dim, bias=use_bias and not bn_on))
            if bn_on:
                self.add_module(f"bn{i}", SyncBatchNorm(mlp_dim, sync_axes=sync_axes))
            dim = mlp_dim
        self.add_module(f"fc{num_layers - 1}", dense(dim, dim_out, bias=use_bias))

    def forward(self, x: torch.Tensor, views: int = 1) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = getattr(self, f"fc{i}")(x)
            if self.bn_on:
                x = getattr(self, f"bn{i}")(x, views)
            x = F.relu(x)
        return getattr(self, f"fc{self.num_layers - 1}")(x)


class ResNetBasicHead(nn.Module):
    """Global average pool of each pathway -> concat -> dropout (training
    only) -> projection (linear or MLP) -> BYOL predictors. In training it
    returns [proj, pred, ...] when predictors exist, else the projection."""

    def __init__(self, dim_in: int, num_classes: int,
                 dropout_rate: float = 0.0, act_func: str = "softmax",
                 detach_final_fc: bool = False, l2norm: bool = False,
                 num_mlp_layers: int = 1, mlp_dim: int = 2048,
                 bn_mlp: bool = False, predictor_depths: Sequence[int] = (),
                 predictor_mlp_dim: int = 2048, predictor_bn: bool = False,
                 fc_init_std: float = 0.01, bn_sync_axes: Tuple[str, ...] = ()):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.detach_final_fc = detach_final_fc
        self.l2norm = l2norm
        if num_mlp_layers == 1:
            self.projection = dense(dim_in, num_classes, init=fc_init(fc_init_std))
        else:
            self.projection = MLPHead(dim_in, num_classes, mlp_dim,
                                      num_mlp_layers, bn_on=bn_mlp, sync_axes=bn_sync_axes)
        self.num_predictors = len(predictor_depths)
        for i, depth in enumerate(predictor_depths):
            self.add_module(f"predictor{i}", MLPHead(
                num_classes, num_classes, predictor_mlp_dim, depth,
                bn_on=predictor_bn, sync_axes=bn_sync_axes,
            ))

    def forward(self, inputs: Sequence[torch.Tensor], views: int = 1,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout mask in training (MODEL.DROPOUT_RATE
        > 0); it is not read otherwise."""
        pooled = [v.mean(dim=(2, 3, 4)) for v in inputs]  # NCDHW -> [B, C]
        x = torch.cat(pooled, dim=-1) if len(pooled) > 1 else pooled[0]
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, generator)
        if self.detach_final_fc:
            x = x.detach()
        if self.l2norm:
            x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        if isinstance(self.projection, MLPHead):
            x = self.projection(x, views)
        else:
            x = self.projection(x)
        outputs: List[torch.Tensor] = [x]
        for i in range(self.num_predictors):
            x = getattr(self, f"predictor{i}")(x, views)
            outputs.append(x)
        out = outputs[-1] if len(outputs) == 1 else outputs
        if not self.training and self.act_func != "none" and len(outputs) == 1:
            if self.act_func == "softmax":
                out = torch.softmax(out, dim=-1)
            elif self.act_func == "sigmoid":
                out = torch.sigmoid(out)
            else:
                raise NotImplementedError(self.act_func)
        return out


class X3DHead(nn.Module):
    """conv_5 (1x1x1 expansion to ``dim_inner``) -> BN -> ReLU -> mean over
    (T, H, W) -> lin_5 (1x1x1 to ``dim_out``) -> BN with ``bn_lin5_on`` ->
    ReLU -> dropout (training only) -> the projection: a Linear with
    normal(0, 0.01), or with ``num_mlp_layers`` > 1 the MLPHead stack, then
    the BYOL predictors. With predictors it returns [proj, pred, ...];
    otherwise the projection, softmaxed in evaluation when ``act_func`` says
    so. conv_5 and lin_5 take Flax's default init."""

    def __init__(self, dim_in: int, dim_inner: int, dim_out: int, num_classes: int,
                 norm: Callable, dropout_rate: float = 0.0, act_func: str = "softmax",
                 bn_lin5_on: bool = False, num_mlp_layers: int = 1, mlp_dim: int = 2048,
                 bn_mlp: bool = False, predictor_depths: Sequence[int] = (),
                 predictor_mlp_dim: int = 2048, predictor_bn: bool = False,
                 bn_sync_axes: Tuple[str, ...] = ()):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.conv_5 = conv3d(dim_in, dim_inner, 1, init=lecun_normal_init)
        self.conv_5_bn = norm(dim_inner)
        self.lin_5 = conv3d(dim_inner, dim_out, 1, init=lecun_normal_init)
        self.lin_5_bn = norm(dim_out) if bn_lin5_on else None
        if num_mlp_layers == 1:
            self.projection = dense(dim_out, num_classes, init=fc_init(0.01))
        else:
            self.projection = MLPHead(dim_out, num_classes, mlp_dim, num_mlp_layers, bn_on=bn_mlp,
                                      sync_axes=bn_sync_axes)
        self.num_predictors = len(predictor_depths)
        for i, depth in enumerate(predictor_depths):
            self.add_module(f"predictor{i}", MLPHead(
                num_classes, num_classes, predictor_mlp_dim, depth, bn_on=predictor_bn,
                sync_axes=bn_sync_axes))

    def forward(self, inputs: Sequence[torch.Tensor], views: int = 1,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout mask in training (rate > 0)."""
        x = F.relu(self.conv_5_bn(self.conv_5(inputs[0]), views))
        x = self.lin_5(x.mean(dim=(2, 3, 4), keepdim=True))
        if self.lin_5_bn is not None:
            x = self.lin_5_bn(x, views)
        x = F.relu(x).flatten(1)
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, generator)
        x = self.projection(x, views) if isinstance(self.projection, MLPHead) else self.projection(x)
        outputs: List[torch.Tensor] = [x]
        for i in range(self.num_predictors):
            x = getattr(self, f"predictor{i}")(x, views)
            outputs.append(x)
        if len(outputs) > 1:
            return outputs
        if not self.training and self.act_func == "softmax":
            x = torch.softmax(x, dim=-1)
        return x


class TransformerBasicHead(nn.Module):
    """The transformer head on pooled features: dropout (training only) ->
    the projection -> softmax in evaluation when ``act_func`` says so. The
    projection is a Linear (normal(0, 0.01), zero bias) with
    ``num_mlp_layers`` 1 (its initial weight times ``head_init_scale``,
    MVIT.HEAD_INIT_SCALE), else the contrastive MLPHead (``mlp_dim`` wide,
    BN with ``bn_mlp``, per view)."""

    def __init__(self, dim_in: int, num_classes: int, dropout_rate: float = 0.0,
                 act_func: str = "softmax", detach_final_fc: bool = False,
                 num_mlp_layers: int = 1, mlp_dim: int = 2048, bn_mlp: bool = False,
                 head_init_scale: float = 1.0, bn_sync_axes: Tuple[str, ...] = ()):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.detach_final_fc = detach_final_fc
        if num_mlp_layers == 1:
            init = fc_init(0.01)
            if head_init_scale != 1.0:
                def init(w, generator, _base=init):
                    _base(w, generator)
                    w.mul_(head_init_scale)
            self.projection = dense(dim_in, num_classes, init=init)
        else:
            self.projection = MLPHead(dim_in, num_classes, mlp_dim, num_mlp_layers, bn_on=bn_mlp,
                                      sync_axes=bn_sync_axes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                views: int = 1) -> torch.Tensor:
        """``generator`` draws the dropout mask in training; ``views`` splits
        the MLP's BN statistics."""
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, generator)
        if self.detach_final_fc:
            x = x.detach()
        if isinstance(self.projection, MLPHead):
            x = self.projection(x, views)
        else:
            x = self.projection(x)
        if not self.training and self.act_func == "softmax":
            x = torch.softmax(x, dim=-1)
        return x
