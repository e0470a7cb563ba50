"""X3D (counterpart of ``advise_tpu/models/x3d.py``): the channel-separated
stem, four stages of X3D bottlenecks (channelwise 3x3x3 convs, SE on every
other block, swish) widened by ``round_width`` and deepened by
X3D.DEPTH_FACTOR, and the X3D head.

The model takes clips ``[B, T, H, W, C]`` (NDHWC, the JAX layout); inside,
tensors are NCDHW views of channels-last memory. The submodules carry the
Flax names (``s1`` ... ``s5``, ``head``), so the param bridge maps a Flax
tree onto this module's ``state_dict``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from advise_tpu_torch.models.layers.heads import X3DHead
from advise_tpu_torch.models.layers.norm import head_sync_axes
from advise_tpu_torch.models.layers.resnet import ResStage
from advise_tpu_torch.models.layers.stem import X3DStem
from advise_tpu_torch.models.utils import round_width, stage_remat

# the temporal kernel basis of X3D, stem first
X3D_TEMP_KERNELS = [[5], [3], [3], [3], [3]]


class X3D(nn.Module):
    """cfg-driven X3D. ``forward`` returns the head's output (logits, or
    [projection, *predictions] for ContrastiveModel with predictors), or with
    ``include_head=False`` the s5 features [B, T, H, W, C]. Stage s (0-3)
    drops its blocks' branches at MODEL.DROPCONNECT_RATE * (s + 2) / 5 in
    training, as the JAX model does."""

    def __init__(self, cfg, norm: Callable, dtype: Optional[torch.dtype] = None,
                 include_head: bool = True):
        super().__init__()
        exp_stage = 2.0
        dim_c1 = cfg.X3D.DIM_C1
        dim_res2 = round_width(dim_c1, exp_stage, divisor=8) if cfg.X3D.SCALE_RES2 else dim_c1
        dim_res3 = round_width(dim_res2, exp_stage, divisor=8)
        dim_res4 = round_width(dim_res3, exp_stage, divisor=8)
        dim_res5 = round_width(dim_res4, exp_stage, divisor=8)
        block_basis = [(1, dim_res2, 2), (2, dim_res3, 2), (5, dim_res4, 2), (3, dim_res5, 2)]
        w_mul, d_mul = cfg.X3D.WIDTH_FACTOR, cfg.X3D.DEPTH_FACTOR
        dim_res1 = round_width(dim_c1, w_mul)
        self.include_head = include_head

        self.s1 = X3DStem(cfg.DATA.INPUT_CHANNEL_NUM[0], dim_res1, X3D_TEMP_KERNELS[0][0], norm)
        remat = stage_remat(cfg)
        dim_in = dim_res1
        for stage, (blocks, c, stride) in enumerate(block_basis):
            dim_out = round_width(c, w_mul)
            dim_inner = int(cfg.X3D.BOTTLENECK_FACTOR * dim_out)
            n_rep = int(math.ceil(d_mul * blocks))
            self.add_module(f"s{stage + 2}", ResStage(
                dim_in=[dim_in], dim_out=[dim_out], dim_inner=[dim_inner],
                temp_kernel_sizes=[X3D_TEMP_KERNELS[1]], stride=[stride],
                num_blocks=[n_rep],
                num_groups=[dim_inner] if cfg.X3D.CHANNELWISE_3x3x3 else [cfg.RESNET.NUM_GROUPS],
                num_block_temp_kernel=[n_rep], norm=norm,
                # the JAX model reads the first stage's entries for every stage
                nonlocal_inds=[tuple(cfg.NONLOCAL.LOCATION[0][0])],
                nonlocal_group=[cfg.NONLOCAL.GROUP[0][0]],
                nonlocal_pool=[cfg.NONLOCAL.POOL[0][0]],
                instantiation=cfg.NONLOCAL.INSTANTIATION,
                trans_func_name="x3d_transform", stride_1x1=cfg.RESNET.STRIDE_1X1,
                dilation=[cfg.RESNET.SPATIAL_DILATIONS[stage][0]],
                drop_connect_rate=cfg.MODEL.DROPCONNECT_RATE * (stage + 2) / (len(block_basis) + 1),
                zero_init_final_bn=cfg.RESNET.ZERO_INIT_FINAL_BN,
                zero_init_final_conv=cfg.RESNET.ZERO_INIT_FINAL_CONV,
                remat=remat,
            ))
            dim_in = dim_out
        if not include_head:
            return
        contrastive = cfg.MODEL.MODEL_NAME == "ContrastiveModel"
        self.head = X3DHead(
            dim_in=dim_out, dim_inner=dim_inner, dim_out=cfg.X3D.DIM_C5,
            num_classes=cfg.CONTRASTIVE.DIM if contrastive else cfg.MODEL.NUM_CLASSES,
            norm=norm, dropout_rate=cfg.MODEL.DROPOUT_RATE, act_func=cfg.MODEL.HEAD_ACT,
            bn_lin5_on=cfg.X3D.BN_LIN5,
            num_mlp_layers=cfg.CONTRASTIVE.NUM_MLP_LAYERS if contrastive else 1,
            mlp_dim=cfg.CONTRASTIVE.MLP_DIM,
            bn_mlp=cfg.CONTRASTIVE.BN_MLP if contrastive else False,
            predictor_depths=tuple(cfg.CONTRASTIVE.PREDICTOR_DEPTHS) if contrastive else (),
            predictor_mlp_dim=cfg.CONTRASTIVE.MLP_DIM,
            predictor_bn=cfg.CONTRASTIVE.BN_MLP if contrastive else False,
            bn_sync_axes=head_sync_axes(norm, contrastive and cfg.CONTRASTIVE.BN_SYNC_MLP),
        )

    def forward(self, x: torch.Tensor, views: int = 1,
                generator: Optional[torch.Generator] = None):
        """x [V*B, T, H, W, C] (views stacked view-major; BN statistics are
        taken per view). ``generator`` draws drop-connect's masks and the
        head's dropout mask in training."""
        x = self.s1(x.permute(0, 4, 1, 2, 3), views)
        for si in range(4):
            (x,) = getattr(self, f"s{si + 2}")([x], views, generator)
        if not self.include_head:
            return x.permute(0, 2, 3, 4, 1)
        return self.head([x], views, generator)
