"""Single-pathway 3D ResNet: Slow / C2D / I3D / slow_c2d (counterpart of
``advise_tpu/models/resnet3d.py``).

The model takes clips ``[B, T, H, W, C]`` (NDHWC, the JAX layout); inside,
tensors are NCDHW views of channels-last memory. The submodules carry the
Flax names (``s1`` ... ``s5``, ``head``), so the param bridge maps a Flax
tree onto this module's ``state_dict``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.layers.heads import ResNetBasicHead
from advise_tpu_torch.models.layers.norm import head_sync_axes
from advise_tpu_torch.models.layers.resnet import ResStage
from advise_tpu_torch.models.layers.stem import ResNetBasicStem
from advise_tpu_torch.models.slowfast import MODEL_STAGE_DEPTH
from advise_tpu_torch.models.utils import stage_remat

# reference video_model_builder.py:41-99 (single-pathway entries)
TEMPORAL_KERNEL_BASIS = {
    "2d": [[1], [1], [1], [1], [1]],
    "c2d": [[1], [1], [1], [1], [1]],
    "slow_c2d": [[1], [1], [1], [1], [1]],
    "i3d": [[5], [3], [3, 1], [3, 1], [1, 3]],
    "slow_i3d": [[5], [3], [3, 1], [3, 1], [1, 3]],
    "slow": [[1], [1], [1], [3], [3]],
    "x3d": [[5], [3], [3], [3], [3]],
}

# reference video_model_builder.py:102-109 (temporal pool after s2)
POOL1 = {
    "2d": (1, 1, 1),
    "c2d": (2, 1, 1),
    "slow_c2d": (1, 1, 1),
    "i3d": (2, 1, 1),
    "slow_i3d": (1, 1, 1),
    "slow": (1, 1, 1),
    "x3d": (1, 1, 1),
}


class ResNet3D(nn.Module):
    """cfg-driven single-pathway 3D ResNet. ``forward`` returns the head's
    output (logits, or [projection, *predictions] with CONTRASTIVE
    predictors), or with ``include_head=False`` the s5 features [B, T, H, W,
    C]."""

    def __init__(self, cfg, norm: Callable, dtype: Optional[torch.dtype] = None,
                 include_head: bool = True):
        super().__init__()
        arch = cfg.MODEL.ARCH.lower()
        if arch not in TEMPORAL_KERNEL_BASIS:
            raise ValueError(f"MODEL.ARCH={cfg.MODEL.ARCH} is not a single-pathway ResNet")
        depths = MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]
        num_groups = cfg.RESNET.NUM_GROUPS
        width = cfg.RESNET.WIDTH_PER_GROUP
        dim_inner = num_groups * width
        tk = TEMPORAL_KERNEL_BASIS[arch]
        self.pool1 = POOL1[arch]
        self.include_head = include_head

        # the JAX ResNet3D never routes its stem through the stem kernel
        self.s1 = ResNetBasicStem(cfg.DATA.INPUT_CHANNEL_NUM[0], width, tk[0][0], norm,
                                  kernel=False, dtype=dtype)
        remat = stage_remat(cfg)
        for si in range(4):
            self.add_module(f"s{si + 2}", ResStage(
                dim_in=[width if si == 0 else width * 4 * 2 ** (si - 1)],
                dim_out=[width * 4 * 2 ** si],
                dim_inner=[dim_inner * 2 ** si],
                temp_kernel_sizes=[tk[si + 1]],
                stride=[cfg.RESNET.SPATIAL_STRIDES[si][0]],
                num_blocks=[depths[si]],
                num_groups=[num_groups],
                num_block_temp_kernel=[cfg.RESNET.NUM_BLOCK_TEMP_KERNEL[si][0]],
                norm=norm,
                nonlocal_inds=[tuple(cfg.NONLOCAL.LOCATION[si][0])],
                nonlocal_group=[cfg.NONLOCAL.GROUP[si][0]],
                nonlocal_pool=[cfg.NONLOCAL.POOL[si][0]],
                instantiation=cfg.NONLOCAL.INSTANTIATION,
                trans_func_name=cfg.RESNET.TRANS_FUNC,
                stride_1x1=cfg.RESNET.STRIDE_1X1,
                dilation=[cfg.RESNET.SPATIAL_DILATIONS[si][0]],
                zero_init_final_bn=cfg.RESNET.ZERO_INIT_FINAL_BN,
                zero_init_final_conv=cfg.RESNET.ZERO_INIT_FINAL_CONV,
                remat=remat,
            ))
        if not include_head:
            return
        contrastive = cfg.MODEL.MODEL_NAME == "ContrastiveModel"
        self.head = ResNetBasicHead(
            dim_in=width * 32,
            num_classes=cfg.CONTRASTIVE.DIM if contrastive else cfg.MODEL.NUM_CLASSES,
            dropout_rate=cfg.MODEL.DROPOUT_RATE,
            act_func=cfg.MODEL.HEAD_ACT,
            detach_final_fc=cfg.MODEL.DETACH_FINAL_FC,
            l2norm=cfg.SSL.HEAD_L2_NORM,
            num_mlp_layers=(
                cfg.CONTRASTIVE.NUM_MLP_LAYERS if contrastive else cfg.SSL.NUM_MLP_LAYERS
            ),
            mlp_dim=cfg.CONTRASTIVE.MLP_DIM if contrastive else cfg.SSL.MLP_DIM,
            bn_mlp=cfg.CONTRASTIVE.BN_MLP if contrastive else cfg.SSL.BN_MLP,
            predictor_depths=(
                tuple(cfg.CONTRASTIVE.PREDICTOR_DEPTHS) if contrastive else ()
            ),
            predictor_mlp_dim=cfg.CONTRASTIVE.MLP_DIM,
            predictor_bn=cfg.CONTRASTIVE.BN_MLP,
            fc_init_std=cfg.MODEL.FC_INIT_STD,
            bn_sync_axes=head_sync_axes(
                norm, cfg.CONTRASTIVE.BN_SYNC_MLP if contrastive else cfg.SSL.BN_SYNC_MLP),
        )

    def forward(self, x: torch.Tensor, views: int = 1,
                generator: Optional[torch.Generator] = None):
        """x [V*B, T, H, W, C] (views stacked view-major; BN statistics are
        taken per view). ``generator`` draws the head's dropout mask in
        training."""
        x = self.s1(x.permute(0, 4, 1, 2, 3), views)
        for si in range(4):
            (x,) = getattr(self, f"s{si + 2}")([x], views)
            if si == 0 and any(p > 1 for p in self.pool1):
                x = F.max_pool3d(x, self.pool1, self.pool1)
        if not self.include_head:
            return x.permute(0, 2, 3, 4, 1)
        return self.head([x], views, generator)
