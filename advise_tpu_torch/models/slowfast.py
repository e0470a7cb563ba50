"""SlowFast two-pathway network (counterpart of
``advise_tpu/models/slowfast.py``).

The model takes ONE clip ``[B, T_fast, H, W, C]`` (NDHWC, the JAX layout)
and derives the slow pathway inside by taking every ALPHA-th frame. Inside,
tensors are NCDHW views of channels-last memory.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.layers.common import conv3d
from advise_tpu_torch.models.layers.heads import ResNetBasicHead
from advise_tpu_torch.models.layers.norm import head_sync_axes
from advise_tpu_torch.models.layers.resnet import ResStage
from advise_tpu_torch.models.layers.stem import ResNetBasicStem
from advise_tpu_torch.models.utils import stage_remat

# reference video_model_builder.py:89-96 'slowfast' temporal kernel basis
SLOWFAST_TEMP_KERNELS = [
    ([1], [5]),  # conv1 (slow, fast)
    ([1], [3]),  # res2
    ([1], [3]),  # res3
    ([3], [3]),  # res4
    ([3], [3]),  # res5
]

# reference video_model_builder.py:38; depth 10 is the CPU-test extension
MODEL_STAGE_DEPTH = {
    10: (1, 1, 1, 1),
    18: (2, 2, 2, 2),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


class FuseFastToSlow(nn.Module):
    """Strided temporal conv from fast to slow, concatenated on channels."""

    def __init__(self, dim_in: int, fusion_conv_channel_ratio: int,
                 fusion_kernel: int, alpha: int, norm: Callable):
        super().__init__()
        self.conv_f2s = conv3d(
            dim_in, dim_in * fusion_conv_channel_ratio, (fusion_kernel, 1, 1),
            stride=(alpha, 1, 1), padding=(fusion_kernel // 2, 0, 0),
        )
        self.bn = norm(dim_in * fusion_conv_channel_ratio)

    def forward(self, x_s, x_f, views: int = 1):
        fuse = F.relu(self.bn(self.conv_f2s(x_f), views))
        return torch.cat([x_s, fuse], dim=1), x_f


class SlowFast(nn.Module):
    def __init__(self, cfg, norm: Callable, dtype: Optional[torch.dtype] = None):
        super().__init__()
        alpha = cfg.SLOWFAST.ALPHA
        beta_inv = cfg.SLOWFAST.BETA_INV
        fuse_ratio = cfg.SLOWFAST.FUSION_CONV_CHANNEL_RATIO
        fuse_k = cfg.SLOWFAST.FUSION_KERNEL_SZ
        out_dim_ratio = beta_inv // fuse_ratio
        self.alpha = alpha

        depths = MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]
        remat = stage_remat(cfg)
        num_groups = cfg.RESNET.NUM_GROUPS
        w = cfg.RESNET.WIDTH_PER_GROUP
        dim_inner = num_groups * w
        c_in = cfg.DATA.INPUT_CHANNEL_NUM[0]
        tk = SLOWFAST_TEMP_KERNELS

        self.s1_slow = ResNetBasicStem(c_in, w, tk[0][0][0], norm, dtype=dtype)
        self.s1_fast = ResNetBasicStem(
            c_in, w // beta_inv, tk[0][1][0], norm,
            kernel=bool(cfg.TPU.PALLAS_STEM), dtype=dtype,
            wgrad_only=bool(cfg.TPU.PALLAS_STEM_WGRAD_ONLY),
            chunk=int(cfg.TPU.PALLAS_STEM_CHUNK),
        )
        self.s1_fuse = FuseFastToSlow(w // beta_inv, fuse_ratio, fuse_k, alpha, norm)

        stage_dims = [
            # (slow_in_base, out_mult, inner_mult)
            (w, 4, 1),
            (w * 4, 8, 2),
            (w * 8, 16, 4),
            (w * 16, 32, 8),
        ]
        for si, (base_in, out_m, in_m) in enumerate(stage_dims):
            self.add_module(f"s{si + 2}", ResStage(
                dim_in=[base_in + base_in // out_dim_ratio, base_in // beta_inv],
                dim_out=[w * out_m, w * out_m // beta_inv],
                dim_inner=[dim_inner * in_m, dim_inner * in_m // beta_inv],
                temp_kernel_sizes=[tk[si + 1][0], tk[si + 1][1]],
                stride=[cfg.RESNET.SPATIAL_STRIDES[si][0]] * 2,
                num_blocks=[depths[si]] * 2,
                num_groups=[num_groups] * 2,
                num_block_temp_kernel=[cfg.RESNET.NUM_BLOCK_TEMP_KERNEL[si][0]] * 2,
                norm=norm,
                nonlocal_inds=[
                    tuple(cfg.NONLOCAL.LOCATION[si][0]),
                    tuple(cfg.NONLOCAL.LOCATION[si][1] if len(cfg.NONLOCAL.LOCATION[si]) > 1 else ()),
                ],
                nonlocal_group=[cfg.NONLOCAL.GROUP[si][0]] * 2,
                nonlocal_pool=[cfg.NONLOCAL.POOL[si][0]] * 2,
                instantiation=cfg.NONLOCAL.INSTANTIATION,
                trans_func_name=cfg.RESNET.TRANS_FUNC,
                stride_1x1=cfg.RESNET.STRIDE_1X1,
                dilation=[cfg.RESNET.SPATIAL_DILATIONS[si][0]] * 2,
                zero_init_final_bn=cfg.RESNET.ZERO_INIT_FINAL_BN,
                zero_init_final_conv=cfg.RESNET.ZERO_INIT_FINAL_CONV,
                remat=remat,
            ))
            if si < 3:  # fuse after s2..s4
                self.add_module(f"s{si + 2}_fuse", FuseFastToSlow(
                    w * out_m // beta_inv, fuse_ratio, fuse_k, alpha, norm,
                ))

        contrastive = cfg.MODEL.MODEL_NAME == "ContrastiveModel"
        self.head = ResNetBasicHead(
            dim_in=w * 32 + w * 32 // beta_inv,
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
        """x [V*B, T, H, W, C] (views stacked view-major) -> head output;
        BN statistics are taken per view. ``generator`` draws the head's
        dropout mask in training."""
        x_f = x.permute(0, 4, 1, 2, 3)  # NCDHW view of the NDHWC clip
        x_s = x_f[:, :, :: self.alpha]
        x_s = self.s1_slow(x_s, views)
        x_f = self.s1_fast(x_f, views)
        x_s, x_f = self.s1_fuse(x_s, x_f, views)
        for si in range(4):
            x_s, x_f = getattr(self, f"s{si + 2}")([x_s, x_f], views)
            if si < 3:
                x_s, x_f = getattr(self, f"s{si + 2}_fuse")(x_s, x_f, views)
        return self.head([x_s, x_f], views, generator)
