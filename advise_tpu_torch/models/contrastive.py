"""Contrastive model (counterpart of ``advise_tpu/models/contrastive.py``):
the backbone of MODEL.ARCH (SlowFast, X3D, Video Swin for 'swin',
'video_swin' and 'swin3d', or a single-pathway ResNet3D for 'slow', 'c2d',
'i3d' and 'slow_c2d') with its CONTRASTIVE.DIM head and BYOL predictor.
The algorithm state (EMA twin, kNN bank) lives in the train state
(``engine/contrastive.py``), as in the JAX package."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from advise_tpu_torch.models.resnet3d import ResNet3D
from advise_tpu_torch.models.slowfast import SlowFast
from advise_tpu_torch.models.swin3d import SwinTransformer3D
from advise_tpu_torch.models.x3d import X3D


def _backbone_cls(arch: str):
    """The backbone of MODEL.ARCH (``_backbone_cls`` of the JAX package);
    the MViT backbone is not ported yet."""
    arch = arch.lower()
    if arch == "slowfast":
        return SlowFast
    if arch in ("slow", "c2d", "i3d", "slow_c2d"):
        return ResNet3D
    if arch == "x3d":
        return X3D
    if arch in ("swin", "video_swin", "swin3d"):
        return SwinTransformer3D
    if arch == "mvit":
        raise NotImplementedError(f"ContrastiveModel over MODEL.ARCH={arch} is not ported yet (ROADMAP A 20)")
    raise KeyError(f"ContrastiveModel: unknown MODEL.ARCH={arch!r}")


class ContrastiveModel(nn.Module):
    """``forward`` returns [proj, pred...] in training when
    CONTRASTIVE.PREDICTOR_DEPTHS is set, else the projection."""

    def __init__(self, cfg, norm: Callable, dtype: Optional[torch.dtype] = None):
        super().__init__()
        backbone = _backbone_cls(cfg.MODEL.ARCH)
        if cfg.CONTRASTIVE.TYPE == "swav":
            raise NotImplementedError("SwAV prototypes are not ported yet (ROADMAP A 14)")
        self.backbone = backbone(cfg, norm, dtype)

    def forward(self, x: torch.Tensor, views: int = 1,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the backbone's dropout masks in training (and
        X3D's drop-connect and Swin's drop-path masks)."""
        return self.backbone(x, views, generator)
