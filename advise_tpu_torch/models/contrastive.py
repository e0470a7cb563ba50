"""Contrastive model (counterpart of ``advise_tpu/models/contrastive.py``):
the backbone of MODEL.ARCH (SlowFast, X3D, MViT, Video Swin for 'swin',
'video_swin' and 'swin3d', or a single-pathway ResNet3D for 'slow', 'c2d',
'i3d' and 'slow_c2d') with its CONTRASTIVE.DIM head (and, on the ResNets
and X3D, the BYOL predictor), and for SwAV the prototypes. MViT's and
Swin's transformer heads carry no predictor, as in JAX, so BYOL over them
raises as JAX's ``byol_loss`` asserts. The algorithm state (EMA twin, queues, memory and
kNN banks) lives in the train state (``engine/contrastive.py``), as in the
JAX package."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from advise_tpu_torch.models.layers.common import trunc_normal_init
from advise_tpu_torch.models.mvit import MViT
from advise_tpu_torch.models.resnet3d import ResNet3D
from advise_tpu_torch.models.slowfast import SlowFast
from advise_tpu_torch.models.swin3d import SwinTransformer3D
from advise_tpu_torch.models.x3d import X3D

SWAV_NUM_PROTOTYPES = 1000  # the JAX package's (and the reference's) fixed count


def _backbone_cls(arch: str):
    """The backbone of MODEL.ARCH (``_backbone_cls`` of the JAX package)."""
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
        return MViT
    raise KeyError(f"ContrastiveModel: unknown MODEL.ARCH={arch!r}")


def _prototypes_init(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal`` on the [DIM, prototypes] matrix: its fan-in is
    DIM, the first axis (torch's own fan-in of a 2-D tensor is the second)."""
    trunc_normal_init((1.0 / w.shape[0]) ** 0.5, corrected=True)(w, generator)


class ContrastiveModel(nn.Module):
    """``forward`` returns [proj, pred...] in training when
    CONTRASTIVE.PREDICTOR_DEPTHS is set, else the projection. For
    CONTRASTIVE.TYPE swav the model also holds ``swav_prototypes`` [DIM,
    1000] (the Flax parameter of that name) and :meth:`prototypes`."""

    def __init__(self, cfg, norm: Callable, dtype: Optional[torch.dtype] = None):
        super().__init__()
        backbone = _backbone_cls(cfg.MODEL.ARCH)
        self.backbone = backbone(cfg, norm, dtype)
        if cfg.CONTRASTIVE.TYPE == "swav":
            self.swav_prototypes = nn.Parameter(torch.empty(cfg.CONTRASTIVE.DIM, SWAV_NUM_PROTOTYPES))
            self.param_inits = {"swav_prototypes": _prototypes_init}

    def prototypes(self, proj: torch.Tensor) -> torch.Tensor:
        """Scores [N, 1000] of ``proj`` [N, DIM] against the column-normalized
        prototypes in float32, whatever autocast says (JAX promotes to the
        float32 parameter). The normalization is straight-through: the value
        of ``proj @ w_n``, the gradient of ``proj @ w``, as the reference's
        in-place renorm of the weights gives."""
        w = self.swav_prototypes
        with torch.autocast(proj.device.type, enabled=False):
            w_n = w / (torch.linalg.vector_norm(w, dim=0, keepdim=True) + 1e-12)
            return proj.to(w.dtype) @ (w + (w_n - w).detach())

    def forward(self, x: torch.Tensor, views: int = 1,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the backbone's dropout masks in training (and
        X3D's drop-connect and MViT's and Swin's drop-path masks)."""
        return self.backbone(x, views, generator)
