"""Model registry and builder (counterpart of ``advise_tpu/models/__init__.py``):
MODEL_NAME ResNet (the single-pathway 3D ResNets), X3D, ContrastiveModel
(ARCH slowfast, x3d, swin or a single-pathway ResNet), MViT (v1 and v2),
MaskMViT (MaskFeat, and MAE under MASK.MAE_ON), SwinTransformer3D (Video
Swin) and TemporalModel (AdViSe)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from advise_tpu_torch.models.contrastive import ContrastiveModel
from advise_tpu_torch.models.layers.common import init_weights
from advise_tpu_torch.models.layers.norm import get_norm
from advise_tpu_torch.models.masked import MaskMViT
from advise_tpu_torch.models.mvit import MViT
from advise_tpu_torch.models.resnet3d import ResNet3D
from advise_tpu_torch.models.swin3d import SwinTransformer3D
from advise_tpu_torch.models.temporal_model import TemporalModel
from advise_tpu_torch.models.x3d import X3D

MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "ResNet": ResNet3D,
    "X3D": X3D,
    "ContrastiveModel": ContrastiveModel,
    "MViT": MViT,
    "MaskMViT": MaskMViT,
    "SwinTransformer3D": SwinTransformer3D,
    "TemporalModel": TemporalModel,
}


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


def build_model(cfg, device: torch.device | str = "cuda", seed: int = 0,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Construct the configured model with weights drawn from ``generator``
    (a CPU generator seeded with ``seed`` when none is given), on
    ``device``: the card unless the caller asks for another. On a CUDA
    device the 3D conv weights take the channels-last layout the
    activations use."""
    name = cfg.MODEL.MODEL_NAME
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"MODEL.MODEL_NAME={name} is not ported yet; ported: {sorted(MODEL_REGISTRY)}")
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    model = MODEL_REGISTRY[name](cfg, get_norm(cfg), compute_dtype(cfg))
    init_weights(model, generator)
    model = model.to(device)
    if torch.device(device).type == "cuda":
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                if t.dim() == 5:
                    t.data = t.data.contiguous(memory_format=torch.channels_last_3d)
    return model
