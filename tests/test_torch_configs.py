"""Every YAML under configs/ through the port's builders on the CPU:
``check_ported``, ``build_device_aug``, the model of MODEL_NAME (built on
the meta device, so no weight is drawn), ``build_tx`` and
``make_train_step``. All 18 build, ``mae_vismask_minik400.yaml`` (the MAE
path with its VIS_MASK dump) and ``MaskFeat_MViTv2_L_16x224.yaml`` (MViTv2-L,
213,257,520 parameters) among them; ``NOT_PORTED`` is empty and stays
for a YAML a later change adds before the port carries it. AdViSe's
``video_swin`` head builds at the width the JAX package builds it
(TEMPORAL_EMBEDDING_DIM = TM.CHANNEL_POOL_DIM = 384, 6 heads)."""

import glob

import pytest
import torch

from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import build_device_aug
from advise_tpu_torch.engine.steps import make_train_step
from advise_tpu_torch.engine.train import check_ported
from advise_tpu_torch.models import MODEL_REGISTRY, compute_dtype
from advise_tpu_torch.models.layers.norm import get_norm
from advise_tpu_torch.solver.optimizer import build_tx

CONFIGS = sorted(glob.glob("configs/**/*.yaml", recursive=True))
NOT_PORTED = {}  # path -> the ROADMAP item its NotImplementedError names
# parameter counts of the port's trees (the JAX package's where its tests
# hold one: Swin-B 90,002,504, Slow-R50 speed 40,047,684)
PARAMS = {"configs/pretrain/SwinB_moco_32chips.yaml": 90_002_504,
          "configs/pretrain/SpeedPro_R50.yaml": 40_047_684,
          "configs/pretrain/MaskFeat_MViTv2_L_16x224.yaml": 213_257_520}
ADVISE_SWIN = ["MODEL.TEMPORAL_EMBEDDING_DIM", "384", "TM.CHANNEL_POOL_DIM", "384", "TM.NUM_HEADS", "6",
               "TM.TEMPORAL_ARCH", "video_swin"]


def build_all(path, opts=()):
    """The builders over ``path`` (with ``opts``, KEY VALUE pairs); returns
    the model's parameter count."""
    cfg = tconfig.get_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list(list(opts))
    cfg = tconfig.assert_and_infer_cfg(cfg)
    check_ported(cfg)
    aug = build_device_aug(cfg, "train")
    with torch.device("meta"):
        model = MODEL_REGISTRY[cfg.MODEL.MODEL_NAME](cfg, get_norm(cfg), compute_dtype(cfg))
    params = dict(model.named_parameters())
    make_train_step(cfg, build_tx(cfg, params), aug)
    return model, sum(p.numel() for p in params.values())


def test_seventeen_configs():
    """The name stays; an eighteenth YAML joined the seventeen."""
    assert len(CONFIGS) == 18


@pytest.mark.parametrize("path", CONFIGS)
def test_config_builds_or_names_its_roadmap_item(path):
    if path in NOT_PORTED:
        with pytest.raises(NotImplementedError, match=NOT_PORTED[path]):
            build_all(path)
        return
    _, n = build_all(path)
    assert n == PARAMS.get(path, n)


def test_advise_video_swin_builds_at_384():
    """7,121,640 parameters in the Swin temporal head: the JAX package's
    count at this width."""
    model, _ = build_all("configs/pretrain/AdViSe.yaml", ADVISE_SWIN)
    assert type(model.temporal_encoder).__name__ == "SwinTemporal"
    assert sum(p.numel() for p in model.temporal_encoder.parameters()) == 7_121_640
