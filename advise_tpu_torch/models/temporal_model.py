"""AdViSe's TemporalModel (counterpart of ``advise_tpu/models/temporal_model.py``):
a CLIP ViT spatial encoder, frozen unless TM.FROM_SCRATCH, and a trainable
temporal head.

  clips [N, T, H, W, 3]
    -> per-frame CLIP tokens [N*T, hw, D] (bf16 with TM.ENABLE_BF16)
    -> TM.CHANNEL_POOL_DIM / TM.SPATIAL_POOL_DIM pools, float32
    -> the temporal encoder of TM.TEMPORAL_ARCH: conv3d, resnet3d (one
       ResStage), tfmer_enc (one pre-norm transformer layer) or video_swin
       (one Swin BasicLayer); none with TM.SKIP_TM
    -> the head bridge (mean pool, or TM.TEMPORAL_CAT's temporal concat)
    -> head_cls logits; with BYOL in SSL.TASK, head_projector and
       head_predictor.

The frozen tower runs under ``torch.no_grad()``, JAX's ``stop_gradient``:
its activations are never kept, and its parameters get no gradient (the
step fills zeros for them, as JAX's gradient holds). The BYOL twins of the
temporal encoder and the projector are not modules here: the step keeps
their parameters in ``state.ssl`` and runs these modules with them
(:func:`torch.func.functional_call`), as the JAX step swaps params.

Grids between modules are channels-last ``[N, T, h, w, C]`` as in Flax;
the resnet3d arch runs its ResStage on the NCDHW view of that memory.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.clip_vit import CLIPViT, MultiHeadAttention
from advise_tpu_torch.models.layers.common import dense, lecun_normal_init
from advise_tpu_torch.models.layers.heads import MLPHead, dropout
from advise_tpu_torch.models.layers.resnet import ResStage
from advise_tpu_torch.models.swin3d import BasicLayer


class Conv3dTemporal(nn.Module):
    """conv3d arch: Conv3d(ks) -> SiLU -> Conv3d(ks), with biases; padding 1
    for ks 3, none for ks 1."""

    def __init__(self, dim_in: int, hidden_dim: int, out_dim: int, ks: int = 3):
        super().__init__()
        pad = 0 if ks == 1 else 1
        self.conv1 = nn.Conv3d(dim_in, hidden_dim, ks, padding=pad)
        self.conv2 = nn.Conv3d(hidden_dim, out_dim, ks, padding=pad)
        for conv in (self.conv1, self.conv2):
            conv.weight_init = lecun_normal_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)
        x = self.conv2(F.silu(self.conv1(x)))
        return x.permute(0, 2, 3, 4, 1)


class TransformerTemporal(nn.Module):
    """tfmer_enc arch: one pre-norm transformer encoder layer over the
    flattened (T, h, w) grid: LN -> attention -> residual, LN -> Dense ->
    ReLU -> Dense -> residual."""

    def __init__(self, dim: int, heads: int, hidden_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = dense(dim, hidden_dim, init=lecun_normal_init)
        self.fc2 = dense(hidden_dim, dim, init=lecun_normal_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, d = x.shape
        tokens = x.reshape(b, t * h * w, d)
        tokens = tokens + self.attn(self.norm1(tokens))
        tokens = tokens + self.fc2(F.relu(self.fc1(self.norm2(tokens))))
        return tokens.reshape(b, t, h, w, d)


class ResStageTemporal(nn.Module):
    """resnet3d arch: one ResStage of TM.NUM_BLOCKS blocks, chn ->
    TEMPORAL_EMBEDDING_DIM, inner TEMPORAL_HIDDEN_DIM, temporal kernel 1."""

    def __init__(self, cfg, norm: Callable, chn: int):
        super().__init__()
        self.stage = ResStage(
            dim_in=[chn], dim_out=[cfg.MODEL.TEMPORAL_EMBEDDING_DIM],
            dim_inner=[cfg.MODEL.TEMPORAL_HIDDEN_DIM], temp_kernel_sizes=[[1]],
            stride=[cfg.RESNET.SPATIAL_STRIDES[0][0]], num_blocks=[cfg.TM.NUM_BLOCKS],
            num_groups=[1], num_block_temp_kernel=[1], norm=norm,
            nonlocal_inds=[tuple(cfg.NONLOCAL.LOCATION[0][0])],
            nonlocal_group=[cfg.NONLOCAL.GROUP[0][0]], nonlocal_pool=[cfg.NONLOCAL.POOL[0][0]],
            instantiation=cfg.NONLOCAL.INSTANTIATION,
            trans_func_name=cfg.RESNET.TRANS_FUNC, stride_1x1=cfg.RESNET.STRIDE_1X1,
            dilation=[cfg.RESNET.SPATIAL_DILATIONS[0][0]],
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stage([x.permute(0, 4, 1, 2, 3)])[0].permute(0, 2, 3, 4, 1)


class SwinTemporal(nn.Module):
    """video_swin arch: one Swin BasicLayer of TM.NUM_BLOCKS blocks and
    TM.NUM_HEADS heads at TEMPORAL_EMBEDDING_DIM, window (4, 7, 7), no qkv
    bias, no drop path, built for the token grid ``input_size`` (T, h, w)."""

    def __init__(self, cfg, input_size, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer = BasicLayer(
            cfg.MODEL.TEMPORAL_EMBEDDING_DIM, cfg.TM.NUM_BLOCKS, cfg.TM.NUM_HEADS, input_size,
            window_size=(4, 7, 7), qkv_bias=False, dtype=dtype, remat=bool(cfg.TPU.REMAT))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class Head(nn.Module):
    """load_head: a Linear ``fc`` when SSL.NUM_MLP_LAYERS is 1, else dropout
    (training, MODEL.DROPOUT_RATE > 0) then MLPHead ``mlp`` (SSL.MLP_DIM,
    with BN when SSL.BN_MLP)."""

    def __init__(self, cfg, dim_in: int, num_classes: int):
        super().__init__()
        self.dropout_rate = cfg.MODEL.DROPOUT_RATE
        if cfg.SSL.NUM_MLP_LAYERS == 1:
            self.fc = dense(dim_in, num_classes, init=lecun_normal_init)
        else:
            self.mlp = MLPHead(dim_in, num_classes, cfg.SSL.MLP_DIM, cfg.SSL.NUM_MLP_LAYERS,
                               bn_on=cfg.SSL.BN_MLP)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if hasattr(self, "fc"):
            return self.fc(x)
        if self.training and self.dropout_rate > 0:
            x = dropout(x, self.dropout_rate, generator)
        return self.mlp(x)


class TemporalModel(nn.Module):
    """The AdViSe model. ``forward(x)`` maps flat clips [N, T, H, W, 3] to
    logits; the step calls the pieces (:meth:`spatial_forward`,
    :meth:`temporal_forward`, :meth:`classify`, :meth:`project`,
    :meth:`predict`)."""

    def __init__(self, cfg, norm: Callable, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        arch = (cfg.MODEL.SPATIAL_MODEL_ARCH or "").lower()
        width = cfg.MODEL.SPATIAL_EMBEDDING_DIM
        size = cfg.AUG.TARGET_SIZE * (2 if cfg.AUG.TARGET_SIZE == 112 else 1)
        self.spatial_encoder = CLIPViT(
            width=width, layers=cfg.MODEL.TEMPORAL_NUM_LAYERS * 2, heads=max(width // 64, 1),
            patch_size=32 if "32" in arch else 16, image_size=size,
            dtype=torch.bfloat16 if cfg.TM.ENABLE_BF16 else dtype,
        )
        chn = cfg.TM.CHANNEL_POOL_DIM or width
        ks = 1 if cfg.TM.SPATIAL_POOL_DIM == 1 else 3
        t_arch = cfg.TM.TEMPORAL_ARCH
        emb = cfg.MODEL.TEMPORAL_EMBEDDING_DIM
        dim = emb
        if cfg.TM.SKIP_TM:
            dim = chn
        elif t_arch == "conv3d":
            self.temporal_encoder = Conv3dTemporal(chn, cfg.MODEL.TEMPORAL_HIDDEN_DIM, emb, ks)
        elif t_arch == "resnet3d":
            self.temporal_encoder = ResStageTemporal(cfg, norm, chn)
        elif t_arch == "tfmer_enc":
            self.temporal_encoder = TransformerTemporal(chn, cfg.TM.NUM_HEADS, cfg.MODEL.TEMPORAL_HIDDEN_DIM)
            dim = chn
        elif t_arch == "video_swin":
            if chn != emb:
                raise ValueError(f"TM.TEMPORAL_ARCH video_swin keeps the width: TM.CHANNEL_POOL_DIM (or the "
                                 f"tower's width) {chn} must equal MODEL.TEMPORAL_EMBEDDING_DIM {emb}")
            hw = size // self.spatial_encoder.patch_size
            sp = cfg.TM.SPATIAL_POOL_DIM
            hw = sp if sp and hw != sp else hw
            self.temporal_encoder = SwinTemporal(cfg, (cfg.DATA.NUM_FRAMES, hw, hw), dtype)
        else:
            raise NotImplementedError(t_arch)
        self.t_dim = emb // cfg.DATA.NUM_FRAMES
        if cfg.TM.TEMPORAL_CAT and cfg.TM.LINEAR_PROJ:
            self.bridge_proj = dense(dim, self.t_dim, init=lecun_normal_init)
            feat_dim = self.t_dim * cfg.DATA.NUM_FRAMES
        elif cfg.TM.TEMPORAL_CAT:
            feat_dim = self.t_dim * dim
        else:
            feat_dim = dim
        self.head_cls = Head(cfg, feat_dim, cfg.MODEL.NUM_CLASSES)
        if "byol" in cfg.SSL.TASK:
            self.head_projector = Head(cfg, feat_dim, cfg.CONTRASTIVE.DIM)
            self.head_predictor = Head(cfg, cfg.CONTRASTIVE.DIM, cfg.CONTRASTIVE.DIM)

    def spatial_forward(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] -> float32 [N, nh, nw, D]: the tower's patch tokens
        (bf16 input with TM.ENABLE_BF16; no gradient unless TM.FROM_SCRATCH),
        then the channel and spatial pools."""
        cfg = self.cfg
        if cfg.TM.ENABLE_BF16:
            frames = frames.to(torch.bfloat16)
        with contextlib.nullcontext() if cfg.TM.FROM_SCRATCH else torch.no_grad():
            _, tokens = self.spatial_encoder(frames)
        n, hw, d = tokens.shape[0], int(tokens.shape[1] ** 0.5), tokens.shape[2]
        feats = tokens.reshape(n, hw, hw, d).float()
        p = cfg.TM.CHANNEL_POOL_DIM
        if p and d != p:
            feats = feats.reshape(n, hw, hw, p, d // p).mean(-1)
        sp = cfg.TM.SPATIAL_POOL_DIM
        if sp and hw != sp:
            feats = feats.reshape(n, sp, hw // sp, sp, hw // sp, -1).mean(dim=(2, 4))
        return feats

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Flat clips [N, T, H, W, 3] -> the spatial grid [N, T, nh, nw, D]."""
        n, t = x.shape[:2]
        sp = self.spatial_forward(x.reshape(n * t, *x.shape[2:]))
        return sp.reshape(n, t, *sp.shape[1:])

    def head_bridge(self, feat: torch.Tensor) -> torch.Tensor:
        """[N, T, nh, nw, D] -> [N, feature dim]: the mean over (T, nh, nw),
        or with TM.TEMPORAL_CAT the spatial mean pooled to t_dim steps and
        flattened (with TM.LINEAR_PROJ each token projected to t_dim first,
        the [t_dim, T] grid flattened channel-major)."""
        n = feat.shape[0]
        if not self.cfg.TM.TEMPORAL_CAT:
            return feat.mean(dim=(1, 2, 3))
        if self.cfg.TM.LINEAR_PROJ:
            pooled = self.bridge_proj(feat).mean(dim=(2, 3))  # [N, T, t_dim]
            return pooled.transpose(1, 2).reshape(n, -1)
        pooled = feat.mean(dim=(2, 3))  # [N, T, D]
        nt = pooled.shape[1]
        if nt != self.t_dim:
            if nt % self.t_dim:
                raise ValueError(f"{nt} frames do not pool to {self.t_dim} steps")
            pooled = pooled.reshape(n, self.t_dim, nt // self.t_dim, -1).mean(2)
        return pooled.reshape(n, -1)

    def temporal_forward(self, grid: torch.Tensor,
                         temporal_params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """The grid through the temporal encoder (with ``temporal_params`` in
        place of its own parameters, its buffers kept) and the bridge."""
        if not self.cfg.TM.SKIP_TM:
            if temporal_params is None:
                grid = self.temporal_encoder(grid)
            else:
                grid = torch.func.functional_call(self.temporal_encoder, temporal_params, (grid,))
        return self.head_bridge(grid)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Flat clips [N, T, H, W, 3] -> features [N, feature dim]."""
        return self.temporal_forward(self.tokens(x))

    def classify(self, feat: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.head_cls(feat, generator)

    def project(self, feat: torch.Tensor, generator: Optional[torch.Generator] = None,
                projector_params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        if projector_params is None:
            return self.head_projector(feat, generator)
        return torch.func.functional_call(self.head_projector, projector_params, (feat, generator))

    def predict(self, proj: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.head_predictor(proj, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.classify(self.features(x), generator)


@contextlib.contextmanager
def eval_mode(*modules: nn.Module) -> Iterator[None]:
    """``modules`` in eval mode for the block, restored after: the BYOL key
    forwards run part of the model so without touching the online forward's
    mode."""
    modes = [m.training for m in modules]
    try:
        for m in modules:
            m.eval()
        yield
    finally:
        for m, mode in zip(modules, modes):
            m.train(mode)
