"""MaskFeat masked prediction over MViT (counterpart of
``advise_tpu/models/masked.py``, its MaskFeat path): loader-side token masks
replace masked tokens with a learned mask token; at each MASK.PRETRAIN_DEPTH
a SeparateHead (LayerNorm + Linear) predicts per-token HOG features of the
input, and with MASK.JOINT_CONTRASTIVE a pooled projection of the deepest
feature joins for the NT-Xent term of the train step. Every loss is a
masked MSE over all tokens, weighted by the max-pooled token mask at that
depth's grid.

Not ported yet (they raise): the MAE path (MASK.MAE_ON), in-model random
masking (MASK.MAE_RND_MASK), pixel targets (MASK.PRED_HOG False), the
'separate_xformer' decoder heads.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.layers.common import dense, layer_norm, trunc02
from advise_tpu_torch.models.layers.heads import MLPHead
from advise_tpu_torch.models.layers.operators import hog_features
from advise_tpu_torch.models.mvit import MViT


def hog_label_3d(frames: torch.Tensor, feat_hw: int, nbins: int, cell_sz: int) -> torch.Tensor:
    """HOG targets per token: frames [B, T, H, W, 3] (temporally strided)
    -> [B, T*feat_hw*feat_hw, 3*nbins*cells per token]."""
    b, t, hh, ww, c = frames.shape
    hog = hog_features(frames.reshape(b * t, hh, ww, c), nbins=nbins, cell_sz=cell_sz)
    unfold = hog.shape[1] // feat_hw
    hog = hog.reshape(b * t, feat_hw, unfold, feat_hw, unfold, hog.shape[-1])
    hog = hog.permute(0, 1, 3, 2, 4, 5).reshape(b, t, feat_hw, feat_hw, -1)
    return hog.reshape(b, t * feat_hw * feat_hw, -1)


def pad_frames_edge(frames: torch.Tensor, need: int) -> torch.Tensor:
    """[B, T, S, S, C] -> [B, T, need, need, C], edge values repeated, the
    extra split (floor half before): the label frames of a depth whose
    tokens do not tile the crop."""
    size = frames.shape[2]
    if need == size:
        return frames
    lo = (need - size) // 2
    idx = torch.arange(-lo, need - lo, device=frames.device).clamp(0, size - 1)
    return frames[:, :, idx][:, :, :, idx]


def pool_mask(mask: torch.Tensor, src, dst) -> torch.Tensor:
    """Token mask [B, t, h, w] max-pooled to the grid ``dst``: window = the
    ceil ratio, symmetric -inf padding (the exact reshape-max on tiling
    grids)."""
    if tuple(src) == tuple(dst):
        return mask
    wins = tuple(-(-s // d) for s, d in zip(src, dst))
    pads = []
    for s, d, win in reversed(list(zip(src, dst, wins))):
        total = d * win - s
        pads += [total // 2, total - total // 2]
    m = F.pad(mask[:, None], tuple(pads), value=-math.inf)
    return F.max_pool3d(m, wins, wins)[:, 0]


def masked_mse(pred: torch.Tensor, label: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the masked tokens: per-token MSE in float32,
    summed under ``mask`` over max(sum(mask), 1)."""
    err = torch.mean(torch.square(pred.float() - label.float()), dim=-1)
    return torch.sum(err * mask) / torch.clamp(torch.sum(mask), min=1.0)


class SeparateHead(nn.Module):
    """Per-depth prediction head with no decoder blocks: LayerNorm -> Linear."""

    def __init__(self, dim_in: int, num_classes: int):
        super().__init__()
        self.norm = layer_norm(dim_in)
        self.projection = dense(dim_in, num_classes, init=trunc02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.norm(x))


class MaskMViT(nn.Module):
    """MaskFeat over MViT. ``forward(x, loader_mask, generator)`` returns
    (preds, labels, masks, weights), one entry per pretrain depth, plus the
    joint projection [B, CONTRASTIVE.DIM] with MASK.JOINT_CONTRASTIVE."""

    def __init__(self, cfg, norm=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        mk = cfg.MASK
        if mk.MAE_ON:
            raise NotImplementedError("the MAE path (MASK.MAE_ON) is not ported yet")
        if mk.MAE_RND_MASK:
            raise NotImplementedError(
                "in-model random masking (MASK.MAE_RND_MASK) is not ported yet: masks come "
                "from the loader side (infos['mask'])")
        if not mk.PRED_HOG:
            raise NotImplementedError("pixel targets (MASK.PRED_HOG False) are not ported yet")
        head_parts = mk.HEAD_TYPE.split("_")
        if head_parts[0] != "separate" or len(head_parts) > 1:
            raise NotImplementedError(f"MASK.HEAD_TYPE={mk.HEAD_TYPE} is not ported yet")
        self.cfg = cfg
        self.pretrain_depth = list(mk.PRETRAIN_DEPTH)
        embed_dim = cfg.MVIT.EMBED_DIM
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.param_inits = {"mask_token": trunc02}
        self.encoder = MViT(cfg, norm, dtype, include_head=False,
                            depth_override=self.pretrain_depth[-1] + 1,
                            return_intermediate=tuple(self.pretrain_depth))
        self.stride_hw = {}
        for depth in self.pretrain_depth:
            # the true spatial stride of this depth's tokens
            stride_hw = cfg.MVIT.PATCH_STRIDE[1]
            for x in cfg.MVIT.POOL_Q_STRIDE:
                if x[0] <= depth:
                    stride_hw *= x[2]
            self.stride_hw[depth] = stride_hw
            cell = mk.PRED_HOG_CELL_SZ
            if stride_hw < cell or stride_hw % cell:
                raise ValueError(f"HOG cell ({cell}px) must divide the token stride "
                                 f"({stride_hw}px at depth {depth})")
            num_class = 3 * mk.PRED_HOG_NBINS * (stride_hw // cell) ** 2
            self.add_module(f"pred_head_{depth}", SeparateHead(
                self.encoder.intermediate_dims[depth], num_class))
        self.joint = bool(mk.JOINT_CONTRASTIVE)
        if self.joint:
            width = self.encoder.intermediate_dims[self.pretrain_depth[-1]]
            self.joint_norm = layer_norm(width)
            self.joint_proj = MLPHead(width, cfg.CONTRASTIVE.DIM, cfg.CONTRASTIVE.MLP_DIM,
                                      cfg.CONTRASTIVE.NUM_MLP_LAYERS)

    def forward(self, x: torch.Tensor, loader_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x: clips [B, T, H, W, 3]; ``loader_mask`` [B, ...] with t*h*w
        entries per clip on the patch grid (1 = masked); ``generator`` draws
        the drop-path masks in training."""
        cfg, mk = self.cfg, self.cfg.MASK
        pt, ph, _ = cfg.MVIT.PATCH_STRIDE
        t = cfg.DATA.NUM_FRAMES // pt
        h = w = cfg.DATA.TRAIN_CROP_SIZE // ph
        b = x.shape[0]
        if loader_mask is None:
            raise ValueError("MASK.MAE_RND_MASK=False needs loader-side masks (infos['mask'])")
        mask = loader_mask.reshape(b, t * h * w).to(x.device, torch.float32)
        inter = self.encoder(x, generator, token_mask=mask.bool(), mask_token=self.mask_token)

        preds, labels, masks, weights = [], [], [], []
        for (feat, thw), depth in zip(inter, self.pretrain_depth):
            if cfg.MVIT.CLS_EMBED_ON:
                feat = feat[:, 1:]
            t_out, feat_hw = thw[0], thw[1]
            stride_hw = self.stride_hw[depth]
            with torch.no_grad():
                frames = pad_frames_edge(x[:, ::pt][:, :t_out], feat_hw * stride_hw)
                label = hog_label_3d(frames, feat_hw, mk.PRED_HOG_NBINS, mk.PRED_HOG_CELL_SZ)
            preds.append(getattr(self, f"pred_head_{depth}")(feat))
            labels.append(label)
            masks.append(pool_mask(mask.reshape(b, t, h, w), (t, h, w), thw).reshape(b, -1))
            weights.append(1.0 / len(self.pretrain_depth))
        if self.joint:
            feat, _ = inter[-1]
            if cfg.MVIT.CLS_EMBED_ON:
                feat = feat[:, 1:]
            proj = self.joint_proj(self.joint_norm(feat.mean(dim=1)))
            return preds, labels, masks, weights, proj
        return preds, labels, masks, weights
