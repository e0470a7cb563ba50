"""Masked visual prediction over MViT (counterpart of
``advise_tpu/models/masked.py``): MAE (MASK.MAE_ON) and MaskFeat.

MaskFeat: token masks from the loader (``infos['mask']``) or, with
MASK.MAE_RND_MASK, drawn in the model (:func:`random_masking`) replace
masked tokens with a learned mask token; at each MASK.PRETRAIN_DEPTH a
SeparateHead (with MASK.HEAD_TYPE 'separate_xformer' DECODER_DEPTH
MultiScaleBlocks, then LayerNorm + Linear) predicts per-token HOG features
or (MASK.PRED_HOG False) the patch's pixels, and with
MASK.JOINT_CONTRASTIVE a pooled projection of the deepest feature joins for
the NT-Xent term of the train step.

MAE: PatchEmbed, the learned or fixed sin-cos position table, the visible
tokens gathered, the encoder blocks up to PRETRAIN_DEPTH[-1] on them (no
pooling, no flash attention, MASK.SCALE_INIT_BY_DEPTH), LayerNorm, the
decoder embedding, mask tokens restored to their places, the decoder's
position table (one, or spatial plus temporal under
MASK.DECODER_SEP_POS_EMBED), the decoder blocks and the pixel prediction;
with VIS_MASK.ENABLE also the (input, masked input, reconstruction) videos.

Every loss is a masked MSE over all tokens, weighted by the token mask at
that depth's grid. The random masks come from the forward's
``torch.Generator`` (drawn before any block runs), or from the caller
(``masking``), so that tests can hand the port JAX's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from advise_tpu_torch.models.layers.attention import MultiScaleBlock
from advise_tpu_torch.models.layers.common import dense, layer_norm, trunc02
from advise_tpu_torch.models.layers.heads import MLPHead
from advise_tpu_torch.models.layers.operators import hog_features
from advise_tpu_torch.models.layers.stem import PatchEmbed
from advise_tpu_torch.models.mvit import MViT, init_div, mvit_block_schedule, patch_grid, pooled_thw
from advise_tpu_torch.models.utils import get_3d_sincos_pos_embed

Masking = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def random_masking(b: int, thw: Sequence[int], mask_ratio: float, tube: bool = False,
                   per_frame: bool = False, generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> Masking:
    """Per-sample random masking by the argsort of uniform noise: returns
    ids_keep [B, len_keep], mask [B, L] (1 = masked, float32) and
    ids_restore [B, L], all in the flat frame-major token space.

    The noise is [B, L], [B, 1, h*w] repeated over the frames when ``tube``,
    or [B, t, h*w] when ``per_frame`` (each frame keeps max(int(h*w * (1 -
    ratio)), 1) tokens of its own; ids_restore then indexes the decoder's
    [kept frame-major..., mask tokens frame-major...] layout); it is drawn
    from ``generator`` unless the caller gives it. Keeps max(int(L * (1 -
    ratio)), 2) tokens otherwise. Sorts are stable, as JAX's argsort is."""
    t, h, w = thw
    hw, l = h * w, t * h * w
    if per_frame and tube:
        raise ValueError("PER_FRAME_MASKING and tube masking are exclusive")
    shape = (b, t, hw) if per_frame else ((b, 1, hw) if tube else (b, l))
    if noise is None:
        if generator is None:
            raise ValueError("random masking needs a torch.Generator (or the caller's noise)")
        noise = torch.rand(shape, generator=generator, device=generator.device)
    if per_frame:
        ids_shuffle = torch.argsort(noise, dim=-1, stable=True)
        rl = torch.argsort(ids_shuffle, dim=-1, stable=True)
        keep_f = max(int(hw * (1 - mask_ratio)), 1)
        n_mask_f = hw - keep_f
        frames = torch.arange(t, device=noise.device)[None, :, None]
        ids_keep = (ids_shuffle[..., :keep_f] + frames * hw).reshape(b, -1)
        ids_restore = torch.where(rl < keep_f, frames * keep_f + rl,
                                  t * keep_f + frames * n_mask_f + (rl - keep_f)).reshape(b, l)
        return ids_keep, (rl >= keep_f).float().reshape(b, l), ids_restore
    if tube:
        noise = noise.expand(b, t, hw)
    noise = noise.reshape(b, l)
    len_keep = max(int(l * (1 - mask_ratio)), 2)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    mask = torch.ones((b, l), device=noise.device)
    mask[:, :len_keep] = 0.0
    return ids_shuffle[:, :len_keep], torch.gather(mask, 1, ids_restore), ids_restore


def patchify_3d(imgs: torch.Tensor, p: int, u: int) -> torch.Tensor:
    """[B, T, H, W, 3] -> [B, t*h*w, u*p*p*3] (t = T // u, h = H // p, w = W
    // p), each patch (u, p, p, 3) in that order."""
    b, t_full, hh, ww, c = imgs.shape
    t, h, w = t_full // u, hh // p, ww // p
    x = imgs.reshape(b, t, u, h, p, w, p, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, t * h * w, u * p * p * c)


def normalize_patches(x: torch.Tensor) -> torch.Tensor:
    """Per-patch normalisation: (x - mean) / sqrt(var + 1e-6), the variance
    without Bessel's correction (``jnp.var``)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + 1e-6)


def unpatchify_3d(patches: torch.Tensor, thw: Sequence[int], p: int, u: int) -> torch.Tensor:
    """Inverse of :func:`patchify_3d`: [B, t*h*w, u*p*p*3] -> [B, t*u,
    h*p, w*p, 3]."""
    b = patches.shape[0]
    t, h, w = thw
    x = patches.reshape(b, t, h, w, u, p, p, 3).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, t * u, h * p, w * p, 3)


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


def masked_mse(pred: torch.Tensor, label: torch.Tensor, mask: torch.Tensor,
               axes=None) -> torch.Tensor:
    """Mean squared error over the masked tokens: per-token MSE in float32,
    summed under ``mask`` over max(sum(mask), 1). ``axes``: the masked
    tokens are the batch's over those ranks (the JAX auto step's global
    arrays): this rank's sum over the whole batch's count, times the ranks,
    so that the ranks' mean, and the mean of their gradients, is the whole
    batch's."""
    err = torch.mean(torch.square(pred.float() - label.float()), dim=-1)
    count = torch.sum(mask)
    if axes is not None:
        from advise_tpu_torch.parallel.collectives import world_size
        from advise_tpu_torch.parallel.mesh import axis_group

        g = axis_group(axes)
        if g is not None:
            count = count.detach().clone()
            torch.distributed.all_reduce(count, group=g[0])
            count = count / world_size(axes)
    return torch.sum(err * mask) / torch.clamp(count, min=1.0 / world_size(axes) if axes else 1.0)


class SeparateHead(nn.Module):
    """Per-depth prediction head: ``decoder_depth`` MultiScaleBlocks
    (``decoder_embed_dim`` wide, max(decoder_embed_dim // 64, 1) heads, no
    cls token, K/V pooled by ``kernel_kv``/``stride_kv`` on the
    ``feat_size`` grid in MVIT.MODE ``mode``; the first projects a wider or
    narrower input), then LayerNorm -> Linear."""

    def __init__(self, dim_in: int, num_classes: int, feat_size: Sequence[int] = (),
                 decoder_depth: int = 0, decoder_embed_dim: int = 512, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, kernel_kv: Sequence[int] = (), stride_kv: Sequence[int] = (),
                 dtype: Optional[torch.dtype] = None, mode: str = "conv"):
        super().__init__()
        self.feat_size = tuple(feat_size)
        self.decoder_depth = decoder_depth
        dim = dim_in
        for i in range(decoder_depth):
            self.add_module(f"transform_{i}", MultiScaleBlock(
                dim, decoder_embed_dim, max(decoder_embed_dim // 64, 1), mlp_ratio, qkv_bias,
                kernel_kv=tuple(kernel_kv), stride_kv=tuple(stride_kv), has_cls_embed=False,
                dtype=dtype, input_size=self.feat_size, mode=mode))
            dim = decoder_embed_dim
        self.norm = layer_norm(dim)
        self.projection = dense(dim, num_classes, init=trunc02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.decoder_depth):
            x = getattr(self, f"transform_{i}")(x, self.feat_size)[0]
        return self.projection(self.norm(x))


class MaskMViT(nn.Module):
    """MAE or MaskFeat over MViT. ``forward(x, loader_mask, generator,
    masking)`` returns (preds, labels, masks, weights), one entry per
    pretrain depth; plus the joint projection [B, CONTRASTIVE.DIM] with
    MASK.JOINT_CONTRASTIVE, or the VIS_MASK videos under MAE."""

    def __init__(self, cfg, norm=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        mk = cfg.MASK
        self.cfg = cfg
        self.mae = bool(mk.MAE_ON)
        self.pretrain_depth = list(mk.PRETRAIN_DEPTH)
        self.param_inits = {}
        if self.mae:
            self._build_mae(cfg, dtype)
        else:
            self._build_maskfeat(cfg, norm, dtype)

    def _free_param(self, name: str, shape) -> None:
        setattr(self, name, nn.Parameter(torch.zeros(shape)))
        self.param_inits[name] = trunc02

    # -- MaskFeat -------------------------------------------------------------
    def _build_maskfeat(self, cfg, norm, dtype) -> None:
        mk = cfg.MASK
        head_parts = mk.HEAD_TYPE.split("_")
        if head_parts[0] != "separate" or head_parts[1:] not in ([], ["xformer"]):
            raise ValueError(f"MASK.HEAD_TYPE={mk.HEAD_TYPE}: 'separate' or 'separate_xformer'")
        xformer = head_parts[1:] == ["xformer"]
        if xformer and mk.DECODER_DEPTH <= 0:
            raise ValueError("MASK.HEAD_TYPE separate_xformer needs MASK.DECODER_DEPTH > 0")
        self._free_param("mask_token", (1, 1, cfg.MVIT.EMBED_DIM))
        self.encoder = MViT(cfg, norm, dtype, include_head=False,
                            depth_override=self.pretrain_depth[-1] + 1,
                            return_intermediate=tuple(self.pretrain_depth))
        self.stride_hw = {}
        pt = cfg.MVIT.PATCH_STRIDE[0]
        for depth in self.pretrain_depth:
            # the true spatial stride of this depth's tokens
            stride_hw = cfg.MVIT.PATCH_STRIDE[1]
            for x in cfg.MVIT.POOL_Q_STRIDE:
                if x[0] <= depth:
                    stride_hw *= x[2]
            self.stride_hw[depth] = stride_hw
            if mk.PRED_HOG:
                cell = mk.PRED_HOG_CELL_SZ
                if stride_hw < cell or stride_hw % cell:
                    raise ValueError(f"HOG cell ({cell}px) must divide the token stride "
                                     f"({stride_hw}px at depth {depth})")
                num_class = 3 * mk.PRED_HOG_NBINS * (stride_hw // cell) ** 2
            else:
                u = 1 if mk.TIME_STRIDE_LOSS else pt
                num_class = u * stride_hw * stride_hw * 3
            spec = self.encoder.schedule[depth]
            feat_size = pooled_thw(spec["input_size"], spec["kernel_q"], spec["stride_q"])
            self.add_module(f"pred_head_{depth}", SeparateHead(
                self.encoder.intermediate_dims[depth], num_class, feat_size,
                mk.DECODER_DEPTH if xformer else 0, mk.DECODER_EMBED_DIM, cfg.MVIT.MLP_RATIO,
                cfg.MVIT.QKV_BIAS, mk.DEC_KV_KERNEL, mk.DEC_KV_STRIDE, dtype, mode=cfg.MVIT.MODE))
        self.joint = bool(mk.JOINT_CONTRASTIVE)
        if self.joint:
            width = self.encoder.intermediate_dims[self.pretrain_depth[-1]]
            self.joint_norm = layer_norm(width)
            self.joint_proj = MLPHead(width, cfg.CONTRASTIVE.DIM, cfg.CONTRASTIVE.MLP_DIM,
                                      cfg.CONTRASTIVE.NUM_MLP_LAYERS)

    def _maskfeat_forward(self, x, loader_mask, generator, masking):
        cfg, mk = self.cfg, self.cfg.MASK
        pt, ph, _ = cfg.MVIT.PATCH_STRIDE
        t = cfg.DATA.NUM_FRAMES // pt
        h = w = cfg.DATA.TRAIN_CROP_SIZE // ph
        b = x.shape[0]
        if mk.MAE_RND_MASK:
            # in-model uniform masks, drawn before any block (and its drop
            # path) runs
            if masking is None:
                masking = random_masking(b, (t, h, w), cfg.AUG.MASK_RATIO, tube=cfg.AUG.MASK_TUBE,
                                         generator=generator)
            mask = masking[1].to(x.device, torch.float32)
        else:
            if loader_mask is None:
                raise ValueError("MASK.MAE_RND_MASK=False needs loader-side masks (infos['mask'])")
            mask = loader_mask.reshape(b, t * h * w).to(x.device, torch.float32)
        inter = self.encoder(x, generator=generator, token_mask=mask.bool(), mask_token=self.mask_token)

        preds, labels, masks, weights = [], [], [], []
        for (feat, thw), depth in zip(inter, self.pretrain_depth):
            if cfg.MVIT.CLS_EMBED_ON:
                feat = feat[:, 1:]
            t_out, feat_hw = thw[0], thw[1]
            stride_hw = self.stride_hw[depth]
            with torch.no_grad():
                need = feat_hw * stride_hw
                if mk.PRED_HOG:
                    frames = pad_frames_edge(x[:, ::pt][:, :t_out], need)
                    label = hog_label_3d(frames, feat_hw, mk.PRED_HOG_NBINS, mk.PRED_HOG_CELL_SZ)
                else:
                    u = 1 if mk.TIME_STRIDE_LOSS else pt
                    frames = x[:, ::pt] if mk.TIME_STRIDE_LOSS else x
                    label = patchify_3d(pad_frames_edge(frames, need), stride_hw, u)
                    if mk.NORM_PRED_PIXEL:
                        label = normalize_patches(label)
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

    # -- MAE ------------------------------------------------------------------
    def _build_mae(self, cfg, dtype) -> None:
        m, mk = cfg.MVIT, cfg.MASK
        if m.CLS_EMBED_ON:
            raise ValueError("the MAE path runs without a cls token (MVIT.CLS_EMBED_ON False)")
        embed_dim, dec_dim = m.EMBED_DIM, mk.DECODER_EMBED_DIM
        self.patch_embed = PatchEmbed(cfg.DATA.INPUT_CHANNEL_NUM[0], embed_dim, m.PATCH_KERNEL,
                                      m.PATCH_STRIDE, m.PATCH_PADDING)
        grid = t, h, w = patch_grid(cfg)
        l = t * h * w
        self.abs_pos, self.fixed_pos = bool(m.USE_ABS_POS), bool(m.USE_FIXED_SINCOS_POS)
        if self.abs_pos and self.fixed_pos:
            self.register_buffer("sincos_pos", torch.from_numpy(
                get_3d_sincos_pos_embed(embed_dim, h, t)[None]), persistent=False)
        elif self.abs_pos:
            self._free_param("pos_embed", (1, l, embed_dim))
        schedule, _ = mvit_block_schedule(cfg, grid)
        self.n_blocks = mk.PRETRAIN_DEPTH[-1] + 1
        for i, spec in enumerate(schedule[:self.n_blocks]):
            if spec["stride_q"]:
                raise ValueError("the MAE encoder runs on the visible tokens: no Q pooling (MVIT.POOL_Q_STRIDE)")
            self.add_module(f"blocks_{i}", MultiScaleBlock(
                spec["dim"], spec["dim_out"], spec["num_heads"], m.MLP_RATIO, m.QKV_BIAS,
                kernel_q=spec["kernel_q"], kernel_kv=spec["kernel_kv"], stride_q=spec["stride_q"],
                stride_kv=spec["stride_kv"], has_cls_embed=False, dtype=dtype,
                input_size=spec["input_size"], init_div=init_div(cfg, i), mode=m.MODE))
        width = schedule[self.n_blocks - 1]["dim_out"]
        self.norm = layer_norm(width)
        self.decoder_embed = dense(width, dec_dim, init=trunc02)
        self._free_param("mask_token", (1, 1, dec_dim))
        self.dec_sep_pos = bool(mk.DECODER_SEP_POS_EMBED)
        if self.dec_sep_pos:
            self._free_param("dec_pos_embed_spatial", (1, h * w, dec_dim))
            self._free_param("dec_pos_embed_temporal", (1, t, dec_dim))
        else:
            self._free_param("decoder_pos_embed", (1, l, dec_dim))
        self.u = 1 if mk.TIME_STRIDE_LOSS else m.PATCH_STRIDE[0]
        self.stride_hw = cfg.DATA.TRAIN_CROP_SIZE // h
        self.pred_head = SeparateHead(dec_dim, self.u * self.stride_hw ** 2 * 3, grid,
                                      mk.DECODER_DEPTH, dec_dim, kernel_kv=mk.DEC_KV_KERNEL,
                                      stride_kv=mk.DEC_KV_STRIDE, dtype=dtype, mode=m.MODE)

    def _mae_forward(self, imgs, generator, masking):
        cfg, mk = self.cfg, self.cfg.MASK
        pt = cfg.MVIT.PATCH_STRIDE[0]
        x, (t, h, w) = self.patch_embed(imgs)
        b, l, _ = x.shape
        if masking is None:
            masking = random_masking(b, (t, h, w), cfg.AUG.MASK_RATIO, tube=cfg.AUG.MASK_TUBE,
                                     per_frame=mk.PER_FRAME_MASKING, generator=generator)
        ids_keep, mask, ids_restore = (v.to(x.device) for v in masking)
        ids_keep, mask, ids_restore = ids_keep.long(), mask.float(), ids_restore.long()
        if self.abs_pos:
            x = x + (self.sincos_pos if self.fixed_pos else self.pos_embed)
        x = torch.gather(x, 1, ids_keep[..., None].expand(-1, -1, x.shape[-1]))
        for i in range(self.n_blocks):
            x = getattr(self, f"blocks_{i}")(x, (t, h, w))[0]
        x = self.decoder_embed(self.norm(x))
        dec_dim = x.shape[-1]
        x = torch.cat([x, self.mask_token.to(x.dtype).expand(b, l - x.shape[1], dec_dim)], dim=1)
        x = torch.gather(x, 1, ids_restore[..., None].expand(-1, -1, dec_dim))
        if self.dec_sep_pos:
            pe = (self.dec_pos_embed_spatial.repeat(1, t, 1)
                  + torch.repeat_interleave(self.dec_pos_embed_temporal, h * w, dim=1))
        else:
            pe = self.decoder_pos_embed
        pred = self.pred_head(x + pe.to(x.dtype))

        u, p = self.u, self.stride_hw
        with torch.no_grad():
            frames = imgs[:, ::pt] if mk.TIME_STRIDE_LOSS else imgs
            patches = patchify_3d(frames, p, u)  # in the input's dtype, as JAX's label
            label = normalize_patches(patches) if mk.NORM_PRED_PIXEL else patches
            if cfg.VIS_MASK.ENABLE:
                raw = patches.float()
                rec = pred.detach().float()
                if mk.NORM_PRED_PIXEL:
                    # denormalised with the target patch's statistics
                    mean = raw.mean(dim=-1, keepdim=True)
                    var = raw.var(dim=-1, keepdim=True, correction=0)
                    rec = rec * torch.sqrt(var + 1e-6) + mean
                m = mask[..., None]
                vis = tuple(unpatchify_3d(v, (t, h, w), p, u)
                            for v in (raw, raw * (1.0 - m), rec * m + raw * (1.0 - m)))
                return [pred], [label], [mask], [1.0], vis
        return [pred], [label], [mask], [1.0]

    def forward(self, x: torch.Tensor, loader_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, masking: Optional[Masking] = None):
        """x: clips [B, T, H, W, 3]; ``loader_mask`` [B, ...] with t*h*w
        entries per clip on the patch grid (1 = masked), MaskFeat's when
        MASK.MAE_RND_MASK is False; ``generator`` draws the random masks
        (MAE, MAE_RND_MASK) and then the drop-path masks in training;
        ``masking`` (ids_keep, mask, ids_restore) replaces the random draw."""
        if self.mae:
            return self._mae_forward(x, generator, masking)
        return self._maskfeat_forward(x, loader_mask, generator, masking)

