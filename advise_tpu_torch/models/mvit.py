"""MViT v2 video transformer (counterpart of ``advise_tpu/models/mvit.py``):
the block schedule, the plain walk of MultiScaleBlocks and the reversible
walk (MVIT.REV.ENABLE).

In the reversible walk each uniform segment (consecutive blocks with no
width change and no Q pooling) runs the two-stream coupling ``y1 = x1 +
F(x2); y2 = x2 + G(y1)`` with one attention sub-block (F) and one MLP
sub-block (G) per block, under ``parallel/reversible.py`` when
MVIT.REV.O1_SCAN (activation memory O(1) in depth) or plain autograd
otherwise; stage transitions fuse the streams and run a StageTransitionBlock,
under ``torch.utils.checkpoint`` with TPU.REMAT. Where the JAX package
stacks a segment's parameters on a leading axis (``rev_seg{n}_f`` /
``rev_seg{n}_g``), the port keeps one module per block in a ModuleList of
the same name.

Stochastic depth draws its keep masks once per forward, from the caller's
generator, before any block runs; a recomputation (checkpoint, the
reversible backward) replays them. Under bf16 autocast the residual
streams stay float32 (the token embedding plus the float32 position
embeddings), where the JAX bf16 model keeps them in bf16. MViTv2's relative
position biases and residual pooling reach every attention (the reversible
walk's too); DIM_MUL_IN_ATT the plain walk's blocks and the schedule's
width rule; MVIT.USE_FIXED_SINCOS_POS adds the fixed 3-D sin-cos table in
place of the learned ones. MVIT.MODE, POOL_FIRST, SEPARATE_QKV and
DROPOUT_RATE reach every block, plain, reversible and transition;
LAYER_SCALE_INIT_VALUE the plain blocks and the reversible sub-blocks (as in
JAX, the transitions have no gammas). MVIT.DROPOUT_RATE also drops after the
position embeddings, and each block's dropouts draw from a generator seeded
by a number the model drew before any block ran. MVIT.NORM_STEM normalises
the tokens before the blocks; MVIT.REV.RES_PATH 'max' max-pools a
transition's residual at kernel s + 1 where its stride s > 1; the head's
projection starts at MVIT.HEAD_INIT_SCALE times its init. Under MODEL_NAME
ContrastiveModel the head is the CONTRASTIVE.DIM MLP projector
(CONTRASTIVE.NUM_MLP_LAYERS, MLP_DIM, BN_MLP with per-view statistics), with
no predictor, as in JAX.

Model parallelism (JAX ``mvit.py:55-66``, ``:507-560``): under MVIT.SEQ_SHARD
a block with no cls token and no relative position bias whose input holds
at least SEQ_SHARD_MIN_TOKENS tokens takes the attention's sequence-parallel
branch over 'seq' (:func:`block_seq_axis`). Under TPU.MESH_PIPE with a
'pipe' group of more than one rank, each reversible segment whose length
the pipe size divides runs GPipe (``parallel/pipeline.py``): stage s runs
its contiguous block range through the reversible walk on microbatches of
TPU.PIPE_MICROBATCH (0: the smallest divisor of the rows no smaller than
the pipe size); microbatch m takes its rows of the drop-path keep masks
drawn for the whole batch, and seeds its dropout generators with m folded
in. A segment the pipe size does not divide runs on every stage as without
the pipe; a pipe size that divides no segment raises, as in JAX.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from advise_tpu_torch.models.layers.attention import MultiScaleAttention, MultiScaleBlock, pool_tokens
from advise_tpu_torch.models.layers.common import (
    DropPath,
    Mlp,
    TwoStreamFusion,
    dense,
    draw_keep,
    draw_seeds,
    dropout,
    layer_norm,
    layer_scale_gamma,
    seeded_generator_from,
    trunc02,
)
from advise_tpu_torch.models.layers.heads import TransformerBasicHead
from advise_tpu_torch.models.layers.norm import head_sync_axes
from advise_tpu_torch.models.layers.stem import PatchEmbed
from advise_tpu_torch.models.utils import get_3d_sincos_pos_embed, round_width
from advise_tpu_torch.parallel.collectives import world_size
from advise_tpu_torch.parallel.mesh import PIPE_AXIS, SEQ_AXIS
from advise_tpu_torch.parallel.pipeline import gpipe, resolve_microbatches, stage_slice, sync_cotangents
from advise_tpu_torch.parallel.reversible import reversible_block_scan


def mvit_block_schedule(cfg, patch_dims=None):
    """Per-depth dict of dim, dim_out, num_heads, input_size, kernel_q,
    kernel_kv, stride_q, stride_kv, and the final width: the JAX package's
    schedule, including its head count, which does not carry the previous
    block's heads forward."""
    depth = cfg.MVIT.DEPTH
    embed_dim = cfg.MVIT.EMBED_DIM
    num_heads = cfg.MVIT.NUM_HEADS
    dim_mul = np.ones(depth + 1)
    head_mul = np.ones(depth + 1)
    for d, m in cfg.MVIT.DIM_MUL:
        dim_mul[d] = m
    for d, m in cfg.MVIT.HEAD_MUL:
        head_mul[d] = m

    pool_q = [[] for _ in range(depth)]
    pool_kv = [[] for _ in range(depth)]
    stride_q = [[] for _ in range(depth)]
    stride_kv = [[] for _ in range(depth)]
    for entry in cfg.MVIT.POOL_Q_STRIDE:
        i = entry[0]
        stride_q[i] = list(entry[1:])
        pool_q[i] = (
            list(cfg.MVIT.POOL_KVQ_KERNEL)
            if cfg.MVIT.POOL_KVQ_KERNEL is not None
            else [s + 1 if s > 1 else s for s in entry[1:]]
        )
    kv_entries = list(cfg.MVIT.POOL_KV_STRIDE)
    if cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE is not None:
        _stride_kv = list(cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE)
        kv_entries = []
        for i in range(depth):
            if len(stride_q[i]) > 0:
                _stride_kv = [max(_stride_kv[d] // stride_q[i][d], 1) for d in range(len(_stride_kv))]
            kv_entries.append([i] + _stride_kv)
    for entry in kv_entries:
        i = entry[0]
        stride_kv[i] = list(entry[1:])
        pool_kv[i] = (
            list(cfg.MVIT.POOL_KVQ_KERNEL)
            if cfg.MVIT.POOL_KVQ_KERNEL is not None
            else [s + 1 if s > 1 else s for s in entry[1:]]
        )

    patch_stride = list(cfg.MVIT.PATCH_STRIDE)
    if cfg.MVIT.PATCH_2D:
        patch_stride = [1] + patch_stride
    if patch_dims is not None:
        input_size = list(patch_dims)
    else:
        input_size = [
            cfg.DATA.NUM_FRAMES // patch_stride[0],
            cfg.DATA.TRAIN_CROP_SIZE // patch_stride[1],
            cfg.DATA.TRAIN_CROP_SIZE // patch_stride[2],
        ]

    blocks = []
    dim = embed_dim
    for i in range(depth):
        heads = round_width(num_heads, head_mul[i])
        if cfg.MVIT.DIM_MUL_IN_ATT:
            dim_out = round_width(dim, dim_mul[i], divisor=heads)
        else:
            dim_out = round_width(dim, dim_mul[i + 1],
                                  divisor=round_width(num_heads, head_mul[i + 1]))
        blocks.append(dict(dim=dim, dim_out=dim_out, num_heads=heads,
                           input_size=list(input_size), kernel_q=pool_q[i],
                           kernel_kv=pool_kv[i], stride_q=stride_q[i], stride_kv=stride_kv[i]))
        if len(stride_q[i]) > 0:
            # the conv-arithmetic grid (pad k // 2), not size // stride
            input_size = [(size + 2 * (k // 2) - k) // s + 1
                          for size, k, s in zip(input_size, pool_q[i], stride_q[i])]
        dim = dim_out
    return blocks, dim


def pooled_thw(thw, kernel, stride) -> Tuple[int, int, int]:
    """Conv-arithmetic output grid of a padded pool (pad k // 2)."""
    if not stride:
        return tuple(thw)
    return tuple((n + 2 * (k // 2) - k) // s + 1 for n, k, s in zip(thw, kernel, stride))


def patch_grid(cfg) -> Tuple[int, int, int]:
    """The PatchEmbed conv's output grid for DATA.NUM_FRAMES x
    DATA.TRAIN_CROP_SIZE^2 clips."""
    size = (cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.TRAIN_CROP_SIZE)
    return tuple((n + 2 * p - k) // s + 1 for n, k, s, p in zip(
        size, cfg.MVIT.PATCH_KERNEL, cfg.MVIT.PATCH_STRIDE, cfg.MVIT.PATCH_PADDING))


def fused_width(mode: str, dim: int) -> int:
    """Width of TwoStreamFusion(mode) applied to two streams of width dim."""
    return 2 * dim if mode == "concat" else dim


def block_seq_axis(cfg, spec) -> Optional[str]:
    """'seq' for a block that takes the sequence-parallel branch under
    MVIT.SEQ_SHARD: no cls token, no relative position bias, and at least
    SEQ_SHARD_MIN_TOKENS tokens in its input."""
    m = cfg.MVIT
    if not m.SEQ_SHARD or m.CLS_EMBED_ON or m.REL_POS_SPATIAL or m.REL_POS_TEMPORAL:
        return None
    if math.prod(spec["input_size"]) < m.SEQ_SHARD_MIN_TOKENS:
        return None
    return SEQ_AXIS


def fold_seed(seed: Optional[int], m: int) -> Optional[int]:
    """The seed of a dropout generator for microbatch ``m`` of a pipelined
    segment (JAX folds the microbatch index into the block's key)."""
    if seed is None:
        return None
    return (int(seed) * 1_000_003 + m + 1) % 2**62


def _attention_kwargs(cfg, spec, dtype) -> dict:
    m = cfg.MVIT
    return dict(seq_axis=block_seq_axis(cfg, spec), qkv_bias=m.QKV_BIAS, kernel_q=spec["kernel_q"], kernel_kv=spec["kernel_kv"],
                stride_q=spec["stride_q"], stride_kv=spec["stride_kv"],
                flash=bool(cfg.TPU.FLASH_ATTENTION),
                flash_native_dim_only=bool(cfg.TPU.FLASH_NATIVE_DIM_ONLY), dtype=dtype,
                input_size=tuple(spec["input_size"]), rel_pos_spatial=bool(m.REL_POS_SPATIAL),
                rel_pos_temporal=bool(m.REL_POS_TEMPORAL), rel_pos_zero_init=bool(m.REL_POS_ZERO_INIT),
                residual_pooling=bool(m.RESIDUAL_POOLING), mode=m.MODE, pool_first=bool(m.POOL_FIRST),
                separate_qkv=bool(m.SEPARATE_QKV), drop_rate=float(m.DROPOUT_RATE))


def init_div(cfg, i: int) -> float:
    """MASK.SCALE_INIT_BY_DEPTH (MAE's fix_init_weight): block ``i``'s
    attention projection and fc2 start divided by sqrt(2 (i + 1))."""
    return (2.0 * (i + 1)) ** 0.5 if (cfg.MASK.ENABLE and cfg.MASK.SCALE_INIT_BY_DEPTH) else 1.0


class RevAttnSub(nn.Module):
    """F of the reversible coupling: norm1 -> pooled attention (width kept,
    no Q pooling, no cls token) -> times ``gamma_1`` (layer scale) -> drop
    path; the attention's dropout draws from a generator seeded by
    ``seed``."""

    def __init__(self, spec: dict, drop_path: float, layer_scale: float = 0.0, **kw):
        super().__init__()
        dim = spec["dim"]
        self.norm1 = layer_norm(dim)
        self.attn = MultiScaleAttention(dim, dim, spec["num_heads"], has_cls_embed=False, **kw)
        self.thw = tuple(spec["input_size"])
        layer_scale_gamma(self, "gamma_1", dim, layer_scale)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        out = self.attn(self.norm1(x), self.thw, generator=seeded_generator_from(seed, x.device))[0]
        if hasattr(self, "gamma_1"):
            out = self.gamma_1 * out
        return self.drop_path(out, keep)


class RevMlpSub(nn.Module):
    """G of the reversible coupling: norm2 -> MLP (dropout from a generator
    seeded by ``seed``) -> times ``gamma_2`` -> drop path."""

    def __init__(self, dim: int, mlp_ratio: float, drop_path: float, layer_scale: float = 0.0,
                 drop_rate: float = 0.0):
        super().__init__()
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop_rate=drop_rate)
        layer_scale_gamma(self, "gamma_2", dim, layer_scale)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        out = self.mlp(self.norm2(x), seeded_generator_from(seed, x.device))
        if hasattr(self, "gamma_2"):
            out = self.gamma_2 * out
        return self.drop_path(out, keep)


class StageTransitionBlock(nn.Module):
    """The non-reversible block between segments: fuse the two streams
    (MVIT.REV.PRE_Q_FUSION), project the residual when the width changes
    (after its pooling under POOL_FIRST, before it otherwise), pool it
    through the attention's own pool_q and norm_q (RES_PATH 'conv') or a max
    pool of kernel s + 1 where the stride s > 1 ('max'), add attention, then
    the MLP; drop path on the whole output; the dropouts from a generator
    seeded by ``seed``."""

    def __init__(self, spec: dict, mlp_ratio: float, drop_path: float, pre_q_fusion: str,
                 res_path: str = "conv", **kw):
        super().__init__()
        if res_path not in ("conv", "max"):
            raise NotImplementedError(f"MVIT.REV.RES_PATH={res_path}")
        dim, dim_out = spec["dim"], spec["dim_out"]
        self.res_path, self.pool_first = res_path, bool(kw.get("pool_first", False))
        self.stride_q = tuple(spec["stride_q"])
        self.pre_q_fuse = TwoStreamFusion(pre_q_fusion)
        if dim != dim_out:
            self.res_proj = dense(dim, dim_out, init=trunc02)
        self.norm1 = layer_norm(dim)
        self.attn = MultiScaleAttention(dim, dim_out, spec["num_heads"], has_cls_embed=False, **kw)
        self.norm2 = layer_norm(dim_out)
        self.mlp = Mlp(dim_out, int(dim_out * mlp_ratio), dim_out, drop_rate=kw.get("drop_rate", 0.0))
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, thw: Sequence[int], keep: Optional[torch.Tensor] = None,
                seed: Optional[int] = None):
        gen = seeded_generator_from(seed, x.device)
        x = self.pre_q_fuse(x)
        proj = hasattr(self, "res_proj")
        x_res = self.res_proj(x) if proj and not self.pool_first else x
        if self.res_path == "conv":
            x_block, thw_new, x_res = self.attn(self.norm1(x), thw, x_res=x_res, generator=gen)
        else:
            x_block, thw_new = self.attn(self.norm1(x), thw, generator=gen)
            if self.stride_q and math.prod(self.stride_q) > 1:
                kernel = tuple(s + 1 if s > 1 else s for s in self.stride_q)
                x_res = pool_tokens(x_res[:, None], thw, kernel, self.stride_q, False)[0][:, 0]
        if proj and self.pool_first:
            x_res = self.res_proj(x_res)
        x = x_res + x_block
        x = x + self.mlp(self.norm2(x), gen)
        return self.drop_path(x, keep), thw_new


def _call_sub(mods: nn.ModuleList, keeps: List[Optional[torch.Tensor]], k: int, x: torch.Tensor,
              seeds: Optional[List[Optional[int]]] = None):
    return mods[k](x, keeps[k], None if seeds is None else seeds[k])


def _call_first(blk: nn.Module, thw, keeps, x: torch.Tensor, seed: Optional[int] = None):
    return blk(x, thw, keeps, seed)[0]


class MViT(nn.Module):
    """PatchEmbed -> (mask tokens) -> cls token / position embeddings ->
    dropout (MVIT.DROPOUT_RATE) -> LayerNorm (MVIT.NORM_STEM) -> blocks
    (plain or reversible walk) -> pooled LayerNorm -> head (the contrastive
    projector under ContrastiveModel).

    ``return_intermediate`` (MaskMViT's pretrain depths) makes the forward
    return [(tokens, thw)] at those depths instead; in the reversible walk a
    depth must end a uniform segment or be a transition, and the two streams
    fuse through MVIT.REV.RESPATH_FUSE. ``intermediate_dims`` holds their
    widths."""

    def __init__(self, cfg, norm=None, dtype: Optional[torch.dtype] = None,
                 include_head: bool = True, depth_override: Optional[int] = None,
                 return_intermediate: Sequence[int] = ()):
        super().__init__()
        m = cfg.MVIT
        self.include_head = include_head
        self.return_intermediate = tuple(return_intermediate)
        depth = depth_override or m.DEPTH
        embed_dim = m.EMBED_DIM
        self.cls_on = m.CLS_EMBED_ON
        self.patch_embed = PatchEmbed(cfg.DATA.INPUT_CHANNEL_NUM[0], embed_dim, m.PATCH_KERNEL,
                                      m.PATCH_STRIDE, m.PATCH_PADDING)
        t, h, w = patch_grid(cfg)
        schedule, final_dim = mvit_block_schedule(cfg, (t, h, w))
        self.schedule = schedule[:depth]
        if depth_override:
            final_dim = self.schedule[-1]["dim_out"]
        self.dpr = [float(r) for r in np.linspace(0, m.DROPPATH_RATE, m.DEPTH)]
        self.drop_rate = float(m.DROPOUT_RATE)
        if m.NORM_STEM:
            self.norm_stem = layer_norm(embed_dim)

        self.param_inits = {}
        n_cls = 1 if self.cls_on else 0

        def free_param(name, shape):
            setattr(self, name, nn.Parameter(torch.zeros(shape)))
            self.param_inits[name] = trunc02

        if self.cls_on:
            free_param("cls_token", (1, 1, embed_dim))
        self.abs_pos, self.sep_pos = bool(m.USE_ABS_POS), bool(m.SEP_POS_EMBED)
        self.fixed_pos = bool(m.USE_FIXED_SINCOS_POS)
        if self.fixed_pos:  # added to the patch tokens whatever USE_ABS_POS says, as in JAX
            self.register_buffer("sincos_pos", torch.from_numpy(
                get_3d_sincos_pos_embed(embed_dim, h, t)[None]), persistent=False)
        elif self.abs_pos:
            if self.sep_pos:
                free_param("pos_embed_spatial", (1, h * w, embed_dim))
                free_param("pos_embed_temporal", (1, t, embed_dim))
                if self.cls_on:
                    free_param("pos_embed_class", (1, 1, embed_dim))
            else:
                free_param("pos_embed", (1, t * h * w + n_cls, embed_dim))

        self.rev = bool(m.REV.ENABLE)
        self.o1_scan = bool(m.REV.O1_SCAN)
        self.pipe = max(int(cfg.TPU.MESH_PIPE or 1), 1)
        self.pipe_microbatch = int(cfg.TPU.PIPE_MICROBATCH or 0)
        self.remat = bool(cfg.TPU.REMAT or cfg.MODEL.ACT_CHECKPOINT)
        self.plan: List[tuple] = []
        self.intermediate_dims: Dict[int, int] = {}
        ri = self.return_intermediate
        if self.rev:
            if self.cls_on:
                raise ValueError("reversible MViT requires CLS_EMBED_ON=False")
            buffer_layers = {int(b) for b in m.REV.BUFFER_LAYERS}
            i = seg_id = 0
            while i < len(self.schedule):
                spec = self.schedule[i]
                uniform = (spec["dim"] == spec["dim_out"]
                           and (len(spec["stride_q"]) == 0 or math.prod(spec["stride_q"]) == 1)
                           and i not in buffer_layers)
                kw = _attention_kwargs(cfg, spec, dtype)
                if not uniform:
                    self.add_module(f"blocks_{i}", StageTransitionBlock(
                        spec, m.MLP_RATIO, self.dpr[i], m.REV.PRE_Q_FUSION, m.REV.RES_PATH, **kw))
                    self.plan.append(("transition", i))
                    if i in ri:
                        self.intermediate_dims[i] = spec["dim_out"]
                    i += 1
                    continue
                j = i
                while j < len(self.schedule) and self.schedule[j] == spec and j not in buffer_layers:
                    j += 1
                inside = [d for d in ri if i <= d < j - 1]
                if inside:
                    raise ValueError(
                        f"return_intermediate depths {inside} fall inside the reversible "
                        f"segment [{i},{j}); with MVIT.REV.ENABLE only segment-boundary "
                        "depths are materialized")
                ls = float(m.LAYER_SCALE_INIT_VALUE)
                self.add_module(f"rev_seg{seg_id}_f", nn.ModuleList([
                    RevAttnSub(spec, self.dpr[d], ls, **kw) for d in range(i, j)]))
                self.add_module(f"rev_seg{seg_id}_g", nn.ModuleList([
                    RevMlpSub(spec["dim"], m.MLP_RATIO, self.dpr[d], ls, self.drop_rate)
                    for d in range(i, j)]))
                if j - 1 in ri:
                    self.add_module(f"fuse_inter_{seg_id}", TwoStreamFusion(m.REV.RESPATH_FUSE))
                    self.intermediate_dims[j - 1] = fused_width(m.REV.RESPATH_FUSE, spec["dim"])
                self.plan.append(("segment", seg_id, i, j))
                seg_id += 1
                i = j
            if not ri:
                self.fuse = TwoStreamFusion(m.REV.RESPATH_FUSE)
                final_dim = fused_width(m.REV.RESPATH_FUSE, final_dim)
                self.norm = layer_norm(final_dim)
        else:
            for i, spec in enumerate(self.schedule):
                self.add_module(f"blocks_{i}", MultiScaleBlock(
                    spec["dim"], spec["dim_out"], spec["num_heads"], m.MLP_RATIO,
                    drop_path=self.dpr[i], has_cls_embed=self.cls_on,
                    dim_mul_in_att=bool(m.DIM_MUL_IN_ATT), init_div=init_div(cfg, i),
                    layer_scale_init_value=float(m.LAYER_SCALE_INIT_VALUE),
                    **_attention_kwargs(cfg, spec, dtype)))
                self.plan.append(("block", i))
                if i in ri:
                    self.intermediate_dims[i] = spec["dim_out"]
            self.use_mean_pooling = bool(m.USE_MEAN_POOLING)
            if not ri and include_head:
                self.norm = layer_norm(final_dim)
        if not ri and include_head:
            contrastive = cfg.MODEL.MODEL_NAME == "ContrastiveModel"
            c = cfg.CONTRASTIVE
            self.head = TransformerBasicHead(
                final_dim, c.DIM if contrastive else cfg.MODEL.NUM_CLASSES,
                dropout_rate=cfg.MODEL.DROPOUT_RATE, act_func=cfg.MODEL.HEAD_ACT,
                detach_final_fc=cfg.MODEL.DETACH_FINAL_FC,
                num_mlp_layers=c.NUM_MLP_LAYERS if contrastive else 1, mlp_dim=c.MLP_DIM,
                bn_mlp=bool(c.BN_MLP) if contrastive else False, head_init_scale=m.HEAD_INIT_SCALE,
                bn_sync_axes=head_sync_axes(norm, contrastive and c.BN_SYNC_MLP))

    def _keeps(self, b: int, generator: Optional[torch.Generator]) -> Dict[int, tuple]:
        """The stochastic-depth keep masks of this forward, in block order:
        one per transition, two (attention, MLP) per other block."""
        if not self.training:
            return {}
        out = {}
        for item in self.plan:
            if item[0] == "segment":
                blocks = range(item[2], item[3])
            else:
                blocks = [item[1]]
            for i in blocks:
                n = 1 if item[0] == "transition" else 2
                out[i] = tuple(draw_keep(b, self.dpr[i], generator) for _ in range(n))
        return out

    def _seeds(self, generator: Optional[torch.Generator]) -> Dict[int, tuple]:
        """The seeds of this forward's dropout generators, in block order,
        all drawn in one call before any block runs: one per plain block or
        transition, two (attention, MLP) per reversible block; none in
        evaluation or without MVIT.DROPOUT_RATE."""
        if not self.training or self.drop_rate <= 0.0:
            return {}
        counts = {}
        for item in self.plan:
            if item[0] == "segment":
                counts.update({i: 2 for i in range(item[2], item[3])})
            else:
                counts[item[1]] = 1
        flat = iter(draw_seeds(sum(counts.values()), generator))
        return {i: tuple(next(flat) for _ in range(n)) for i, n in counts.items()}

    def _pipelined_segment(self, fs, gs, kf, kg, sf, sg, x1, x2):
        """One reversible segment under GPipe over 'pipe' (module
        docstring): its parameters and inputs through ``sync_cotangents``,
        this stage's blocks run on those tensors (``functional_call``)."""
        subs = [m for k in range(len(fs)) for m in (fs[k], gs[k])]
        names = [[n for n, _ in m.named_parameters()] for m in subs]
        synced = sync_cotangents([p for m in subs for p in m.parameters()] + [x1, x2], PIPE_AXIS)
        views, at = [], 0
        for ns in names:
            views.append(dict(zip(ns, synced[at:at + len(ns)])))
            at += len(ns)
        x1, x2 = synced[-2:]
        first, end = stage_slice(fs, self.pipe, PIPE_AXIS)
        n_micro = resolve_microbatches(self.pipe_microbatch, x1.shape[0], self.pipe)
        bm = x1.shape[0] // n_micro

        def rows(keep, m):
            return None if keep is None else keep[m * bm:(m + 1) * bm]

        def stage(pair, m):
            def f(k, x):
                k += first
                return torch.func.functional_call(fs[k], views[2 * k], (x, rows(kf[k], m), fold_seed(sf[k], m)))

            def g(k, x):
                k += first
                return torch.func.functional_call(gs[k], views[2 * k + 1],
                                                  (x, rows(kg[k], m), fold_seed(sg[k], m)))

            a1, a2 = pair
            if self.o1_scan:
                block = [list(views[2 * k].values()) + list(views[2 * k + 1].values()) for k in range(first, end)]
                return reversible_block_scan(f, g, block, a1, a2)
            for k in range(end - first):
                a1 = a1 + f(k, a2)
                a2 = a2 + g(k, a1)
            return a1, a2

        return gpipe(stage, (x1, x2), n_stage=self.pipe, n_micro=n_micro, axes=PIPE_AXIS)

    def forward(self, x: torch.Tensor, views: int = 1, generator: Optional[torch.Generator] = None,
                token_mask: Optional[torch.Tensor] = None,
                mask_token: Optional[torch.Tensor] = None):
        """x: clips [B, T, H, W, 3]; ``views`` splits the contrastive head's
        BN statistics; ``generator`` draws the dropout and drop-path masks
        in training; ``token_mask`` [B, t*h*w] (True = masked) replaces
        those tokens with ``mask_token`` before the position embeddings."""
        x, (t, h, w) = self.patch_embed(x)
        b = x.shape[0]
        if token_mask is not None and mask_token is not None:
            x = torch.where(token_mask[..., None], mask_token.to(x.dtype), x)
        if self.fixed_pos:
            x = x + self.sincos_pos
        if self.cls_on:
            x = torch.cat([self.cls_token.expand(b, -1, -1).to(x.dtype), x], dim=1)
        if self.abs_pos and not self.fixed_pos:
            if self.sep_pos:
                pe = (self.pos_embed_spatial.repeat(1, t, 1)
                      + torch.repeat_interleave(self.pos_embed_temporal, h * w, dim=1))
                if self.cls_on:
                    pe = torch.cat([self.pos_embed_class, pe], dim=1)
            else:
                pe = self.pos_embed
            x = x + pe
        if self.training and self.drop_rate > 0.0:
            x = dropout(x, self.drop_rate, generator)
        if hasattr(self, "norm_stem"):
            x = self.norm_stem(x)
        keeps = self._keeps(b, generator)
        seeds = self._seeds(generator)
        thw = (t, h, w)
        inter = []
        if self.rev:
            x1 = x2 = x
            pipelined: List[int] = []  # the lengths of the segments that ran under GPipe
            for item in self.plan:
                if item[0] == "transition":
                    i = item[1]
                    spec = self.schedule[i]
                    blk = getattr(self, f"blocks_{i}")
                    run = functools.partial(_call_first, blk, thw, keeps.get(i, (None,))[0],
                                            seed=seeds.get(i, (None,))[0])
                    inp = torch.cat([x1, x2], dim=-1)
                    out = checkpoint(run, inp, use_reentrant=False) if self.remat else run(inp)
                    x1 = x2 = out
                    thw = pooled_thw(thw, spec["kernel_q"], spec["stride_q"])
                    if i in self.return_intermediate:
                        inter.append((out, thw))
                    continue
                _, seg_id, i, j = item
                fs = getattr(self, f"rev_seg{seg_id}_f")
                gs = getattr(self, f"rev_seg{seg_id}_g")
                kf = [keeps.get(d, (None, None))[0] for d in range(i, j)]
                kg = [keeps.get(d, (None, None))[1] for d in range(i, j)]
                sf = [seeds.get(d, (None, None))[0] for d in range(i, j)]
                sg = [seeds.get(d, (None, None))[1] for d in range(i, j)]
                f = functools.partial(_call_sub, fs, kf, seeds=sf)
                g = functools.partial(_call_sub, gs, kg, seeds=sg)
                if self.pipe > 1 and world_size(PIPE_AXIS) > 1 and (j - i) % self.pipe == 0:
                    x1, x2 = self._pipelined_segment(fs, gs, kf, kg, sf, sg, x1, x2)
                    pipelined.append(j - i)
                elif self.o1_scan:
                    params = [list(fs[k].parameters()) + list(gs[k].parameters())
                              for k in range(j - i)]
                    x1, x2 = reversible_block_scan(f, g, params, x1, x2)
                else:  # plain autograd through the same coupling
                    for k in range(j - i):
                        x1 = x1 + f(k, x2)
                        x2 = x2 + g(k, x1)
                if j - 1 in self.return_intermediate:
                    fuse = getattr(self, f"fuse_inter_{seg_id}")
                    inter.append((fuse(torch.cat([x1, x2], dim=-1)), thw))
            if self.pipe > 1 and world_size(PIPE_AXIS) > 1:
                lens = [item[3] - item[2] for item in self.plan if item[0] == "segment"]
                assert pipelined, (
                    f"TPU.MESH_PIPE={self.pipe} divides none of the reversible segment lengths {lens} — "
                    "every segment would fall back to replicated compute. Pick a pipe size that divides "
                    "a segment, or force a split with MVIT.REV.BUFFER_LAYERS")
            if self.return_intermediate:
                return inter
            x = self.norm(self.fuse(torch.cat([x1, x2], dim=-1)).mean(dim=1))
        else:
            for _, i in self.plan:
                spec = self.schedule[i]
                blk = getattr(self, f"blocks_{i}")
                run = functools.partial(_call_first, blk, thw, keeps.get(i, (None, None)),
                                        seed=seeds.get(i, (None,))[0])
                x = checkpoint(run, x, use_reentrant=False) if self.remat else run(x)
                thw = pooled_thw(thw, spec["kernel_q"], spec["stride_q"])
                if i in self.return_intermediate:
                    inter.append((x, thw))
            if self.return_intermediate:
                return inter
            if not self.include_head:
                return x, thw
            if self.use_mean_pooling:
                x = self.norm((x[:, 1:] if self.cls_on else x).mean(dim=1))
            elif self.cls_on:
                x = self.norm(x)[:, 0]
            else:
                x = self.norm(x).mean(dim=1)
        if not self.include_head:
            return x
        return self.head(x, generator, views)
