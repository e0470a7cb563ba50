"""Bridge from the JAX package's Flax trees (as numpy) to the port's
``state_dict`` names and layouts.

The port names its modules as the Flax modules are named, so a Flax path
``backbone/s2/pathway0_res0/branch2/a/kernel`` becomes the torch key
``backbone.s2.pathway0_res0.branch2.a.weight``. Leaves map as:

- conv ``kernel`` DHWIO ``[kt, kh, kw, I, O]`` -> ``weight`` OIDHW, and the
  2-D HWIO ``[kh, kw, I, O]`` (CLIP's patch conv) -> OIHW;
- Dense ``kernel`` ``[in, out]`` -> Linear ``weight`` ``[out, in]``;
- the attention's DenseGeneral kernels -> Linear weights: ``query``/
  ``key``/``value`` ``[width, heads, hd]`` -> ``[heads * hd, width]`` with
  their ``[heads, hd]`` biases flattened, ``out`` ``[heads, hd, width]`` ->
  ``[width, heads * hd]``;
- BN and LayerNorm ``scale``/``bias`` -> ``weight``/``bias``, and the batch
  statistics ``mean``/``var`` -> ``running_mean``/``running_var``;
- a free parameter (``mask_token``, ``pos_embed_spatial``,
  ``class_embedding``, ``positional_embedding``, ``proj``, SwAV's
  ``swav_prototypes``, ...) keeps its name and layout;
- the reversible MViT's stacked segment parameters (``rev_seg{n}_f`` /
  ``rev_seg{n}_g``, one slice per block on axis 0) -> one module per block,
  ``rev_seg{n}_f.{k}.`` ...; the depthwise pool convs' DHWIO kernels
  ``[k, k, k, 1, C]`` map like every conv.

MaskMViT's MAE tree needs no rule of its own either: ``patch_embed/proj``,
``pos_embed``, ``blocks_{i}``, ``norm``, ``decoder_embed``, ``mask_token``,
``decoder_pos_embed`` (or ``dec_pos_embed_spatial`` / ``_temporal``) and
``pred_head/transform_{i}``, ``pred_head/norm``, ``pred_head/projection``
map by the rules above, as do MViTv2's ``attn/rel_pos_h``, ``rel_pos_w``
and ``rel_pos_t`` (free parameters) and the DIM_MUL_IN_ATT block's
``proj``.

MViT's other knobs map by the same rules: SEPARATE_QKV's and POOL_FIRST's
``attn/q``, ``attn/k``, ``attn/v`` (plain Dense), the pools of MODE
'conv_unshared' (depthwise convs like 'conv''s), ``norm_stem``, the
layer-scale ``gamma_1`` / ``gamma_2`` (free parameters, stacked in a
reversible segment like the rest of it), PATCH_2D's patch conv, and
ContrastiveModel's ``backbone/...`` over MViT, reversible stacks included.

The stem's weight is the plain ``[kt, 7, 7, C, O]`` ``conv/kernel`` on the
space-to-depth path too, so it maps like every other conv. X3D's and the
Nonlocal block's leaves need no rule of their own: the channelwise
kernels ``[kt, kh, kw, 1, C]`` (``conv_xy``'s neighbour ``conv``, the
bottlenecks' ``b``) become ``[C, 1, kt, kh, kw]``, and SE's ``fc1``/``fc2``,
the Nonlocal ``theta``/``phi``/``g``/``out`` with their biases, ``out_bn``,
the head's ``conv_5``/``lin_5`` and ``projection`` map like any conv, BN
and Dense.

A module split for TPU.PARTITION_MODE 'auto' takes JAX's trees through
:func:`flax_to_sharded` (each rank cuts its shards from the whole tensors).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_STACKED = re.compile(r"^rev_seg\d+_[fg]$")
_QKV = ("query", "key", "value")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _param_leaf(path: Tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    name = path[-1]
    if name == "kernel" and arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    if name == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if name == "kernel" and arr.ndim == 3:  # an attention DenseGeneral
        flat = arr.reshape(-1, arr.shape[-1]) if path[-2] == "out" else arr.reshape(arr.shape[0], -1)
        return flat.T
    if name == "kernel" and arr.ndim == 2:
        return arr.T
    if name == "bias" and arr.ndim == 2 and path[-2] in _QKV:
        return arr.reshape(-1)
    return arr


def param_key(path: Tuple[str, ...]) -> str:
    """Torch name of the Flax param at ``path``."""
    return ".".join(path[:-1] + (_PARAM_NAMES.get(path[-1], path[-1]),))


def _unstack(path: Tuple[str, ...], arr: np.ndarray):
    """(path, leaf) pairs of one Flax leaf: itself, or one per block when it
    lies under a stacked reversible segment."""
    at = next((i for i, p in enumerate(path) if _STACKED.match(p)), None)
    if at is None:
        yield path, arr
        return
    for k in range(arr.shape[0]):
        yield path[: at + 1] + (str(k),) + path[at + 1:], arr[k]


def params_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax params tree (or any tree shaped like it, such as the momentum
    trace or Adam's moments) -> {torch param name: tensor} in torch layouts."""
    return {
        param_key(p): torch.from_numpy(np.array(_param_leaf(p, a)))
        for path, v in _flatten(params)
        for p, a in _unstack(path, np.asarray(v))
    }


def batch_stats_to_torch(batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    return {
        ".".join(path[:-1] + (_STAT_NAMES[path[-1]],)): torch.from_numpy(np.array(v))
        for path, v in _flatten(batch_stats)
    }


def flax_to_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``params`` + ``batch_stats`` -> the port's model ``state_dict``."""
    return {**params_to_torch(params), **batch_stats_to_torch(batch_stats)}


def flax_to_sharded(module, params: Mapping, batch_stats: Mapping) -> None:
    """JAX's ``params`` and ``batch_stats`` (numpy trees) into ``module``
    laid out for TPU.PARTITION_MODE 'auto' (``parallel/auto_shard.py
    shard_module``): the whole tensors mapped as :func:`flax_to_state_dict`
    maps them, each rank keeping its shards of them."""
    from advise_tpu_torch.parallel.auto_shard import layout_of

    layout_of(module).load_full(flax_to_state_dict(params, batch_stats))


def convert_train_state(params: Mapping, batch_stats: Mapping,
                        momentum: Optional[Mapping] = None,
                        ssl: Optional[Mapping] = None) -> Dict[str, Any]:
    """The JAX train state -> the port's pieces:

    - ``model``: the online model's state_dict;
    - ``momentum``: {param name: tensor} from the optimizer's momentum trace
      (a tree shaped like ``params``);
    - ``ema``: the momentum encoder's state_dict from ``ssl['ema_params']``
      and ``ssl['ema_batch_stats']``;
    - ``knn_mem``, ``queue_x``, ``queue_swav``, ``memory``: the kNN bank,
      MoCo's and SwAV's queues and the memory bank, as they are;
    - ``ptr``: MoCo's pointer as int64 (int32 in JAX), ``swav_started`` a
      bool tensor;
    - ``ema_temporal`` and ``ema_projector``: the TemporalModel's BYOL twins,
      {name: tensor} relative to ``temporal_encoder`` and ``head_projector``.

    SwAV's ``swav_prototypes`` [DIM, 1000] is a free parameter of the model:
    it keeps its name and layout.
    """
    out: Dict[str, Any] = {"model": flax_to_state_dict(params, batch_stats)}
    if momentum is not None:
        out["momentum"] = params_to_torch(momentum)
    if ssl is not None:
        if "ema_params" in ssl:
            out["ema"] = flax_to_state_dict(ssl["ema_params"], ssl["ema_batch_stats"])
        for name in ("knn_mem", "queue_x", "queue_swav", "memory"):
            if name in ssl:
                out[name] = torch.from_numpy(np.array(ssl[name]))
        if "ptr" in ssl:
            out["ptr"] = torch.tensor(int(ssl["ptr"]), dtype=torch.int64)
        if "swav_started" in ssl:
            out["swav_started"] = torch.tensor(bool(ssl["swav_started"]))
        for twin in ("ema_temporal", "ema_projector"):
            if twin in ssl:
                out[twin] = params_to_torch(ssl[twin])
    return out
