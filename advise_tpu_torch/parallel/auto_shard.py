"""TPU.PARTITION_MODE 'auto': tensor parallelism over 'model' and FSDP over
'data' (counterpart of ``advise_tpu/parallel/auto_shard.py``).

The JAX package states the layout as parameter shardings and lets GSPMD
place the collectives; the step computes over logically global arrays what
the unsharded step computes over the global batch. The port places them by
hand, from the same rules:

- **Which tensors.** :func:`spec_for` is JAX's ``_spec_for`` over the JAX
  path and layout of each parameter (``solver/optimizer.py flax_path``;
  conv and dense kernels transposed, a reversible segment's blocks one
  stacked leaf): the attention's qkv / q / k / v and the MLP's fc1 (kernel
  and bias) column-parallel, the attention's proj and the MLP's fc2 kernel
  row-parallel over 'model' where the dim divides; with TPU.FSDP every
  tensor of at least ``_FSDP_MIN_ELEMENTS`` elements sharded over 'data' on
  its largest still-unsharded dim that divides. :func:`describe_sharding`
  counts tensor-parallel, FSDP and replicated leaves as JAX's does.
- **Tensor parallelism** is Megatron's head split (JAX splits the fused qkv
  kernel's last dim contiguously, a storage layout GSPMD reshards; the port
  computes only on whole heads). A rank keeps the rows of qkv (or q, k, v)
  and fc1 and the columns of proj and fc2 of its heads and hidden units
  (:func:`_split_module`); the modules (``models/layers/attention.py``,
  ``models/swin3d.py``, ``models/layers/common.py Mlp``) take their input
  through ``copy_to`` and sum proj's and fc2's partial products over
  'model' (``reduce_from``) before the bias; weights the heads share (the
  pools, their norms, the position tables) enter through ``copy_to``.
- **FSDP** is hand-placed: each rank stores its slice of the tensor
  (contiguous on the chosen dim of the tensor it computes with); the step
  gathers the whole tensor before the forward (:meth:`AutoLayout.gather`),
  averages the gradient over the batch and keeps its slice
  (:meth:`AutoLayout.shard_grads`, an all-reduce then a slice: the
  all-reduce is a collective gloo takes on CUDA tensors), and drops the
  whole tensor again (:meth:`AutoLayout.release`) before the optimizer,
  whose moments are slices too. Parameters and moments persist as slices;
  the whole parameters live only inside a step.
- **Norms** over sharded tensors (the global gradient norm, clipping,
  LARS's trust ratio) sum each tensor's squares over its slices
  (:meth:`AutoLayout.reduce_sq`, one all-reduce over the world).

BN statistics span the batch ('data', ``models/layers/norm.py get_norm``),
the contrastive gathers act over the 'data' ranks, and a checkpoint holds
whole tensors (:meth:`AutoLayout.full_state`), so it restores in a plain
run and the other way round (:meth:`AutoLayout.load_full`).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from advise_tpu_torch.parallel.collectives import pmean_tree
from advise_tpu_torch.parallel.mesh import BATCH_AXES, DATA_AXIS, MODEL_AXIS, WORLD_AXES, axis_group

_COLUMN_PARALLEL = re.compile(r"(^|/)(attn/(qkv|q|k|v)|mlp/fc1)/kernel$")
_COLUMN_BIAS = re.compile(r"(^|/)(attn/(qkv|q|k|v)|mlp/fc1)/bias$")
_ROW_PARALLEL = re.compile(r"(^|/)(attn/proj|mlp/fc2)/kernel$")
# tensors below this many elements stay whole: their gather costs more than they hold
_FSDP_MIN_ELEMENTS = 16384
_STACKED_BLOCK = re.compile(r"(^|\.)(rev_seg\d+_[fg])\.\d+\.")


def spec_for(path: str, shape: Tuple[int, ...], model: int, fsdp: int) -> Tuple[Optional[str], ...]:
    """JAX's ``_spec_for``: the mesh axis of each dim of the parameter at
    ``path`` with ``shape`` in JAX's layout; dims that do not divide stay
    whole."""
    ndim = len(shape)
    spec: List[Optional[str]] = [None] * ndim
    if model > 1 and ndim >= 1:
        if _COLUMN_PARALLEL.search(path) and shape[-1] % model == 0:
            spec[-1] = MODEL_AXIS
        elif _COLUMN_BIAS.search(path) and shape[-1] % model == 0:
            spec[-1] = MODEL_AXIS
        elif _ROW_PARALLEL.search(path) and ndim >= 2 and shape[0] % model == 0:
            spec[0] = MODEL_AXIS
    n = 1
    for s in shape:
        n *= s
    if fsdp > 1 and n >= _FSDP_MIN_ELEMENTS:
        for d in sorted(range(ndim), key=lambda d: -shape[d]):
            if spec[d] is None and shape[d] % fsdp == 0:
                spec[d] = DATA_AXIS
                break
    return tuple(spec)


def _jax_dims(name: str, p: torch.Tensor) -> Tuple[Tuple[int, ...], List[Optional[int]]]:
    """(the JAX leaf's shape, for each of its dims the port tensor's dim or
    None for a reversible segment's stack dim)."""
    if p.ndim == 5 and name.endswith("weight"):
        order = [2, 3, 4, 1, 0]  # OIDHW -> DHWIO
    elif p.ndim == 4 and name.endswith("weight"):
        order = [2, 3, 1, 0]  # OIHW -> HWIO
    elif p.ndim == 2 and name.endswith("weight"):
        order = [1, 0]  # Linear [out, in] -> Dense [in, out]
    else:
        order = list(range(p.ndim))
    shape = tuple(p.shape[d] for d in order)
    return shape, order


def leaf_name(name: str) -> str:
    """The JAX leaf a port parameter belongs to: a reversible segment's
    blocks share one."""
    return _STACKED_BLOCK.sub(r"\1\2.", name)


def param_specs(params: Dict[str, torch.Tensor], model: int, fsdp: int) -> Dict[str, Dict[str, Optional[int]]]:
    """{name: {'model': the port tensor's dim JAX shards over 'model' or
    None, 'data': its FSDP dim or None}} by JAX's rules on JAX's leaves (a
    reversible segment's blocks as one stacked leaf, the FSDP threshold on
    the stack's size). Where JAX shards a stack's block dim, the block's
    own largest dim that divides stands in for it."""
    from advise_tpu_torch.solver.optimizer import flax_path

    counts: Dict[str, int] = {}
    for name in params:
        counts[leaf_name(name)] = counts.get(leaf_name(name), 0) + 1
    out = {}
    for name, p in params.items():
        shape, order = _jax_dims(name, p)
        if leaf_name(name) != name:
            shape, order = (counts[leaf_name(name)],) + shape, [None] + order
        spec = spec_for(flax_path(name, p), shape, model, fsdp)
        dims = {}
        for axis, size in ((MODEL_AXIS, model), (DATA_AXIS, fsdp)):
            at = next((d for d, a in enumerate(spec) if a == axis), None)
            dim = None if at is None else order[at]
            if at is not None and dim is None:  # the stack's block dim
                local = list(p.shape)
                taken = [d for d in dims.values() if d is not None]
                dim = next((d for d in sorted(range(p.ndim), key=lambda d: -local[d])
                            if d not in taken and local[d] % size == 0), None)
            dims[axis] = dim
        out[name] = {"model": dims[MODEL_AXIS], "data": dims[DATA_AXIS]}
    return out


def describe_sharding(specs: Dict[str, Dict[str, Optional[int]]], limit: int = 10) -> Tuple[Dict[str, int], str]:
    """({'model', 'data', 'replicated'}: the count of JAX leaves of each
    kind, a reversible segment's blocks counting once) and the summary JAX
    logs at start-up."""
    counts = {"model": 0, "data": 0, "replicated": 0}
    lines, seen = [], set()
    for name, spec in specs.items():
        leaf = leaf_name(name)
        if leaf in seen:
            continue
        seen.add(leaf)
        kind = "model" if spec["model"] is not None else "data" if spec["data"] is not None else "replicated"
        counts[kind] += 1
        if kind != "replicated" and len(lines) < limit:
            lines.append(f"  {name} -> model dim {spec['model']}, data dim {spec['data']}")
    head = (f"auto-shard: {counts['model']} tensor-parallel, {counts['data']} fsdp, "
            f"{counts['replicated']} replicated params")
    return counts, "\n".join([head] + lines)


def _take(full: torch.Tensor, dim: int, groups: int, size: int, index: int) -> torch.Tensor:
    """Part ``index`` of ``size`` of ``full`` along ``dim`` viewed as
    ``(groups, size, chunk)`` (qkv's rows are (q, k, v) x heads: a rank's
    heads are one chunk of each of the 3 groups)."""
    shape = list(full.shape)
    view = full.reshape(shape[:dim] + [groups, size, shape[dim] // (groups * size)] + shape[dim + 1:])
    part = view.select(dim + 1, index)
    return part.reshape(shape[:dim] + [shape[dim] // size] + shape[dim + 1:]).contiguous()


def _assemble(parts: List[torch.Tensor], dim: int, groups: int) -> torch.Tensor:
    """The inverse of :func:`_take` over every part."""
    shape = list(parts[0].shape)
    views = [t.reshape(shape[:dim] + [groups, shape[dim] // groups] + shape[dim + 1:]) for t in parts]
    full = torch.stack(views, dim=dim + 1)
    return full.reshape(shape[:dim] + [shape[dim] * len(parts)] + shape[dim + 1:])


def _gather(t: torch.Tensor, axes, dim: int, groups: int = 1) -> torch.Tensor:
    group, size, _ = axis_group(axes)
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return _assemble(parts, dim, groups)


def _split_rows(fc: nn.Linear, dim: int, groups: int, size: int, index: int, bias: bool) -> None:
    with torch.no_grad():
        fc.weight = nn.Parameter(_take(fc.weight.data, dim, groups, size, index))
        if bias and fc.bias is not None:
            fc.bias = nn.Parameter(_take(fc.bias.data, 0, groups, size, index))


def _split_module(mod: nn.Module, size: int, index: int) -> Dict[str, Tuple[int, int]]:
    """Split ``mod`` (MultiScaleAttention, WindowAttention3D or Mlp) over
    'model' in place, keeping part ``index`` of ``size`` of its heads or
    hidden units; returns {its parameter name: (dim, groups)} of what was
    split."""
    from advise_tpu_torch.models.layers.attention import MultiScaleAttention
    from advise_tpu_torch.models.layers.common import Mlp
    from advise_tpu_torch.models.swin3d import WindowAttention3D

    if isinstance(mod, Mlp):
        hidden = mod.fc1.weight.shape[0]
        if hidden % size:
            raise ValueError(f"TPU.MESH_MODEL={size} does not divide the MLP's {hidden} hidden units")
        _split_rows(mod.fc1, 0, 1, size, index, bias=True)
        _split_rows(mod.fc2, 1, 1, size, index, bias=False)
        mod.tp = (MODEL_AXIS, size, index)
        return {"fc1.weight": (0, 1), "fc1.bias": (0, 1), "fc2.weight": (1, 1)}
    if not isinstance(mod, (MultiScaleAttention, WindowAttention3D)):
        raise NotImplementedError(f"tensor parallelism over {type(mod).__name__} is not ported")
    if mod.num_heads % size:
        raise ValueError(f"TPU.MESH_MODEL={size} does not divide the attention's {mod.num_heads} heads "
                         "(the port splits whole heads)")
    split = {}
    if getattr(mod, "separate_qkv", False) or getattr(mod, "pool_first", False):
        for name in ("q", "k", "v"):
            _split_rows(getattr(mod, name), 0, 1, size, index, bias=True)
            split.update({f"{name}.weight": (0, 1), f"{name}.bias": (0, 1)})
    else:
        _split_rows(mod.qkv, 0, 3, size, index, bias=True)
        split.update({"qkv.weight": (0, 3), "qkv.bias": (0, 3)})
    _split_rows(mod.proj, 1, 1, size, index, bias=False)
    split["proj.weight"] = (1, 1)
    mod.tp = (MODEL_AXIS, size, index)
    names = dict(mod.named_parameters())
    return {k: v for k, v in split.items() if k in names}


class AutoLayout:
    """Where each parameter of one module tree lives: {name: {'tp': (dim,
    groups) of a head split or None, 'store': the dim of a slice stored
    over 'model' or None, 'data': the FSDP dim or None}}, and the step's
    gather, gradient slicing, release and norms over it."""

    def __init__(self, model: nn.Module, entries: Dict[str, Dict[str, Any]]):
        self.model = model
        self.entries = entries
        self.params = dict(model.named_parameters())
        self.data = axis_group(DATA_AXIS)
        self.model_group = axis_group(MODEL_AXIS)
        self.gathered = False

    def _stored(self):
        return [n for n, e in self.entries.items() if e["store"] is not None or e["data"] is not None]

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A stored slice -> the tensor the step computes with."""
        e = self.entries[name]
        if e["data"] is not None:
            t = _gather(t, DATA_AXIS, e["data"])
        if e["store"] is not None:
            t = _gather(t, MODEL_AXIS, e["store"])
        return t

    def _slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The tensor the step computes with -> this rank's stored slice."""
        e = self.entries[name]
        if e["store"] is not None:
            t = _take(t, e["store"], 1, self.model_group[1], self.model_group[2])
        if e["data"] is not None:
            t = _take(t, e["data"], 1, self.data[1], self.data[2])
        return t

    @torch.no_grad()
    def gather(self) -> None:
        """Every stored slice made whole for the step."""
        if self.gathered:
            return
        for name in self._stored():
            p = self.params[name]
            full = self._whole(name, p.data)
            if p.dim() == 5 and p.is_cuda:
                full = full.contiguous(memory_format=torch.channels_last_3d)
            p.data = full
        self.gathered = True

    @torch.no_grad()
    def release(self) -> None:
        """Every gathered parameter back to this rank's slice of its current
        value."""
        if not self.gathered:
            return
        for name in self._stored():
            p = self.params[name]
            p.data = self._slice(name, p.data)
        self.gathered = False

    def shard_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradients (already averaged over the batch) of every tensor
        the 'model' ranks hold whole averaged over them too, so that
        kernels that add with atomics (cuDNN's weight gradients) leave no
        bit of difference between the ranks' copies; then the gathered
        parameters' cut to this rank's slices."""
        whole = {n: g for n, g in grads.items() if self.entries.get(n, {"tp": None})["tp"] is None}
        out = {**grads, **pmean_tree(whole, MODEL_AXIS)}
        for name in self._stored():
            out[name] = self._slice(name, out[name])
        return out

    def reduce_sq(self, sq: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{name: this rank's sum of squares of its part} -> {name: the sum
        over the whole tensor}: each rank weighs its part by the ranks that
        hold the same part, one all-reduce over the world."""
        g = axis_group(WORLD_AXES)
        if g is None:
            return sq
        names = list(sq)
        model = 1 if self.model_group is None else self.model_group[1]
        weights = []
        for n in names:
            e = self.entries.get(n, {"tp": None, "store": None, "data": None})
            split = e["tp"] is not None or e["store"] is not None
            shards = (model if split else 1) * (self.data[1] if e["data"] is not None else 1)
            weights.append(shards / g[1])
        vec = torch.stack([sq[n].float() * w for n, w in zip(names, weights)])
        dist.all_reduce(vec, group=g[0])
        return dict(zip(names, vec.unbind(0)))

    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if not self.gathered:
            t = self._whole(name, t)
        e = self.entries[name]
        if e["tp"] is not None:
            t = _gather(t, MODEL_AXIS, *e["tp"])
        return t

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        e = self.entries[name]
        if e["tp"] is not None:
            t = _take(t, e["tp"][0], e["tp"][1], self.model_group[1], self.model_group[2])
        return t if self.gathered else self._slice(name, t)

    def full_tensors(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{name: whole tensor} of tensors keyed and laid out like this
        tree's parameters (the parameters, the optimizer's moments), the
        others as they are."""
        return {n: self._full(n, t) if n in self.entries else t for n, t in tensors.items()}

    def local_tensors(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The inverse of :meth:`full_tensors`: this rank's parts."""
        return {n: self._local(n, t) if n in self.entries else t for n, t in tensors.items()}

    def full_state(self) -> Dict[str, torch.Tensor]:
        """The tree's ``state_dict`` with whole tensors."""
        return self.full_tensors(self.model.state_dict())

    @torch.no_grad()
    def load_full(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a ``state_dict`` of whole tensors into this rank's parts."""
        local = self.local_tensors(state)
        for name, t in local.items():
            target = self.params.get(name)
            if target is not None:
                target.data = t.to(target.device, target.dtype)
        self.model.load_state_dict({n: t for n, t in local.items() if n not in self.params}, strict=False)


def layout_of(module: Optional[nn.Module]) -> Optional[AutoLayout]:
    return None if module is None else getattr(module, "auto_layout", None)


def _column_row(owner: nn.Module) -> Tuple[List[str], List[str]]:
    """The names (in ``owner``) of the column- and row-parallel parameters
    of an attention or MLP."""
    cols = [n for n in ("qkv", "q", "k", "v", "fc1") if isinstance(getattr(owner, n, None), nn.Linear)]
    rows = [n for n in ("proj", "fc2") if isinstance(getattr(owner, n, None), nn.Linear)]
    col_names = [f"{c}.{w}" for c in cols for w in ("weight", "bias") if getattr(getattr(owner, c), w) is not None]
    return col_names, [f"{r}.weight" for r in rows]


def shard_module(cfg, module: nn.Module) -> AutoLayout:
    """Split ``module`` (built whole, the same on every rank) for 'auto' by
    JAX's rules (:func:`param_specs`). An attention or MLP whose column-
    and row-parallel parameters JAX all shards over 'model' keeps this
    rank's heads or hidden units and computes on them (Megatron); a tensor
    JAX shards over 'model' anywhere else is stored as this rank's
    contiguous slice and gathered whole for the step, as FSDP's are over
    'data'. The layout hangs on the module as ``auto_layout``."""
    model_g = axis_group(MODEL_AXIS)
    model_size, model_index = (1, 0) if model_g is None else model_g[1:]
    data_g = axis_group(DATA_AXIS)
    data_size, data_index = (1, 0) if data_g is None else data_g[1:]
    fsdp = data_size if cfg.TPU.FSDP else 1
    specs = param_specs(dict(module.named_parameters()), model_size, fsdp)
    entries = {n: {"tp": None, "store": s["model"], "data": s["data"]} for n, s in specs.items()}
    owners = sorted({n.rsplit(".", 2)[0] for n, s in specs.items() if s["model"] is not None})
    for owner in owners:
        mod = module.get_submodule(owner)
        cols, rows = _column_row(mod)
        marked = [f"{owner}.{n}" for n in cols + rows]
        if not cols or not rows or any(specs[n]["model"] is None for n in marked):
            continue  # JAX shards only part of it: stored sliced, computed whole
        for local, layout in _split_module(mod, model_size, model_index).items():
            entries[f"{owner}.{local}"].update(tp=layout, store=None)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, e in entries.items():
            p = params[name]
            if e["store"] is not None:
                p.data = _take(p.data, e["store"], 1, model_size, model_index)
            if e["data"] is not None:
                p.data = _take(p.data, e["data"], 1, data_size, data_index)
    layout = AutoLayout(module, entries)
    module.auto_layout = layout
    return layout


def shard_train_state(cfg, state, bundle) -> Dict[str, Dict[str, Optional[int]]]:
    """Lay the train state out for 'auto' (JAX's ``shard_train_state``):
    the model and the momentum encoder split by the same rules, the
    optimizer's moments cut to this rank's parts (zeros sliced, or a
    resumed run's whole moments sliced: the resume keeps them), the SSL
    buffers replicated; ``bundle``'s optimizer gets the layout's norms.
    Returns the specs."""
    layout = shard_module(cfg, state.model)
    if "ema_model" in state.ssl:
        shard_module(cfg, state.ssl["ema_model"])
    state.opt_state = map_moments(state.opt_state, layout.local_tensors)
    bundle.tx.reduce_sq = layout.reduce_sq
    return {n: {"model": e["tp"][0] if e["tp"] else e["store"], "data": e["data"]}
            for n, e in layout.entries.items()}


def map_moments(opt_state: Dict[str, Any], fn) -> Dict[str, Any]:
    """The optimizer state with ``fn`` applied to each {param name: tensor}
    dict in it (the momentum trace, Adam's moments)."""
    return {k: fn(v) if isinstance(v, dict) else v for k, v in opt_state.items()}


def gather_step(*modules: Optional[nn.Module]) -> List[AutoLayout]:
    """Gather the FSDP parameters of each module that has a layout; returns
    those layouts (release them after the backward)."""
    layouts = [lay for lay in (layout_of(m) for m in modules) if lay is not None]
    for lay in layouts:
        lay.gather()
    return layouts


def grads_axes(cfg) -> Tuple[str, ...]:
    """The ranks the step averages gradients over: the batch's under 'auto'
    (tensor-parallel parts differ between 'model' ranks; the rest they hold
    alike: :meth:`AutoLayout.shard_grads`), the world otherwise (seq and
    pipe ranks' gradients agree only in their mean)."""
    from advise_tpu_torch.parallel.mesh import is_auto

    return BATCH_AXES if is_auto(cfg) else WORLD_AXES
