"""The contrastive algorithms (counterpart of
``advise_tpu/engine/contrastive.py``): BYOL, MoCo, SimCLR, SwAV and the
memory bank, and CONTRASTIVE.SEQUENTIAL's per-clip gradients, each rank on
its share of the batch with the JAX package's collectives
(``parallel/collectives.py``; identities without a process group):

- MoCo's shuffle-BN gathers each key view over the sync group
  (CONTRASTIVE.LOCAL_SHUFFLE_BN) or the world, every rank of it in one
  permutation drawn from ``infos['shared_generator']`` (seeded alike on
  every rank; without it the step's generator) or handed over as
  ``infos['shuffle_perm']`` (one a key view);
- the queue, the kNN bank, the memory bank and SwAV's queue take the
  world's rows, gathered, so the replicated state stays the same on every
  rank;
- SimCLR's negatives (SIMCLR_DIST_ON) are gathered with their gradient;
- Sinkhorn's sums run over the world's batch.

The JAX package keeps the algorithm state functional (``TrainState.ssl``);
here it is a dict too, holding:

- for BYOL and MoCo the momentum encoder as a second module
  (``ssl['ema_model']``: its parameters are the JAX ``ema_params``, its BN
  buffers ``ema_batch_stats``);
- for MoCo the key queue ``ssl['queue_x']`` [QUEUE_LEN, DIM] with its write
  pointer ``ssl['ptr']`` (an int64 tensor on the card, so that the step
  never waits for it and the checkpoint carries it);
- for SwAV with SWAV_QEUE_LEN > 0 the feature queue ``ssl['queue_swav']``
  [2, SWAV_QEUE_LEN, DIM] and ``ssl['swav_started']`` (a bool tensor);
- for mem the bank ``ssl['memory']`` [LENGTH, DURATION or 1, DIM];
- with CONTRASTIVE.KNN_ON the kNN bank ``ssl['knn_mem']``.

The functions update that state in place and say so.

Views run as one batch ``[V*B, ...]`` with ``views=V`` passed down to every
BN, so each view keeps its own batch statistics and the running update is
the views' average (see ``layers/norm.py``), as JAX's vmapped views give;
one view after another (TPU.VMAP_VIEWS off, the sequential paths) the
running statistics chain. They are recorded by the forwards and committed
by the train step (:func:`advise_tpu_torch.models.layers.norm.commit_bn_stats`).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from advise_tpu_torch.data.device_aug import uniform_from
from advise_tpu_torch.models import losses as L
from advise_tpu_torch.parallel.collectives import (
    all_gather_cat,
    batch_shuffle,
    batch_unshuffle,
    psum,
    replica_index,
    world_size,
)
from advise_tpu_torch.parallel.mesh import BATCH_AXES, SYNC_AXIS, is_auto
from advise_tpu_torch.utils.host_times import HOST_TIMES


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / sqrt(max(sum(x^2), 1e-12)): the floor is on the SQUARED norm, as in
    the JAX package (``F.normalize`` clamps the norm itself, which differs)."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=1e-12))


def init_ssl_state(cfg, model: nn.Module, generator: torch.Generator) -> Dict[str, Any]:
    """The state of CONTRASTIVE.TYPE (``advise_tpu/engine/contrastive.py
    init_ssl_state``):

    - byol and moco: the momentum encoder (a copy of ``model``);
    - moco: the queue [QUEUE_LEN, DIM] uniform(-stdv, stdv) and its pointer
      at 0;
    - swav with SWAV_QEUE_LEN > 0: the queue [2, SWAV_QEUE_LEN, DIM] of
      zeros and ``swav_started`` False;
    - mem: the bank [LENGTH, DURATION (MEM_TYPE '2d') or 1, DIM]
      uniform(-stdv, stdv);
    - with CONTRASTIVE.KNN_ON the kNN bank [LENGTH, DIM] uniform(-stdv,
      stdv);

    stdv = 1 / sqrt(DIM / 3). The draws come from ``generator``, the tensors
    live on the model's device."""
    ctype = cfg.CONTRASTIVE.TYPE
    if ctype not in CONTRASTIVE_LOSSES:
        raise KeyError(f"CONTRASTIVE.TYPE={ctype!r}: one of {sorted(CONTRASTIVE_LOSSES)}")
    ssl: Dict[str, Any] = {}
    if ctype in ("byol", "moco"):
        ema = copy.deepcopy(model)
        ema.requires_grad_(False)
        ssl["ema_model"] = ema
    dim = cfg.CONTRASTIVE.DIM
    stdv = 1.0 / math.sqrt(dim / 3)
    device = next(model.parameters()).device

    def uniform(*shape: int) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u * (2 * stdv) - stdv).to(device)

    if ctype == "moco":
        ssl["queue_x"] = uniform(cfg.CONTRASTIVE.QUEUE_LEN, dim)
        ssl["ptr"] = torch.zeros((), dtype=torch.int64, device=device)
    if ctype == "swav" and cfg.CONTRASTIVE.SWAV_QEUE_LEN > 0:
        ssl["queue_swav"] = torch.zeros((2, cfg.CONTRASTIVE.SWAV_QEUE_LEN, dim), device=device)
        ssl["swav_started"] = torch.zeros((), dtype=torch.bool, device=device)
    if ctype == "mem":
        duration = max(int(cfg.CONTRASTIVE.DURATION), 1) if cfg.CONTRASTIVE.MEM_TYPE == "2d" else 1
        ssl["memory"] = uniform(cfg.CONTRASTIVE.LENGTH, duration, dim)
    if cfg.CONTRASTIVE.KNN_ON:
        ssl["knn_mem"] = uniform(cfg.CONTRASTIVE.LENGTH, dim)
    return ssl


def momentum_at(cfg, epoch_exact: float) -> float:
    """Cosine momentum annealing; constant momentum otherwise."""
    m0 = cfg.CONTRASTIVE.MOMENTUM
    if not cfg.CONTRASTIVE.MOMENTUM_ANNEALING:
        return m0
    return 1.0 - (1.0 - m0) * (math.cos(math.pi * epoch_exact / cfg.SOLVER.MAX_EPOCH) + 1.0) * 0.5


@torch.no_grad()
def update_ema(ssl: Dict[str, Any], model: nn.Module, m: float) -> None:
    """In place: ema = ema * m + online * (1 - m), parameters only (the
    momentum encoder's BN buffers move in its own key forwards)."""
    ema = [p for p in ssl["ema_model"].parameters()]
    cur = [p for p in model.parameters()]
    torch._foreach_mul_(ema, m)
    torch._foreach_add_(ema, torch._foreach_mul(cur, 1.0 - m))


def views_apply(model: nn.Module, views: torch.Tensor,
                generator: Optional[torch.Generator] = None):
    """Run ``views`` [V, B, ...] through ``model`` as one [V*B, ...] batch with
    per-view BN; returns the head outputs reshaped to [V, B, dim].
    ``generator`` draws the model's dropout masks in training."""
    v, b = views.shape[:2]
    out = model(views.reshape(v * b, *views.shape[2:]), views=v, generator=generator)
    if isinstance(out, (list, tuple)):
        return [o.reshape(v, b, *o.shape[1:]) for o in out]
    return out.reshape(v, b, *out.shape[1:])


def shuffle_bn_on(cfg) -> bool:
    """MoCo's shuffle-BN, taken where the JAX ``compute_keys`` takes it:
    synchronized BN that is not global, not BYOL, and sync groups on the
    mesh (TPU.MESH_SYNC != -1)."""
    return (cfg.BN.NORM_TYPE == "sync_batchnorm" and not cfg.BN.GLOBAL_SYNC
            and cfg.CONTRASTIVE.TYPE != "byol" and cfg.TPU.MESH_SYNC != -1)


def _proj(out) -> torch.Tensor:
    return out[0] if isinstance(out, (list, tuple)) else out


def loss_grads(loss: torch.Tensor, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{name: d loss / d param}, zeros for a parameter the loss does not
    reach (the predictor under SimCLR, SwAV, mem or MoCo), as JAX's
    ``value_and_grad`` gives them."""
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}


def per_clip_grads(n: int, generator: Optional[torch.Generator],
                   fn: Callable[[int], Tuple[Dict[str, torch.Tensor], Any]]):
    """The sequential paths' loop: ``fn(i)`` -> ({name: grad}, extra) for
    each clip i < n, every clip from the generator's state before clip 0
    (the same dropout masks in each, as JAX reuses one key). Returns the
    gradients summed over the clips and the list of extras."""
    drop_state = generator.get_state() if generator is not None else None
    grads, extras = None, []
    for i in range(n):
        if drop_state is not None:
            generator.set_state(drop_state)
        g, extra = fn(i)
        grads = g if grads is None else {name: grads[name] + g[name] for name in grads}
        extras.append(extra)
    return grads, extras


@torch.no_grad()
def compute_keys(cfg, ssl: Dict[str, Any], views: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 infos: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Momentum-encoder keys [V, B, dim] (l2-normalized projections) of
    ``views`` [V, B, ...], BN in train mode and per view. Without shuffle-BN
    and with TPU.VMAP_VIEWS the views run as one batch; otherwise one view
    after another, each under shuffle-BN (:func:`shuffle_bn_on`) in an order
    of the group's batch (the sync group with CONTRASTIVE.LOCAL_SHUFFLE_BN,
    else the world): ``infos['shuffle_perm'][i]`` when given, else drawn
    from ``infos['shared_generator']`` or, without it, ``generator``; its
    keys are put back in order. ``generator`` also draws the encoder's
    dropout masks."""
    ema = ssl["ema_model"]
    shuffle = shuffle_bn_on(cfg)
    if cfg.TPU.VMAP_VIEWS and not shuffle and views.shape[0] > 1:
        return l2_normalize(_proj(views_apply(ema, views, generator)))
    infos = infos or {}
    axes = SYNC_AXIS if cfg.CONTRASTIVE.LOCAL_SHUFFLE_BN else BATCH_AXES
    shared = infos.get("shared_generator", generator)
    perms = infos.get("shuffle_perm")
    keys = []
    for i, v in enumerate(views):
        if shuffle:
            v, perm = batch_shuffle(v, shared, axes, None if perms is None else perms[i])
        key = l2_normalize(_proj(ema(v, views=1, generator=generator)))
        keys.append(batch_unshuffle(key, perm, axes) if shuffle else key)
    return torch.stack(keys)


@torch.no_grad()
def knn_update(cfg, ssl: Dict[str, Any], q: torch.Tensor, index: torch.Tensor) -> None:
    """In place: knn_mem[index] = q (momentum-1 scatter) of the world's rows."""
    if not cfg.CONTRASTIVE.KNN_ON or "knn_mem" not in ssl:
        return
    mem = ssl["knn_mem"]
    index = all_gather_cat(index.to(mem.device).long())
    mem[index] = all_gather_cat(q.to(mem.dtype))


def byol_loss(cfg, model: nn.Module, ssl: Dict[str, Any], views: torch.Tensor,
              infos: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
              ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Symmetric predictor-vs-EMA-key similarity, -(q_hat . k_hat)/T averaged,
    for ``views`` [V>=2, B, T, H, W, C]. Both online views run as one batch
    with per-view BN, then the momentum encoder's keys, then the kNN scatter
    of the first view's normalized projection (in place). ``generator``
    draws the dropout masks."""
    if views.shape[0] < 2:
        raise ValueError("BYOL needs 2 clips per video")
    t = cfg.CONTRASTIVE.T
    views = views[:2]
    out = views_apply(model, views, generator)
    if not isinstance(out, list):
        raise ValueError("BYOL requires CONTRASTIVE.PREDICTOR_DEPTHS")
    proj, pred = out[0], l2_normalize(out[1])
    keys = compute_keys(cfg, ssl, views, generator, infos)
    loss = (
        -(torch.sum(pred[0] * keys[1], dim=-1)).mean() / t
        + -(torch.sum(pred[1] * keys[0], dim=-1)).mean() / t
    )
    knn_update(cfg, ssl, l2_normalize(proj[0].detach()), infos["item_id"])
    return loss, ssl, {"loss_byol": loss.detach()}


@torch.no_grad()
def dequeue_and_enqueue(cfg, ssl: Dict[str, Any], keys: torch.Tensor) -> None:
    """In ``ssl``: the first view's keys (every view's with
    CONTRASTIVE.MOCO_MULTI_VIEW_QUEUE), each view's gathered over the world,
    written into the queue at ``ptr``, and ``ptr`` moved on by their count,
    back to 0 when it reaches the end. QUEUE_LEN must be a multiple of that
    count, as the JAX package asserts."""
    use = keys if cfg.CONTRASTIVE.MOCO_MULTI_VIEW_QUEUE else keys[:1]
    key = torch.cat([all_gather_cat(k) for k in use])
    queue, ptr = ssl["queue_x"], ssl["ptr"]
    k, n = queue.shape[0], key.shape[0]
    if k % n:
        raise ValueError(f"CONTRASTIVE.QUEUE_LEN ({k}) must be divisible by the key batch ({n})")
    # a new tensor: the step's loss saved the old queue for its backward
    ssl["queue_x"] = queue.index_copy(0, ptr + torch.arange(n, device=queue.device), key.to(queue.dtype))
    ssl["ptr"] = torch.where(ptr + n >= k, torch.zeros_like(ptr), ptr + n)


def moco_loss(cfg, model: nn.Module, ssl: Dict[str, Any], views: torch.Tensor,
              infos: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
              ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, torch.Tensor]]:
    """MoCo's NCE for ``views`` [V>=2, B, T, H, W, C]: the online model on
    view 0 alone (its BN statistics over that view), the momentum encoder's
    keys of views 1 and on (:func:`compute_keys`), per key view the logits
    [positive, q @ queue.T] over CONTRASTIVE.T, stacked, and the
    cross-entropy at index 0. Then, in place, the queue update
    (:func:`dequeue_and_enqueue`) and the kNN scatter of q. The logits are
    float32: in JAX the bf16 query times the float32 queue promotes. Stats:
    ``loss_nce`` and ``acc_ins`` (top-1 of the positive)."""
    if views.shape[0] < 2:
        raise ValueError("MoCo needs 2 clips per video")
    t = cfg.CONTRASTIVE.T
    q = l2_normalize(_proj(model(views[0], views=1, generator=generator)))
    keys = compute_keys(cfg, ssl, views[1:], generator, infos)
    with torch.autocast(q.device.type, enabled=False):
        qf = q.float()
        queue_neg = qf @ ssl["queue_x"].T  # [B, QUEUE_LEN]
        logits = torch.cat([
            torch.cat([torch.sum(qf * key.float(), dim=-1, keepdim=True), queue_neg], dim=1)
            for key in keys], dim=0) / t
        zeros = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
        loss = L.cross_entropy(logits, zeros)
        acc = L.top_k_accuracy(logits.detach(), zeros, 1)
    dequeue_and_enqueue(cfg, ssl, keys)
    knn_update(cfg, ssl, q.detach(), infos["item_id"])
    return loss, ssl, {"loss_nce": loss.detach(), "acc_ins": acc}


def _online_views(cfg, model: nn.Module, views: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """The online projections [V, B, dim] of ``views`` [V, B, ...]: as one
    batch with per-view BN under TPU.VMAP_VIEWS (the views' running
    statistics averaged), else one view after another (chained)."""
    if cfg.TPU.VMAP_VIEWS and views.shape[0] > 1:
        return _proj(views_apply(model, views, generator))
    return torch.stack([_proj(model(v, views=1, generator=generator)) for v in views])


def simclr_loss(cfg, model: nn.Module, ssl: Dict[str, Any], views: torch.Tensor,
                infos: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, torch.Tensor]]:
    """NT-Xent over the l2-normalized projections of views 0 and 1 (``cat``
    [2B, dim]): -log(exp(q . q2 / T) / sum of exp(row . other / T)) over
    every row, the diagonal masked, in the dtype of the projections (as
    JAX computes it). With SIMCLR_DIST_ON both views' projections are
    gathered over the world with their gradient first. Then, in place, the
    kNN scatter of view 0's projection."""
    t = cfg.CONTRASTIVE.T
    proj = _online_views(cfg, model, views[:2], generator)
    q, q2 = l2_normalize(proj[0]), l2_normalize(proj[1])
    qg, qg2 = (all_gather_cat(q), all_gather_cat(q2)) if cfg.CONTRASTIVE.SIMCLR_DIST_ON else (q, q2)
    cat = torch.cat([qg, qg2], dim=0)
    sim = torch.exp(cat @ cat.T / t)
    mask = 1.0 - torch.eye(sim.shape[0], dtype=sim.dtype, device=sim.device)
    denom = torch.sum(sim * mask, dim=-1)
    pos = torch.exp(torch.sum(qg * qg2, dim=-1) / t)
    pos = torch.cat([pos, pos], dim=0)
    loss = (-torch.log(pos / denom)).mean()
    knn_update(cfg, ssl, q.detach(), infos["item_id"])
    return loss, ssl, {"loss_simclr": loss.detach()}


def sinkhorn(scores: torch.Tensor, iters: int = 3, axes=BATCH_AXES) -> torch.Tensor:
    """Sinkhorn-Knopp on this rank's [B, K] scores of the world's batch
    (``advise_tpu/engine/contrastive.py sinkhorn``): the total normalized
    to 1, then ``iters`` rounds of rows to 1 / K and columns to 1 / (B x
    the world), the total and the row sums summed over ``axes``' ranks, then
    each sample's column to sum 1. Returns [B, K]."""
    q = scores.T  # [K, B]
    k, b = q.shape
    q = q / psum(torch.sum(q), axes)
    r = torch.ones(k, dtype=q.dtype, device=q.device) / k
    c = torch.ones(b, dtype=q.dtype, device=q.device) / (b * world_size(axes))
    for _ in range(iters):
        q = q * (r / (psum(torch.sum(q, dim=1), axes) + 1e-12))[:, None]
        q = q * (c / (torch.sum(q, dim=0) + 1e-12))[None, :]
    q = q / (torch.sum(q, dim=0, keepdim=True) + 1e-12)
    return q.T


SWAV_EPS = 0.05  # the Sinkhorn temperature (the reference's swav_eps_sinkhorn)
SWAV_QUEUE_EPOCH = 15.0  # the queue's scores join the codes from this epoch on


def swav_loss(cfg, model: nn.Module, ssl: Dict[str, Any], views: torch.Tensor,
              infos: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
              ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Swapped prediction over prototype assignments for ``views`` [V, B,
    ...]: every view's l2-normalized projection and its float32 prototype
    scores (``model.prototypes``); for each of the first min(2, V) views the
    codes ``sinkhorn(exp(scores / 0.05))`` without gradient, and the CE of
    every other view's ``log_softmax(scores / T)`` against them, averaged.

    With ``ssl['queue_swav']``, per assigning view i: the queued embeddings'
    scores go in front of the view's before Sinkhorn, replaced by -1e9
    (exp gives 0) unless the queue has started (``swav_started``, or its
    last row written) and ``infos['epoch_exact']`` >= 15; ``swav_started``
    takes that value, read before view i's write; the queue rolls by the
    world's batch and the view's embeddings, gathered, go into its head
    (Sinkhorn then normalizes the queue's columns on every rank, as JAX
    does; under TPU.PARTITION_MODE 'auto' the scores are gathered over the
    batch and Sinkhorn runs once over the queue and the whole batch, as
    JAX's GSPMD step's global arrays do). In place, like the
    kNN scatter of view 0's embedding after. The stat ``swav_gate`` is the
    share of the assigning views whose gate was open (queue only)."""
    t = cfg.CONTRASTIVE.T
    n_clips = views.shape[0]
    proj = _online_views(cfg, model, views, generator)
    embeddings = [l2_normalize(p) for p in proj]
    outputs = [model.prototypes(e) for e in embeddings]
    epoch_exact = float(infos.get("epoch_exact", 0.0))
    use_queue = "queue_swav" in ssl
    crops_for_assign = range(min(2, n_clips))
    loss_total, gates = 0.0, []
    for i in crops_for_assign:
        out_i = outputs[i].detach()
        with torch.no_grad():
            if use_queue:
                queue = ssl["queue_swav"]
                w = model.prototypes(queue[i])
                started = ssl["swav_started"] | torch.any(queue[i, -1] != 0)
                gate = started & (epoch_exact >= SWAV_QUEUE_EPOCH)
                gates.append(gate)
                w = torch.where(gate, w, w.new_tensor(-1e9))
                if is_auto(cfg):
                    # JAX's auto step holds the global batch: the queue's rows
                    # enter Sinkhorn once, not once a rank
                    out_all = all_gather_cat(out_i)
                    codes = sinkhorn(torch.exp(torch.cat([w, out_all], dim=0) / SWAV_EPS), axes=())
                    rows = replica_index() * out_i.shape[0]
                    codes = codes[w.shape[0] + rows:w.shape[0] + rows + out_i.shape[0]]
                else:
                    codes = sinkhorn(torch.exp(torch.cat([w, out_i], dim=0) / SWAV_EPS))[-out_i.shape[0]:]
                emb = all_gather_cat(embeddings[i].detach().to(queue.dtype))
                rolled = torch.roll(queue[i], emb.shape[0], dims=0)
                rolled[:emb.shape[0]] = emb
                queue[i] = rolled
                ssl["swav_started"] = started
            else:
                codes = sinkhorn(torch.exp(out_i / SWAV_EPS))
        subloss = 0.0
        for v in range(n_clips):
            if v != i:
                p = torch.log_softmax(outputs[v] / t, dim=-1)
                subloss = subloss - torch.mean(torch.sum(codes * p, dim=1))
        loss_total = loss_total + subloss / (n_clips - 1)
    loss = loss_total / len(crops_for_assign)
    knn_update(cfg, ssl, embeddings[0].detach(), infos["item_id"])
    stats = {"loss_swav": loss.detach()}
    if gates:
        stats["swav_gate"] = torch.stack(gates).float().mean()
    return loss, ssl, stats


def _mem_interp_weights(time_f: torch.Tensor, duration: int):
    """The adjacent slots (t0, t1) of float times and the reference's
    interpolation weight of t1, ``1 - (time - t0)``: inverted (the
    reference's "hack for inverse"), kept as the JAX package keeps it so
    that the bank holds what the reference's holds."""
    t0 = torch.clamp(torch.floor(time_f), 0, duration - 1).long()
    t1 = torch.clamp(t0 + 1, 0, duration - 1)
    w_t1 = 1.0 - (time_f - t0.to(torch.float32))
    return t0, t1, w_t1[..., None]


def mem_loss(cfg, model: nn.Module, ssl: Dict[str, Any], views: torch.Tensor,
             infos: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Memory-bank NCE (``advise_tpu/engine/contrastive.py mem_loss``): the
    online model on view 0 alone, its l2-normalized projection q against
    the bank rows ``memory[index, time]`` [B, QUEUE_LEN + 1, dim], column 0
    the item's own row (``infos['item_id']``) at its own time slot, the rest
    random rows; float32 logits over T and the CE at 0.

    The random rows are ``infos['mem_index']`` [B, QUEUE_LEN + 1] and their
    times ``infos['mem_time']`` when the caller gives them (column 0 is
    overwritten), else drawn from ``generator``: rows uniform in [0,
    LENGTH), times uniform integers in [0, DURATION) (float in [0, DURATION
    - 1) with INTERP_MEMORY). The own time is ``infos['time_idx']`` (0
    without it) times DURATION - 1, rounded, or with INTERP_MEMORY read
    between the adjacent slots with :func:`_mem_interp_weights`.

    Then, in place, the momentum update of the world's items' rows (q, the
    items and their times gathered)
    ``l2_normalize(q * m + old * (1 - m))`` (with INTERP_MEMORY each slot's
    q weighted by its interpolation weight, written to t0 and then t1, so
    the second write wins where they meet) and the kNN scatter of q."""
    t = cfg.CONTRASTIVE.T
    k = cfg.CONTRASTIVE.QUEUE_LEN
    index = infos["item_id"].long()
    q = l2_normalize(_proj(model(views[0], views=1, generator=generator)))
    b = q.shape[0]
    memory = ssl["memory"]
    length, duration, _ = memory.shape
    dev = memory.device
    index = index.to(dev)
    interp = bool(cfg.CONTRASTIVE.INTERP_MEMORY) and cfg.CONTRASTIVE.MEM_TYPE == "2d" and duration > 1
    gen_dev = generator.device if generator is not None else dev
    if "mem_index" in infos:
        clip_ind = infos["mem_index"].to(dev).long().clone()
    else:
        clip_ind = torch.randint(0, length, (b, k + 1), generator=generator, device=gen_dev).to(dev)
    clip_ind[:, 0] = index
    time01 = infos["time_idx"].to(dev, torch.float32) if "time_idx" in infos else torch.zeros(b, device=dev)
    with torch.no_grad():
        if interp:
            if "mem_time" in infos:
                time_f = infos["mem_time"].to(dev, torch.float32).clone()
            else:
                u = torch.rand((b, k + 1), generator=generator, device=gen_dev).to(dev)
                time_f = uniform_from(u, 0.0, float(duration - 1))
            time_f[:, 0] = time01 * (duration - 1)
            t0, t1, w_t1 = _mem_interp_weights(time_f, duration)
            negs = memory[clip_ind, t0] * (1.0 - w_t1) + memory[clip_ind, t1] * w_t1
        else:
            my_time = torch.round(time01 * (duration - 1)).long()
            if duration > 1:
                if "mem_time" in infos:
                    time_ind = infos["mem_time"].to(dev).long().clone()
                else:
                    time_ind = torch.randint(0, duration, (b, k + 1), generator=generator,
                                             device=gen_dev).to(dev)
                time_ind[:, 0] = my_time
            else:
                time_ind = torch.zeros((b, k + 1), dtype=torch.long, device=dev)
            negs = memory[clip_ind, time_ind]
    with torch.autocast(q.device.type, enabled=False):
        # float32: in JAX the bf16 q times the float32 bank promotes
        logits = torch.einsum("nc,nkc->nk", q.float(), negs) / t
        loss = L.cross_entropy(logits, torch.zeros(b, dtype=torch.long, device=logits.device))
    m = cfg.CONTRASTIVE.MOMENTUM
    with torch.no_grad():
        qd = all_gather_cat(q.detach().to(dev))
        ind_all = all_gather_cat(index)
        if interp:
            time_all = all_gather_cat(time01 * (duration - 1))
            t0, t1, w_t1 = _mem_interp_weights(time_all, duration)
            old_t0, old_t1 = memory[ind_all, t0], memory[ind_all, t1]
            upd_t0 = l2_normalize(qd * (1.0 - w_t1) * m + old_t0 * (1.0 - m))
            upd_t1 = l2_normalize(qd * w_t1 * m + old_t1 * (1.0 - m))
            memory[ind_all, t0] = upd_t0
            memory[ind_all, t1] = upd_t1
        else:
            time_all = all_gather_cat(my_time)
            old = memory[ind_all, time_all]
            memory[ind_all, time_all] = l2_normalize(qd * m + old * (1.0 - m))
    knn_update(cfg, ssl, q.detach(), index)
    return loss, ssl, {"loss_nce": loss.detach()}


CONTRASTIVE_LOSSES = {"byol": byol_loss, "moco": moco_loss, "simclr": simclr_loss,
                      "swav": swav_loss, "mem": mem_loss}


def sequential_contrastive_grads(cfg, model: nn.Module, ssl: Dict[str, Any], views: torch.Tensor,
                                 infos: Dict[str, torch.Tensor],
                                 generator: Optional[torch.Generator] = None):
    """CONTRASTIVE.SEQUENTIAL (``advise_tpu/engine/contrastive.py
    sequential_contrastive_grads``), byol and moco: the momentum encoder's
    keys of all V views once, then per view a query forward and backward
    against the OTHER views' keys (BYOL: -mean(pred . key) / T; MoCo: the
    CE over [positive, queue], float32), each averaged over the V - 1 keys.
    The gradients are summed over the views, not averaged; the BN running
    statistics chain from view to view; every view draws the same dropout
    masks (the generator's state after the keys, replayed), as JAX reuses
    one key. Then, in place, MoCo's enqueue and the kNN scatter of the LAST
    view's projection. Returns ({name: grad}, ssl, stats), the stat the
    summed loss / (2V) (the reference's logging scale). Spans
    (``utils/host_times.py``): ``step.forward`` around the keys and around
    each view's loss, ``step.backward`` around each view's backward."""
    ctype = cfg.CONTRASTIVE.TYPE
    if ctype not in ("byol", "moco"):
        raise ValueError(f"CONTRASTIVE.SEQUENTIAL supports byol and moco only, not {ctype!r}")
    n = views.shape[0]
    if n < 2:
        raise ValueError("CONTRASTIVE.SEQUENTIAL needs >= 2 clips")
    t = cfg.CONTRASTIVE.T
    with HOST_TIMES("step.forward"):
        keys = compute_keys(cfg, ssl, views, generator, infos)  # [V, B, dim]
    params = dict(model.named_parameters())

    def clip_loss(k_idx):
        out = model(views[k_idx], views=1, generator=generator)
        q = l2_normalize(_proj(out))
        other = (torch.arange(n, device=q.device) != k_idx).to(torch.float32)
        if ctype == "byol":
            if not isinstance(out, (list, tuple)):
                raise ValueError("BYOL requires CONTRASTIVE.PREDICTOR_DEPTHS")
            pred = l2_normalize(out[1])
            sims = torch.einsum("bd,nbd->n", pred, keys) / pred.shape[0]
            return torch.sum(-sims / t * other) / (n - 1), q
        with torch.autocast(q.device.type, enabled=False):
            qf = q.float()
            queue_neg = qf @ ssl["queue_x"].T  # [B, QUEUE_LEN]
            pos = torch.einsum("bd,nbd->nb", qf, keys.float())
            logits = torch.cat([pos[..., None], queue_neg.expand(n, *queue_neg.shape)], dim=-1) / t
            ce = -torch.log_softmax(logits, dim=-1)[..., 0]  # [V, B]
            return torch.sum(torch.mean(ce, dim=-1) * other) / (n - 1), q

    def clip_grads(k_idx):
        with HOST_TIMES("step.forward"):
            loss, q = clip_loss(k_idx)
        with HOST_TIMES("step.backward"):
            grads = loss_grads(loss, params)
        return grads, (loss.detach(), q.detach())

    grads, per_clip = per_clip_grads(n, generator, clip_grads)
    loss_sum = sum(loss for loss, _ in per_clip)
    if ctype == "moco":
        dequeue_and_enqueue(cfg, ssl, keys)
    knn_update(cfg, ssl, per_clip[-1][1], infos["item_id"])
    name = "loss_byol" if ctype == "byol" else "loss_nce"
    return grads, ssl, {name: loss_sum / (n * 2.0)}


def eval_knn(ssl: Dict[str, Any], q: torch.Tensor, knn_k: int = 200):
    """Top-k similarities of ``q`` [N, dim] against the kNN bank and their
    rows (reference eval_knn :233-241)."""
    dist = q @ ssl["knn_mem"].T
    return torch.topk(dist, min(knn_k, dist.shape[1]), dim=1)


def knn_probe(cfg, ssl: Dict[str, Any], labels_bank: torch.Tensor, feats: torch.Tensor,
              labels: torch.Tensor, knn_k: int = 200, t: float = 0.07,
              num_classes: Optional[int] = None) -> torch.Tensor:
    """Online kNN top-1 accuracy against the kNN bank
    (``advise_tpu/engine/contrastive.py:865``): a vote over the top-k
    neighbours weighted by exp(similarity / t). ``labels_bank`` [LENGTH]
    holds each bank row's class, -1 for a row with no vote; ``feats`` [N,
    dim] are l2-normalized query features, ``labels`` [N] their classes."""
    yd, yi = eval_knn(ssl, feats, knn_k)
    neigh = labels_bank.to(yi.device)[yi]  # [N, k]
    w = torch.exp(yd / t) * (neigh >= 0)  # a row labelled -1 casts no vote
    if num_classes is None:
        num_classes = int(labels_bank.max()) + 1
    votes = torch.zeros((feats.shape[0], num_classes), dtype=w.dtype, device=w.device)
    votes.scatter_add_(1, neigh.clamp(min=0).long(), w)
    pred = torch.argmax(votes, dim=-1)
    return (pred == labels.to(pred.device)).float().mean()


def knn_labels_from_dataset(dataset, length: int) -> torch.Tensor:
    """Label bank of the online kNN monitor (``advise_tpu/engine/
    contrastive.py:888``): row i holds the class of item i, rows past the
    dataset -1 (no vote); int32 on the CPU."""
    labels = torch.full((length,), -1, dtype=torch.int32)
    n = min(len(dataset.items), length)
    labels[:n] = torch.tensor([cls for _, cls in dataset.items[:n]], dtype=torch.int32)
    return labels
