"""Trainer: the epoch and iteration loop of one rank, the counterpart of
``advise_tpu/engine/train.py:43-265`` (reference ``tools/train.py:250-344``).

One process drives one card: rank r of a world of N (``parallel/mesh.py
distributed_init``; rank 0 of 1 without a process group) loads its share
of the global batch and runs the step with the JAX step's collectives.
cfg.NUM_WORLDS is the batch-carrying ranks, which the lr scaling reads. The
state is built alike on every rank (the same seeds), and its digest is
checked to agree across the ranks at the start (after any resume) and at
the end. Only rank 0 writes checkpoints and the VIS_MASK dump.

Per iteration: the host loader's batch -> the card (pinned, prefetched on a
side stream, TPU.PREFETCH batches in flight) -> one train step -> meters.
With TPU.DEVICE_AUG False the loader's host aug has made the clips
(normalized float32) and every step, the kNN probe and the VIS_MASK dump
take them as they are.
The lr comes from the lr policy at ``epoch + (it + 1) / iters`` (the
PlateauController's after the warm-up under the plateau policy). At each
epoch's end: the online kNN probe on CONTRASTIVE.KNN_EVAL_BATCHES batches of
a fresh shuffle (epoch + 999983), then the epoch summary and ``ckpt.save``.

Random streams. JAX folds the run's key with ``jax.random.fold_in``; the
port seeds one ``torch.Generator`` on the card per use from a numpy
``SeedSequence`` of integers (:func:`seeded_generator`):

- model weights: ``build_model(seed=TRAIN.SEED)``;
- the SSL state (the kNN bank's init): ``(TRAIN.SEED, 7)``;
- iteration ``it`` of epoch ``epoch`` (augmentation, then dropout or drop
  path): ``(TRAIN.SEED, epoch, it)``, and ``(TRAIN.SEED, epoch, it, r)`` on
  rank r of a world of more than one, so that ranks draw their own, as
  JAX folds the replica index into the step's key; there MoCo's
  shuffle-BN permutations come from ``(TRAIN.SEED, epoch, it)``, alike on
  every rank;
- kNN probe batch ``i`` after epoch ``epoch``: ``(TRAIN.SEED, 2**31 - 1 -
  epoch, i)`` (and r as above), as JAX's probe key is ``fold_in(rng,
  2**31 - 1 - epoch)``;
- the VIS_MASK dump after epoch ``epoch`` (its aug, then its masks):
  ``(TRAIN.SEED, 424243 + epoch)``, as JAX's ``fold_in(rng, 424243 +
  epoch)``.

So a resumed run draws what the uninterrupted run would have drawn.

TPU.PROFILE_DIR runs ``torch.profiler`` over the steps
(PROFILE_START, PROFILE_START + PROFILE_STEPS] of the step counter, writes
``trace.json`` there (rank r > 0: ``trace.rank{r}.json``; the step's spans
in it) and logs the device's busy and idle shares of that window and, for
each span of the step, its device time, the idle time it made the device
wait and its launches a step. With VIS_MASK.ENABLE (the MAE path) each
epoch ends with the first batch of a fresh shuffle (``loader.take_one(epoch + 424243)``) through the
model in eval mode, dumped by ``utils/visualization.py
dump_mask_visualization`` under ``LOGDIR/vis_mask/vid/``. Under
TPU.PARTITION_MODE 'auto' the state is split after any restore
(``parallel/auto_shard.py shard_train_state``, keeping restored moments),
and the digests are the whole tensors'; under TPU.MESH_SEQ and MESH_PIPE
the ranks of a seq or pipe line load and draw alike (their batch index).

The TemporalModel's CLIP tower takes its weights from
MODEL.SPATIAL_MODEL_PATH (an open_clip checkpoint, or a directory holding
``open_clip_pytorch_model.bin``) when it is set, else keeps the random
weights of TRAIN.SEED, as the JAX trainer does.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from advise_tpu_torch.data import build_device_aug, build_loader, prefetch_to_device
from advise_tpu_torch.data.prefetch import device_put_batch
from advise_tpu_torch.engine.checkpoint import (
    CheckpointManager,
    auto_resume,
    load_pretrained,
    module_state,
    tensors_digest,
)
from advise_tpu_torch.engine.meters import TrainingHelper, busy_ms, device_events, device_ops, launch_times, span_split
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_knn_probe_step, make_train_step
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers.attention import ATTENTION_CALLS
from advise_tpu_torch.parallel.auto_shard import describe_sharding, shard_train_state
from advise_tpu_torch.parallel.collectives import check_same_on_every_rank, replica_index, world_size
from advise_tpu_torch.parallel.mesh import distributed_init, is_auto, world
from advise_tpu_torch.solver.lr_policy import PlateauController, get_lr_at_epoch
from advise_tpu_torch.solver.optimizer import OptimizerBundle, adjust_base_lr, build_tx
from advise_tpu_torch.utils.host_times import HOST_TIMES

logger = logging.getLogger(__name__)

# infos fields each task needs on the card
TASK_INFO_FIELDS = {
    "speed": ("spd_label",),
    "action_recog": ("cls_id",),
    "tmodeling": ("spd_label", "speeds"),
    "contrastive": ("item_id",),
    "masked": ("mask",),
}


def select_infos(cfg, infos: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        fields = ("item_id", "time_idx", "cls_id")  # cls_id feeds the kNN probe
    else:
        fields = TASK_INFO_FIELDS.get(cfg.TASK, ())
    return {k: infos[k] for k in fields if k in infos}


def seeded_generator(device, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``SeedSequence(keys)``."""
    seed = int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def ssl_digest(ssl: Dict[str, Any]) -> str:
    """:func:`tensors_digest` of the SSL state: every tensor of it by name
    (a module's parameters and buffers under its name), in name order."""
    flat: Dict[str, torch.Tensor] = {}
    for name in sorted(ssl):
        value = ssl[name]
        if isinstance(value, torch.nn.Module):
            flat.update({f"{name}.{k}": v for k, v in module_state(value).items()})
        elif isinstance(value, dict):
            flat.update({f"{name}.{k}": v for k, v in value.items()})
        else:
            flat[name] = value
    return tensors_digest(flat)


def check_ported(cfg) -> None:
    """Raise for the trainer options the port does not carry yet: none
    since the model-parallel layouts landed (the config's own validation
    rejects the combinations the JAX package rejects)."""


def rank_keys() -> Tuple[int, ...]:
    """What a rank adds to its generators' keys: its batch index among the
    ranks that carry distinct batches (ranks that differ only in 'seq',
    'pipe' or 'model' draw alike); nothing when one rank carries the
    batch."""
    return (replica_index(),) if world_size() > 1 else ()


def spatial_checkpoint(path: str) -> str:
    """MODEL.SPATIAL_MODEL_PATH as a file: a directory means the
    ``open_clip_pytorch_model.bin`` inside it."""
    if os.path.isdir(path):
        path = os.path.join(path, "open_clip_pytorch_model.bin")
    if not os.path.exists(path):
        raise FileNotFoundError(f"MODEL.SPATIAL_MODEL_PATH: no checkpoint at {path}")
    return path


def build_train_state(cfg, device) -> Tuple[TrainState, OptimizerBundle]:
    """The model (weights from TRAIN.SEED) on ``device``, its optimizer and
    state; for ContrastiveModel the SSL state too; for the TemporalModel the
    CLIP tower from MODEL.SPATIAL_MODEL_PATH when set, then the BYOL twins."""
    model = build_model(cfg, device, seed=cfg.TRAIN.SEED)
    params = dict(model.named_parameters())
    bundle = build_tx(cfg, params)
    state = TrainState(model, bundle.tx.init(params), 0)
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        from advise_tpu_torch.engine.contrastive import init_ssl_state

        state.ssl = init_ssl_state(cfg, model, seeded_generator(device, cfg.TRAIN.SEED, 7))
    elif cfg.MODEL.MODEL_NAME == "TemporalModel":
        from advise_tpu_torch.engine.steps import init_tmodeling_ssl
        from advise_tpu_torch.models.clip_vit import load_openclip_weights

        if cfg.MODEL.SPATIAL_MODEL_PATH:
            load_openclip_weights(spatial_checkpoint(cfg.MODEL.SPATIAL_MODEL_PATH), model.spatial_encoder)
        state.ssl = init_tmodeling_ssl(cfg, model)
    return state, bundle


class ProfileWindow:
    """``torch.profiler`` over the steps (start, start + steps] of the
    post-increment step counter, as the JAX trainer's ``_maybe_profile``,
    with the step's spans recorded (``utils/host_times.py``; the trace shows
    them as ``record_function`` ranges) and the device's time split by them
    (``engine/meters.py span_split``)."""

    def __init__(self, cfg):
        self.dir = cfg.TPU.PROFILE_DIR
        self.start, self.end = cfg.TPU.PROFILE_START, cfg.TPU.PROFILE_START + cfg.TPU.PROFILE_STEPS
        self.prof = None
        self.t0, self.first = 0.0, 0
        self.result: Optional[Dict[str, float]] = None

    def after_step(self, step: int) -> None:
        if not self.dir:
            return
        if self.prof is None and self.result is None and self.start < step <= self.end:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self.prof = profile(activities=activities)
            self.prof.start()
            HOST_TIMES.start()
            self.t0, self.first = time.perf_counter(), step
            logger.info("profiler trace started -> %s", self.dir)
        elif self.prof is not None and step > self.end:
            self.close(step)

    def close(self, step: int) -> None:
        """Stop an open window after ``step``: write the trace, log and keep
        the device's busy and idle shares of the window's wall time, and for
        each span its device busy ms, waited ms and launches a step
        (``spans``)."""
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - self.t0) * 1e3
        self.prof.stop()
        spans = HOST_TIMES.stop()
        os.makedirs(self.dir, exist_ok=True)
        rank = world()[0]
        self.prof.export_chrome_trace(os.path.join(self.dir, "trace.json" if rank == 0 else f"trace.rank{rank}.json"))
        busy = busy_ms((start, end) for _, start, end in device_events(self.prof))
        steps = step - self.first
        split = span_split(spans, device_ops(self.prof), launch_times(self.prof))
        per_step = {name: {k: v / max(steps, 1) for k, v in row.items()} for name, row in sorted(split.items())}
        self.result = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
                       "steps": steps, "spans": per_step}
        logger.info("profiler trace stopped: %d steps, wall %.3f ms, device busy %.3f ms, idle share %.4f; "
                    "a step by span (device busy ms, waited ms, launches): %s", steps, wall_ms, busy,
                    self.result["idle_share"], ", ".join(
                        f"{name} {row['busy_ms']:.3f} / {row['waited_ms']:.3f} / {row['launches']:.1f}"
                        for name, row in per_step.items()))
        self.prof = None


def trainer(cfg, tb_logger=None, device="cuda", record: Optional[Dict[str, Any]] = None) -> TrainState:
    """Train on ``device`` (the card unless the caller asks for the CPU).
    ``record``, when given, receives per-iteration lists ``iter_s`` (batch
    ready to stats read back), ``wait_s`` (the wait for the batch), the
    step's stats and ``attention_calls`` (the step's calls of each
    attention route, ``models/layers/attention.py ATTENTION_CALLS``), and
    at the start ``start_epoch``, ``start_step`` and ``model_sha256``
    (:func:`tensors_digest` of the model's parameters and BN buffers after
    any resume), ``ssl_sha256`` (:func:`ssl_digest`) and
    ``best_start`` (the checkpoints' best criteria, inf before any), and at
    the end ``model_sha256_end``, ``ssl_sha256_end``, ``best_end`` and
    ``host_s``, the input pipeline's stages over the run
    (:meth:`HostTimes.snapshot`, the kNN probe's batches included), and
    ``rank`` and ``world``. ``device`` is this rank's (``distributed_init``
    picks the card of a rank launched by torchrun)."""
    check_ported(cfg)
    HOST_TIMES.reset()
    device = distributed_init(cfg, device)  # sets cfg.NUM_WORLDS from the world
    rank, n_ranks = world()
    adjust_base_lr(cfg)

    loader = build_loader(cfg, "train")
    state, bundle = build_train_state(cfg, device)
    contrastive = cfg.MODEL.MODEL_NAME == "ContrastiveModel"
    if contrastive and cfg.CONTRASTIVE.KNN_ON:
        from advise_tpu_torch.engine.contrastive import knn_labels_from_dataset

        state.ssl["knn_labels"] = knn_labels_from_dataset(
            loader.dataset, cfg.CONTRASTIVE.LENGTH).to(device)
    n_params = sum(p.numel() for p in state.model.parameters())
    logger.info("model %s params: %s", cfg.MODEL.MODEL_NAME, f"{n_params:,}")

    ckpt = CheckpointManager(cfg)
    state, start_epoch, resumed = auto_resume(cfg, ckpt, state)
    if not resumed and cfg.RESUME:
        state, _, _ = load_pretrained(cfg.RESUME, state)
    if is_auto(cfg):
        # after any restore, as JAX shards at start-up keeping the restored moments
        specs = shard_train_state(cfg, state, bundle)
        logger.info(describe_sharding(specs)[1])
    digest, ssl_sha = tensors_digest(module_state(state.model)), ssl_digest(state.ssl)
    check_same_on_every_rank(digest, device, "the model's digest at the start")
    check_same_on_every_rank(ssl_sha, device, "the SSL state's digest at the start")
    logger.info("start: epoch %d, step %d, model sha256 %s%s (rank %d of %d)", start_epoch, state.step, digest,
                " (resumed)" if resumed else "", rank, n_ranks)
    if record is not None:
        record.update(start_epoch=start_epoch, start_step=state.step, model_sha256=digest,
                      ssl_sha256=ssl_sha, best_start=ckpt.best, rank=rank, world=n_ranks,
                      iter_s=[], wait_s=[], stats=[], attention_calls=[])

    # TPU.DEVICE_AUG False: the loader's host aug made the clips (no K3)
    device_aug = build_device_aug(cfg, "train") if cfg.TPU.DEVICE_AUG else None
    step_fn = make_train_step(cfg, bundle, device_aug)
    knn_probe_fn = None
    if contrastive and cfg.CONTRASTIVE.KNN_ON and cfg.CONTRASTIVE.KNN_EVAL_BATCHES > 0:
        knn_probe_fn = make_knn_probe_step(
            cfg, device_aug, num_classes=int(state.ssl["knn_labels"].max()) + 1)

    helper = TrainingHelper(cfg, tb_logger)
    plateau = PlateauController(cfg.SOLVER.BASE_LR) if cfg.SOLVER.LR_POLICY == "plateau" else None
    profile = ProfileWindow(cfg)
    n_prefetch = int(cfg.TPU.PREFETCH or 0)

    for epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        epoch_iters = loader.steps_per_epoch(epoch)
        helper.epoch_start(epoch, epoch_iters)
        batches = ((clips, select_infos(cfg, infos)) for clips, infos in loader.epoch(epoch))
        if n_prefetch > 1:
            device_iter = prefetch_to_device(batches, device, size=n_prefetch)
        else:
            device_iter = (device_put_batch(c, i, device)[:2] for c, i in batches)
        t_prev = time.perf_counter()
        for it, (clips_d, infos_d) in enumerate(device_iter):
            t_ready = time.perf_counter()
            helper.iter_start()
            epoch_exact = epoch + (it + 1) / max(epoch_iters, 1)
            if plateau is not None and epoch_exact > cfg.SOLVER.WARMUP_EPOCHS:
                lr = plateau.lr
            else:
                lr = get_lr_at_epoch(cfg, epoch_exact)
            helper.rt["curr_lr"] = lr
            gen = seeded_generator(device, cfg.TRAIN.SEED, epoch, it, *rank_keys())
            calls_before = dict(ATTENTION_CALLS)
            if contrastive:
                shared = seeded_generator(device, cfg.TRAIN.SEED, epoch, it) if n_ranks > 1 else None
                stats = step_fn(state, clips_d, infos_d, gen, lr, epoch_exact, shared)
            else:
                stats = step_fn(state, clips_d, infos_d, gen, lr)
            stats = {k: float(v) for k, v in stats.items()}  # waits for the step
            if record is not None:
                record["iter_s"].append(time.perf_counter() - t_ready)
                record["wait_s"].append(t_ready - t_prev)
                record["stats"].append(stats)
                record["attention_calls"].append({k: n - calls_before.get(k, 0) for k, n in ATTENTION_CALLS.items()
                                                  if n != calls_before.get(k, 0)})
            helper.update_stats(stats)
            helper.iter_end(it)
            profile.after_step(state.step)
            t_prev = time.perf_counter()
        if knn_probe_fn is not None:
            accs = []
            probe_iter = loader.epoch(epoch + 999983)  # a fresh shuffle
            for i, (clips, infos) in zip(range(cfg.CONTRASTIVE.KNN_EVAL_BATCHES), probe_iter):
                clips_d, infos_d, _ = device_put_batch(clips, select_infos(cfg, infos), device)
                gen = seeded_generator(device, cfg.TRAIN.SEED, 2**31 - 1 - epoch, i, *rank_keys())
                accs.append(float(knn_probe_fn(state, clips_d, infos_d, gen)))
            probe_iter.close()
            helper.rt["knn_acc"] = float(np.mean(accs))
            logger.info("epoch %d online kNN top-1: %.4f (%d batches)", epoch,
                        helper.rt["knn_acc"], len(accs))
        if cfg.VIS_MASK.ENABLE and cfg.MODEL.MODEL_NAME == "MaskMViT" and rank == 0:
            from advise_tpu_torch.utils.visualization import dump_mask_visualization

            vis_batch = loader.take_one(epoch + 424243)
            if vis_batch is not None:
                vis_clips = torch.from_numpy(vis_batch[0]).to(device)
                dump_mask_visualization(cfg, state.model, vis_clips, device_aug,
                                        seeded_generator(device, cfg.TRAIN.SEED, 424243 + epoch), epoch)
        summary = helper.epoch_end()
        if knn_probe_fn is not None:
            summary["knn_acc"] = helper.rt["knn_acc"]
        if plateau is not None:
            plateau.step(summary.get("loss_spd", summary.get("loss_cls", 0.0)))
        ckpt.save(state, epoch, summary)
    profile.close(state.step)  # a window that outlasts the run ends with it
    digest, ssl_sha = tensors_digest(module_state(state.model)), ssl_digest(state.ssl)
    check_same_on_every_rank(digest, device, "the model's digest at the end")
    check_same_on_every_rank(ssl_sha, device, "the SSL state's digest at the end")
    if record is not None:
        record["model_sha256_end"] = digest
        record["ssl_sha256_end"] = ssl_sha
        record["best_end"] = ckpt.best
        record["host_s"] = HOST_TIMES.snapshot()
        if profile.result is not None:
            record["profile"] = profile.result
    return state
