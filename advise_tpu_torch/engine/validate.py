"""Speed validation: a dense clip sweep into a confusion matrix (counterpart
of ``advise_tpu/engine/validate.py``; reference ``tools/validate.py:20-68``).

Each video gives one clip start every VAL.FPS frames, swept over every
label of VAL.RANGE, so the clip count varies per video: the host flattens
the clips into chunks of VAL.BATCHSIZE_PER_GPU (one card), pads the last
chunk with its last clip under label -1 (run, then dropped), and counts
each chunk's argmax into the confusion matrix. Every chunk's aug is drawn
from the same seed, as JAX passes ``PRNGKey(0)`` (folded with the replica)
to every chunk. Rank r of a world of N takes the videos r, r + N, ...;
the confusion matrix is summed over the world, and rank 0 writes the
per-class accuracies to ``LOGDIR/Metrics.csv`` in the JAX package's
format.
"""

from __future__ import annotations

import logging
import os
import statistics
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from advise_tpu_torch.data import build_dataset, build_device_aug, threaded_items
from advise_tpu_torch.data.prefetch import device_put_batch
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_eval_step
from advise_tpu_torch.parallel.collectives import psum_tree
from advise_tpu_torch.parallel.mesh import world

logger = logging.getLogger(__name__)


def eval_model(model: nn.Module, state: Optional[TrainState]) -> nn.Module:
    """``model`` with the weights of ``state.model`` (loaded into it unless
    they are the same module)."""
    if state is not None and state.model is not model:
        model.load_state_dict(state.model.state_dict())
    return model


class EvalTimes:
    """The eval loop's host-clock times: each batch's (handed to the step
    until its predictions are on the host) and the wait for each item."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.batch_s: List[float] = []
        self.wait_s = 0.0

    def items(self, iterator):
        """``iterator``'s items, the time spent waiting for each summed."""
        while True:
            t = time.perf_counter()
            try:
                item = next(iterator)
            except StopIteration:
                return
            finally:
                self.wait_s += time.perf_counter() - t
            yield item

    def summary(self, unit: str, count: int) -> Dict[str, Any]:
        """Wall seconds, batches, the median batch time, ``count`` ``unit``
        and their rate, the loader's wait."""
        seconds = time.perf_counter() - self.t0
        return {"seconds": seconds, "batches": len(self.batch_s),
                "batch_ms_median": statistics.median(self.batch_s) * 1e3 if self.batch_s else None,
                unit: count, f"{unit}_per_s": count / seconds, "wait_s": self.wait_s}


def write_metrics_csv(cfg, confusion: np.ndarray, per_class: np.ndarray, acc: float) -> None:
    """``LOGDIR/Metrics.csv``: a row per label (its counts and accuracy),
    then the total accuracy."""
    os.makedirs(cfg.LOGDIR, exist_ok=True)
    with open(os.path.join(cfg.LOGDIR, "Metrics.csv"), "w") as f:
        f.write("label," + ",".join(str(r) for r in cfg.VAL.RANGE) + ",acc\n")
        for i, r in enumerate(cfg.VAL.RANGE):
            row = ",".join(str(int(v)) for v in confusion[i])
            f.write(f"{r},{row},{per_class[i]:.4f}\n")
        f.write(f"total,,,,{acc:.4f}\n")


def validation(cfg, model: nn.Module, state: Optional[TrainState], device="cuda",
               max_videos: Optional[int] = None,
               record: Optional[Dict[str, Any]] = None) -> np.ndarray:
    """The confusion matrix [n_labels, n_labels] (rows: true labels) of
    ``model`` with ``state``'s weights over the first ``max_videos`` videos
    (all when None) of the 'speed' dataset, on ``device`` (the card unless
    the caller asks for the CPU). ``record``, when given, receives the
    phase's times (:meth:`EvalTimes.summary`, in clips), the confusion
    matrix and the accuracy."""
    from advise_tpu_torch.engine.train import rank_keys, seeded_generator

    device = torch.device(device)
    rank, n_ranks = world()
    model = eval_model(model, state)
    n_labels = len(cfg.VAL.RANGE)
    dataset = build_dataset(cfg, "speed")
    eval_step = make_eval_step(cfg, build_device_aug(cfg, "speed"))
    chunk = max(cfg.VAL.BATCHSIZE_PER_GPU, 1)
    confusion = np.zeros((n_labels, n_labels), np.int64)
    n_items = len(dataset) if max_videos is None else min(len(dataset), max_videos)
    times = EvalTimes()
    n_clips = 0

    def run(clips: List[np.ndarray], labels: List[int], real: int) -> None:
        t = time.perf_counter()
        batch, _, _ = device_put_batch(np.stack(clips)[:, None], {}, device)  # [B, 1, T, H, W, C]
        logits = eval_step(model, batch, seeded_generator(device, 0, 0, *rank_keys()))
        preds = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        times.batch_s.append(time.perf_counter() - t)
        for true, pred in zip(labels[:real], preds[:real]):
            confusion[int(true), int(pred)] += 1

    pending_clips: List[np.ndarray] = []
    pending_labels: List[int] = []
    items = threaded_items(dataset, n_items, lambda idx: [cfg.INFER.SEED, 0, idx],
                           num_workers=cfg.DATA.WORKERS, rank=rank, world=n_ranks)
    for _, (clips, infos) in times.items(items):
        pending_clips.extend(clips)
        pending_labels.extend(int(v) for v in infos["spd_label"])
        n_clips += len(clips)
        while len(pending_clips) >= chunk:
            run(pending_clips[:chunk], pending_labels[:chunk], chunk)
            pending_clips, pending_labels = pending_clips[chunk:], pending_labels[chunk:]
    if pending_clips:
        real = len(pending_clips)
        pad = chunk - real
        run(pending_clips + [pending_clips[-1]] * pad, pending_labels + [-1] * pad, real)

    summed = psum_tree({"confusion": torch.from_numpy(confusion).to(device),
                        "clips": torch.tensor(n_clips, device=device)})
    confusion, n_clips = summed["confusion"].cpu().numpy(), int(summed["clips"])
    per_class = confusion.diagonal() / np.maximum(confusion.sum(axis=1), 1)
    acc = confusion.diagonal().sum() / max(confusion.sum(), 1)
    logger.info("speed val acc: %.4f per-class: %s", acc, np.round(per_class, 4))
    if getattr(cfg, "LOGDIR", None) and rank == 0:
        write_metrics_csv(cfg, confusion, per_class, acc)
    if record is not None:
        record.update(times.summary("clips", n_clips), confusion=confusion.tolist(), acc=float(acc))
    return confusion
