"""Action inference: multi-clip x multi-crop evaluation (counterpart of
``advise_tpu/engine/inference.py``; reference ``tools/inference.py:17-85``).

Per video, INFER.NUM_CLIPS starts x INFER.NUM_CROPS duplicates are sampled,
each view cropped at random to INFER.RES; a batch holds the views of
INFER.BATCHSIZE_PER_GPU videos (one card) flattened into one batch, a short
last batch padded with its last video (run, then dropped). Each video's
logits are averaged over its views before the argmax against its cls_id.
Every batch's crops are drawn from the same seed, INFER.SEED, as JAX passes
``PRNGKey(INFER.SEED)`` (folded with the replica) to every batch. Rank r
of a world of N takes the videos r, r + N, ...; correct and total are
summed over the world.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from advise_tpu_torch.data import build_dataset, build_device_aug, threaded_items
from advise_tpu_torch.data.prefetch import device_put_batch
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_eval_step
from advise_tpu_torch.engine.validate import EvalTimes, eval_model
from advise_tpu_torch.parallel.collectives import psum_tree
from advise_tpu_torch.parallel.mesh import world

logger = logging.getLogger(__name__)


def inference(cfg, model: nn.Module, state: Optional[TrainState], device="cuda",
              max_videos: Optional[int] = None,
              record: Optional[Dict[str, Any]] = None) -> Tuple[float, int, int]:
    """(top-1 accuracy, correct, total) of ``model`` with ``state``'s weights
    over the first ``max_videos`` videos (all when None) of the 'action'
    dataset, on ``device`` (the card unless the caller asks for the CPU).
    ``record``, when given, receives the phase's times
    (:meth:`EvalTimes.summary`, in views) and acc, correct and total."""
    from advise_tpu_torch.engine.train import rank_keys, seeded_generator

    device = torch.device(device)
    rank, n_ranks = world()
    model = eval_model(model, state)
    dataset = build_dataset(cfg, "action")
    eval_step = make_eval_step(cfg, build_device_aug(cfg, "action"))
    views = cfg.INFER.NUM_CLIPS * cfg.INFER.NUM_CROPS
    vids_per_batch = max(cfg.INFER.BATCHSIZE_PER_GPU, 1)
    n_items = len(dataset) if max_videos is None else min(len(dataset), max_videos)
    times = EvalTimes()
    correct = total = 0
    buf_clips: List[np.ndarray] = []
    buf_labels: List[int] = []

    def flush() -> None:
        nonlocal correct, total, buf_clips, buf_labels
        if not buf_clips:
            return
        t = time.perf_counter()
        real = len(buf_clips)
        clips = np.stack(buf_clips + [buf_clips[-1]] * (vids_per_batch - real))  # [V, views, ...]
        flat = clips.reshape(vids_per_batch * views, 1, *clips.shape[2:])
        batch, _, _ = device_put_batch(flat, {}, device)
        logits = eval_step(model, batch, seeded_generator(device, cfg.INFER.SEED, 0, *rank_keys()))
        logits = logits.reshape(vids_per_batch, views, -1).float()
        preds = torch.argmax(logits.mean(dim=1), dim=-1).cpu().numpy()
        times.batch_s.append(time.perf_counter() - t)
        for label, pred in zip(buf_labels[:real], preds[:real]):
            total += 1
            correct += int(pred == label)
        buf_clips, buf_labels = [], []

    items = threaded_items(dataset, n_items, lambda idx: [cfg.INFER.SEED, 1, idx],
                           num_workers=cfg.DATA.WORKERS, rank=rank, world=n_ranks)
    for _, (clips, infos) in times.items(items):
        buf_clips.append(clips)  # [views, T, H, W, C]
        buf_labels.append(int(infos["cls_id"]))
        if len(buf_clips) == vids_per_batch:
            flush()
    flush()

    summed = psum_tree({"correct": torch.tensor(correct, device=device),
                        "total": torch.tensor(total, device=device)})
    correct, total = int(summed["correct"]), int(summed["total"])
    acc = correct / max(total, 1)
    logger.info("action inference: Acc@1 %.4f (%d/%d), %d views/video", acc, correct, total, views)
    if record is not None:
        record.update(times.summary("views", total * views), acc=acc, correct=correct, total=total)
    return acc, correct, total
