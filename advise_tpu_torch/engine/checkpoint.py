"""Checkpointing: periodic + best + auto-resume + pretrain init. The
counterpart of ``advise_tpu/engine/checkpoint.py:46-273`` with
``torch.save`` in place of Orbax.

Same names (``<LOGDIR>/checkpoints/Model_Epoch_%04d`` and ``Model_Best``,
each a directory, here holding ``state.pt``), the same TRAIN.SAVE_FREQ and
best-criteria policy (:data:`_CRITERIA_ORDER`, :func:`default_criteria`)
and the same ``<name>.meta.npy`` sidecar ({'epoch', 'summary'[, 'best']}).
A checkpoint holds the whole train state: the model's parameters and BN
buffers, the SSL state (the momentum encoder's parameters and buffers,
the kNN bank and its labels), the optimizer state, the step and the
epoch. The remote mirror (TRAIN.CHECKPOINT_REMOTE) raises, as the port's
``utils/storage.py`` does for any remote path.

Only rank 0 writes (``advise_tpu/engine/checkpoint.py:66``, ``:95``); every
rank keeps the best criteria and waits for the write at a barrier, and
every rank restores from the same file. Under TPU.PARTITION_MODE 'auto' a
checkpoint holds whole tensors, gathered by every rank from the shards
before rank 0 writes (``parallel/auto_shard.py``), and a restore cuts them
to the rank's shards: a checkpoint written under 'auto' restores in a plain
run, and the other way round.

Two restore modes, as in the JAX package: the strict resume of the whole
state (TRAIN.RESUME / TRAIN.AUTO_RESUME, :func:`auto_resume`) and the
filtered pretrain init of parameters and BN buffers (top-level RESUME,
:func:`load_pretrained`).
"""

from __future__ import annotations

import hashlib
import logging
import os
import re
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.parallel.auto_shard import layout_of, map_moments
from advise_tpu_torch.parallel.collectives import barrier
from advise_tpu_torch.parallel.mesh import world
from advise_tpu_torch.utils.storage import local_path

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
# per-task primary criteria key; else the first loss_* of the summary
_CRITERIA_ORDER = (
    "loss_spd", "loss_cls", "loss_mask", "loss_nce", "loss_byol",
    "loss_swav", "loss_simclr",
)


def default_criteria(summary: Dict[str, float]) -> float:
    for k in _CRITERIA_ORDER:
        if k in summary:
            return summary[k]
    for k in sorted(summary):
        if k.startswith("loss"):
            return summary[k]
    return 0.0


def module_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with whole tensors: gathered from the shards
    under 'auto' (a collective: every rank calls it)."""
    layout = layout_of(module)
    return module.state_dict() if layout is None else layout.full_state()


def _load_module(module: nn.Module, saved: Dict[str, torch.Tensor]) -> None:
    layout = layout_of(module)
    if layout is None:
        module.load_state_dict(saved)
    else:
        layout.load_full(saved)


def state_dict(state) -> Dict[str, Any]:
    """The whole train state as one dict of tensors and numbers, with whole
    tensors under 'auto' (every rank calls it there); a dict it was already
    made into passes through."""
    if isinstance(state, dict):
        return state
    ssl = {k: (module_state(v) if isinstance(v, nn.Module) else v) for k, v in state.ssl.items()}
    opt_state = state.opt_state
    layout = layout_of(state.model)
    if layout is not None:
        opt_state = map_moments(opt_state, layout.full_tensors)
    return {"model": module_state(state.model), "opt_state": opt_state,
            "step": int(state.step), "ssl": ssl}


def load_state_dict(state: TrainState, saved: Dict[str, Any]) -> TrainState:
    """In place: ``saved`` (from :func:`state_dict`) into ``state``; the
    modules keep their tensors' devices and layouts (under 'auto' each rank
    takes its shards of the whole tensors)."""
    _load_module(state.model, saved["model"])
    layout = layout_of(state.model)
    state.opt_state = saved["opt_state"] if layout is None else map_moments(saved["opt_state"], layout.local_tensors)
    state.step = int(saved["step"])
    for k, v in saved["ssl"].items():
        if isinstance(state.ssl.get(k), nn.Module):
            _load_module(state.ssl[k], v)
        else:
            state.ssl[k] = v
    return state


def tensors_digest(tensors: Dict[str, torch.Tensor]) -> str:
    """sha256 over the names and the bytes of ``tensors`` in order: two
    equal digests mean the same values bit for bit."""
    h = hashlib.sha256()
    for name, t in tensors.items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, cfg, criteria_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.dir = os.path.abspath(os.path.join(local_path(cfg.LOGDIR), "checkpoints"))
        self.save_freq = cfg.TRAIN.SAVE_FREQ
        self.criteria_fn = criteria_fn or default_criteria
        if cfg.TRAIN.CHECKPOINT_REMOTE:
            raise NotImplementedError(
                f"TRAIN.CHECKPOINT_REMOTE={cfg.TRAIN.CHECKPOINT_REMOTE!r}: the port writes "
                "local checkpoints only (no fsspec on the card's machine)")
        os.makedirs(self.dir, exist_ok=True)
        # the best criteria survives restarts through Model_Best's sidecar
        self.best = float("inf")
        meta = self._load_meta(self._path("Model_Best"))
        if meta and "best" in meta:
            self.best = float(meta["best"])
            logger.info("best criteria restored from sidecar: %.4f", self.best)

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    @staticmethod
    def _load_meta(path: str) -> Optional[Dict]:
        if not os.path.exists(path + ".meta.npy"):
            return None
        return np.load(path + ".meta.npy", allow_pickle=True)[0]

    def save(self, state: TrainState, epoch: int, summary: Dict[str, float]):
        """Periodic + best save (reference misc.py:280-349) by rank 0, the
        other ranks waiting at a barrier. TRAIN.SAVE_FREQ <= 0 disables every
        write."""
        if self.save_freq <= 0:
            return
        writer = world()[0] == 0
        meta = {"epoch": epoch, "summary": dict(summary)}
        periodic = (epoch + 1) % self.save_freq == 0 or epoch + 1 == self.cfg.SOLVER.MAX_EPOCH
        crit = self.criteria_fn(summary)
        if (periodic or crit < self.best) and layout_of(state.model) is not None:
            state = state_dict(state)  # whole tensors, gathered by every rank
        if periodic:
            p = self._path(f"Model_Epoch_{epoch:04d}")
            if writer:
                self._save_at(p, state, meta)
                logger.info("checkpoint saved: %s", p)
        if crit < self.best:
            self.best = crit
            p = self._path("Model_Best")
            if writer:
                self._save_at(p, state, {**meta, "best": crit})
                logger.info("best checkpoint updated (criteria %.4f): %s", crit, p)
        barrier()

    def _save_at(self, path: str, state, meta: Dict):
        # write beside, then swap in: a crash mid-write leaves the old one
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({**state_dict(state), "epoch": meta["epoch"]}, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        np.save(path + ".meta.npy", np.array([meta], dtype=object))

    def get_last_checkpoint(self) -> Optional[Tuple[str, int]]:
        """The newest Model_Epoch_* (reference misc.py:258-278)."""
        best_ep, best_path = -1, None
        if os.path.isdir(self.dir):
            for name in os.listdir(self.dir):
                m = re.fullmatch(r"Model_Epoch_(\d{4})", name)
                if m and int(m.group(1)) > best_ep:
                    best_ep, best_path = int(m.group(1)), self._path(name)
        return (best_path, best_ep) if best_path is not None else None

    def restore(self, path: str, state: TrainState) -> TrainState:
        """Restore the whole state saved at ``path`` into ``state``."""
        device = next(state.model.parameters()).device
        saved = torch.load(os.path.join(local_path(path), STATE_FILE), map_location=device,
                           weights_only=False)
        return load_state_dict(state, saved)


def load_pretrained(path: str, state: TrainState, drop_substr: Tuple[str, ...] = ("head",)):
    """Filtered, shape-tolerant init of the parameters and BN buffers from
    a pretrain checkpoint (``advise_tpu/engine/checkpoint.py:167-253``):

    - checkpoint keys under ``backbone.`` (ContrastiveModel pretrains) and
      ``encoder.`` (MaskMViT pretrains) also serve the bare target keys;
    - a target key containing one of ``drop_substr`` keeps its fresh init;
    - a shape mismatch is skipped with a warning;
    - optimizer state, step and SSL state stay fresh.

    Returns (state, loaded_keys, skipped_keys)."""
    device = next(state.model.parameters()).device
    src = torch.load(os.path.join(local_path(path), STATE_FILE), map_location=device,
                     weights_only=False)["model"]
    alias = {}
    for prefix in ("backbone.", "encoder."):
        alias.update({k[len(prefix):]: v for k, v in src.items() if k.startswith(prefix)})
    target = state.model.state_dict()
    new, loaded, skipped = {}, [], []  # type: Dict[str, torch.Tensor], List[str], List[str]
    for key, cur in target.items():
        if any(s in key for s in drop_substr):
            skipped.append(f"{key} (dropped prefix)")
            continue
        cand = src.get(key, alias.get(key))
        if cand is None:
            skipped.append(f"{key} (missing in ckpt)")
        elif tuple(cand.shape) != tuple(cur.shape):
            skipped.append(f"{key} (shape {tuple(cand.shape)} vs {tuple(cur.shape)})")
            logger.warning("pretrain init: %s skipped, shape %s vs %s", key,
                           tuple(cand.shape), tuple(cur.shape))
        else:
            loaded.append(key)
            new[key] = cand.to(cur.dtype)
    state.model.load_state_dict(new, strict=False)
    logger.info("pretrain init from %s: %d keys loaded, %d skipped", path, len(loaded), len(skipped))
    if skipped:
        logger.info("skipped keys:\n%s", "\n".join("  " + s for s in skipped))
    return state, loaded, skipped


def auto_resume(cfg, manager: CheckpointManager, state: TrainState):
    """TRAIN.RESUME, else with TRAIN.AUTO_RESUME the newest epoch
    checkpoint (reference tools/train.py:317-319). Returns (state,
    start_epoch, resumed): a resume from epoch e starts at e + 1."""
    path, epoch = None, -1
    if cfg.TRAIN.RESUME:
        path = cfg.TRAIN.RESUME
        m = re.search(r"Model_Epoch_(\d{4})", path)
        epoch = int(m.group(1)) if m else -1
    elif cfg.TRAIN.AUTO_RESUME:
        last = manager.get_last_checkpoint()
        if last:
            path, epoch = last
    if path is None:
        return state, cfg.SOLVER.START_EPOCH, False
    logger.info("resuming from %s (epoch %d)", path, epoch)
    state = manager.restore(path, state)
    return state, epoch + 1, True
