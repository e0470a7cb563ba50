"""Entry point of the port, one process a card:

    python -m advise_tpu_torch.tools.run --cfg X.yaml --output DIR [K V ...]
    python -m torch.distributed.run --nproc_per_node N -m advise_tpu_torch.tools.run --cfg X.yaml --output DIR ...

The counterpart of ``advise_tpu/tools/run.py``: the config files are
merged in order, the trailing ``K V`` pairs override them, DIR becomes
cfg.LOGDIR (logs, ``checkpoints/``, ``Metrics.csv``), and the phases of
cfg.PIPELINE run in order: 'train', 'speed_val' (``engine/validate.py``)
and 'action_infer' (``engine/inference.py``); other '<x>_val' and
'<x>_infer' fail their assertion, as in JAX. An eval phase takes the state
that 'train' left; without one it loads MODELDATA, else RESUME, else
``LOGDIR/checkpoints/Model_Best`` (:func:`_load_eval_state`). One process
drives one card: under torchrun each rank joins the job
(``parallel/mesh.py distributed_init``: NCCL where every rank has a card of
its own, gloo where ranks share one) and takes ``cuda:LOCAL_RANK``; alone
it is rank 0 of a world of 1. A rank without a card raises; there is no
CPU switch: tests call ``engine.train.trainer``, ``validation`` and
``inference`` with ``device="cpu"``. tensorboardX, where it imports, logs
to DIR from rank 0.

At the end the run logs one line ``run record: {...}`` (JSON) with the
trainer's record (``engine/train.py trainer``: start epoch and step, the
model's sha256 at the start and the end, per-iteration time, wait and stats, the
profile window's idle share), one entry per eval phase under its name
(wall seconds, batches and their median time, clips or views and their
rate, the loader's wait, the result, the phase's peak allocated memory),
each kernel's launch count, the attention's calls by route over the
process (``attention_calls_total``, ``models/layers/attention.py
ATTENTION_CALLS``; the trainer's ``attention_calls`` has them step by
step) and the peak allocated memory on the card;
``main`` returns the same record. In a world of more than one, rank 0
logs it and every rank r also writes its own to
``DIR/run_record.rank{r}.json``. The launch counts are the process's:
a caller that runs ``main`` more than once in one process sets each of
:func:`counted_wrappers`' ``launches`` to 0 before each run.
"""

from __future__ import annotations

import json
import logging
import os

import torch
import torch.distributed as dist

from advise_tpu_torch.config import assert_and_infer_cfg, load_config, parse_args
from advise_tpu_torch.engine.inference import inference
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.train import trainer
from advise_tpu_torch.engine.validate import validation
from advise_tpu_torch.models.layers.attention import ATTENTION_CALLS
from advise_tpu_torch.parallel.mesh import distributed_init, world
from advise_tpu_torch.utils.logging import get_commit_sha, setup_logger

logger = logging.getLogger(__name__)


def counted_wrappers():
    """Every kernel wrapper that counts its launches (``fn.launches``)."""
    from advise_tpu_torch.ops import batch_norm as bn
    from advise_tpu_torch.ops import flash_attention as fl
    from advise_tpu_torch.ops import fused_aug as fa
    from advise_tpu_torch.ops import stem_conv as sc
    from advise_tpu_torch.ops import window_probe as wp

    return [sc.stem_conv_fwd, sc.stem_conv_wgrad, fa.fused_simple_aug, fl.flash_mha_fwd,
            fl.flash_mha_bwd, fl.flash_f32_fwd, fl.flash_f32_bwd, *wp.ENTRIES.values(),
            *bn.COUNTED]


def kernel_launches():
    """Every kernel wrapper's launch count, by name."""
    return {fn.__name__: fn.launches for fn in counted_wrappers()}


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = assert_and_infer_cfg(load_config(args))
    cfg.RANK = int(os.environ.get("RANK", "0"))  # torchrun's, for the logger; distributed_init sets it again
    setup_logger(cfg)
    if not torch.cuda.is_available():
        raise SystemExit("advise_tpu_torch.tools.run: no CUDA card; the port trains on a card")
    device = distributed_init(cfg, "cuda")
    cfg.COMMIT_SHA = get_commit_sha()
    rank, n_ranks = world()
    logger.info("device: %s (%d visible), torch %s, CUDA %s; rank %d of %d on %s", torch.cuda.get_device_name(0),
                torch.cuda.device_count(), torch.__version__, torch.version.cuda, rank, n_ranks, device)
    logger.info("commit: %s", cfg.COMMIT_SHA)

    tb = None
    if rank == 0:
        try:
            from tensorboardX import SummaryWriter

            tb = SummaryWriter(logdir=cfg.LOGDIR)
        except ImportError:
            pass

    record = {}
    state = None
    peak = 0
    for phase in cfg.PIPELINE:
        torch.cuda.reset_peak_memory_stats(device)
        if phase == "train":
            logger.info("=== phase: train (task=%s) ===", cfg.TASK)
            state = trainer(cfg, tb_logger=tb, device=device, record=record)
        elif phase.endswith("_val"):
            val_type = phase[: -len("_val")]
            assert val_type == "speed", f"val type {val_type} not implemented"
            logger.info("=== phase: %s ===", phase)
            if state is None:
                state = _load_eval_state(cfg, device)
            record[phase] = {}
            validation(cfg, state.model, state, device=device, record=record[phase])
        elif phase.endswith("_infer"):
            infer_type = phase[: -len("_infer")]
            assert infer_type == "action", f"infer type {infer_type} not implemented"
            logger.info("=== phase: %s ===", phase)
            if state is None:
                state = _load_eval_state(cfg, device)
            record[phase] = {}
            inference(cfg, state.model, state, device=device, record=record[phase])
        else:
            raise NotImplementedError(f"pipeline phase: {phase}")
        torch.cuda.synchronize(device)
        peak = max(peak, torch.cuda.max_memory_allocated(device))
        if phase != "train":
            record[phase]["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
    record.update(launches=kernel_launches(), attention_calls_total=dict(ATTENTION_CALLS),
                  peak_allocated_bytes=peak,
                  device=torch.cuda.get_device_name(device))
    logger.info("run record: %s", json.dumps(record))
    if n_ranks > 1:
        with open(os.path.join(cfg.LOGDIR, f"run_record.rank{rank}.json"), "w") as f:
            json.dump(record, f)
    logger.info("pipeline complete")
    return record


def _load_eval_state(cfg, device) -> TrainState:
    """The state of an eval-only pipeline: the model (weights of INFER.SEED)
    restored from MODELDATA, else RESUME, else ``LOGDIR/checkpoints/
    Model_Best``; with none of them on disk, the random weights, with a
    warning."""
    from advise_tpu_torch.engine.checkpoint import CheckpointManager
    from advise_tpu_torch.models import build_model

    state = TrainState(build_model(cfg, device, seed=cfg.INFER.SEED), {}, 0)
    path = cfg.MODELDATA or cfg.RESUME or os.path.join(cfg.LOGDIR, "checkpoints", "Model_Best")
    if os.path.isdir(path):
        state = CheckpointManager(cfg).restore(path, state)
        logger.info("eval state loaded from %s", path)
    else:
        logger.warning("no checkpoint at %s — evaluating random init", path)
    return state


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
