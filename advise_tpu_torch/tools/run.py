"""Entry point of the port on one card:

    python -m advise_tpu_torch.tools.run --cfg X.yaml --output DIR [K V ...]

The counterpart of ``advise_tpu/tools/run.py:51-95``: the config files are
merged in order, the trailing ``K V`` pairs override them, DIR becomes
cfg.LOGDIR (logs, ``checkpoints/``), and the phases of cfg.PIPELINE run in
order. 'train' is ported; '<x>_val' and '<x>_infer' raise
NotImplementedError (ROADMAP A items 5-6). One process drives one card
(rank 0 of a world of 1); there is no CPU switch: tests call
``engine.train.trainer(cfg, device="cpu")``. tensorboardX, where it imports,
logs to DIR.

At the end the run logs one line ``run record: {...}`` (JSON) with the
trainer's record (``engine/train.py trainer``: start epoch and step, the
model's sha256 at the start and the end, per-iteration time, wait and stats, the
profile window's idle share), each kernel's launch count and the peak
allocated memory on the card.
"""

from __future__ import annotations

import json
import logging

import torch

from advise_tpu_torch.config import assert_and_infer_cfg, load_config, parse_args
from advise_tpu_torch.engine.train import trainer
from advise_tpu_torch.utils.logging import get_commit_sha, setup_logger

logger = logging.getLogger(__name__)


def kernel_launches():
    """Every kernel wrapper's launch count, by name."""
    from advise_tpu_torch.ops import flash_attention as fl
    from advise_tpu_torch.ops import fused_aug as fa
    from advise_tpu_torch.ops import stem_conv as sc
    from advise_tpu_torch.ops import window_probe as wp

    counted = [sc.stem_conv_fwd, sc.stem_conv_wgrad, fa.fused_simple_aug, fl.flash_mha_fwd,
               fl.flash_mha_bwd, *wp.ENTRIES.values()]
    return {fn.__name__: fn.launches for fn in counted}


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = assert_and_infer_cfg(load_config(args))
    cfg.RANK, cfg.LOCAL_RANK, cfg.NUM_WORLDS = 0, 0, 1
    setup_logger(cfg)
    if not torch.cuda.is_available():
        raise SystemExit("advise_tpu_torch.tools.run: no CUDA card; the port trains on a card")
    cfg.COMMIT_SHA = get_commit_sha()
    logger.info("device: %s (%d visible), torch %s, CUDA %s", torch.cuda.get_device_name(0),
                torch.cuda.device_count(), torch.__version__, torch.version.cuda)
    logger.info("commit: %s", cfg.COMMIT_SHA)

    tb = None
    try:
        from tensorboardX import SummaryWriter

        tb = SummaryWriter(logdir=cfg.LOGDIR)
    except ImportError:
        pass

    record = {}
    for phase in cfg.PIPELINE:
        if phase == "train":
            logger.info("=== phase: train (task=%s) ===", cfg.TASK)
            trainer(cfg, tb_logger=tb, device="cuda", record=record)
        elif phase.endswith("_val") or phase.endswith("_infer"):
            raise NotImplementedError(
                f"pipeline phase {phase!r} is not ported yet (ROADMAP A items 5-6)")
        else:
            raise NotImplementedError(f"pipeline phase: {phase}")
    torch.cuda.synchronize()
    record.update(launches=kernel_launches(), peak_allocated_bytes=torch.cuda.max_memory_allocated(),
                  device=torch.cuda.get_device_name(0))
    logger.info("run record: %s", json.dumps(record))
    logger.info("pipeline complete")


if __name__ == "__main__":
    main()
