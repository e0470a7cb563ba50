"""Logging setup: the port's copy of ``advise_tpu/utils/logging.py``
(reference ``utils/misc.py:623-658``): rank 0 logs INFO to stdout and
LOGDIR/log.txt, other ranks ERROR only."""

from __future__ import annotations

import logging
import os
import subprocess
import sys


def setup_logger(cfg) -> logging.Logger:
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    is_master = getattr(cfg, "RANK", 0) == 0
    root.setLevel(logging.INFO if is_master else logging.ERROR)
    fmt = logging.Formatter(
        "[%(asctime)s][%(levelname)s] %(name)s: %(message)s", "%m/%d %H:%M:%S"
    )
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if is_master and getattr(cfg, "LOGDIR", None):
        os.makedirs(cfg.LOGDIR, exist_ok=True)
        fh = logging.FileHandler(os.path.join(cfg.LOGDIR, "log.txt"))
        fh.setFormatter(fmt)
        root.addHandler(fh)
    return root


def get_commit_sha() -> str:
    """The checkout's git commit, or "unknown" outside a git checkout
    (reference tools/run.py:69-74)."""
    try:
        return (
            subprocess.check_output(
                ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL
            )
            .decode()
            .strip()
        )
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
