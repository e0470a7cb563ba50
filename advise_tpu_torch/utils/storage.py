"""Paths for videos and checkpoints: the port's copy of the local half of
``advise_tpu/utils/storage.py``. The JAX package reaches remote object
stores (s3://, gs://, ...) through fsspec; the card's machine has no
fsspec, so here a remote URL raises and every path is a local one."""

from __future__ import annotations


def is_remote(path) -> bool:
    p = str(path)
    return "://" in p and not p.startswith("file://")


def local_path(path) -> str:
    """``path`` as a local filesystem path; raises for a remote URL."""
    if is_remote(path):
        raise NotImplementedError(
            f"remote path {path!r}: the port reads and writes local paths only "
            "(no fsspec on the card's machine)"
        )
    p = str(path)
    return p[len("file://"):] if p.startswith("file://") else p
