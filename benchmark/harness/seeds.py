"""Seeds derived from the run's ``--seed``, one for each use, so that every
input, weight and draw of a run follows from that one number."""

from __future__ import annotations

import hashlib


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the use named by ``tags`` under ``seed``."""
    text = ":".join(str(t) for t in (seed,) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") & (2**63 - 1)
