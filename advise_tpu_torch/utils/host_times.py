"""Seconds the host spends in each named stage of the input pipeline, summed
over threads, with the number of times each stage ran. The loader's workers
and the main thread add to one process-wide :data:`HOST_TIMES`; the trainer
resets it at its start and puts a snapshot in its run record, so the
loader's wait per iteration can be split into its stages (a worker's item:
frame synthesis or decode, then the resize, and with TPU.DEVICE_AUG False
the host aug; the main thread: the wait for
items, the collate, the pinned copy)."""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, Tuple


class HostTimes:
    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._s = collections.Counter()
            self._n = collections.Counter()

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            with self._lock:
                self._s[stage] += dt
                self._n[stage] += 1

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        """{stage: (seconds summed over threads, calls)}."""
        with self._lock:
            return {k: (self._s[k], self._n[k]) for k in sorted(self._s)}


HOST_TIMES = HostTimes()
