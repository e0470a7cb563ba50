"""Seconds the host spends in each named stage, summed over threads, with the
number of times each stage ran, and, between :meth:`HostTimes.start` and
:meth:`HostTimes.stop`, each span itself. The one span recorder of the port.

The stages: the input pipeline's (a worker's item: frame synthesis or
decode, then the resize, and with TPU.DEVICE_AUG False the host aug; the
main thread: the wait for items, the collate, the pinned copy) and the
train step's (``engine/steps.py``: ``step`` around one call, with
``step.aug``, ``step.forward``, ``step.backward``, ``step.bn_commit`` and
``step.optimizer`` inside it). The loader's workers and the main thread
add to one process-wide :data:`HOST_TIMES`; the trainer resets it at its
start and puts a snapshot in its run record, so the loader's wait per
iteration can be split into its stages.

The sums are always on. While recording, each span also keeps its name,
its parent (the span open on the same thread when it opened), its step
(given at a root span, inherited by the spans inside it), its thread and
its start and end in ns on ``time.time_ns``'s clock, which is the clock of
``torch.profiler``'s events (``start_ns()``). While a profiler runs, each
span also opens a ``record_function`` of its name, so the profiler's trace
shows it."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass
class Span:
    name: str
    parent: Optional[int]  # index of the enclosing span in the recorded list
    step: Optional[int]
    thread: int
    start_ns: int
    end_ns: Optional[int] = None  # None while open


class HostTimes:
    def __init__(self):
        self._lock = threading.Lock()
        self._open = threading.local()  # .stack: this thread's open spans, [(recording, index, step)]
        self._spans: Optional[List[Span]] = None
        self.reset()

    def reset(self) -> None:
        """Clear the sums (a recording goes on)."""
        with self._lock:
            self._s = collections.Counter()
            self._n = collections.Counter()

    def start(self) -> None:
        """Start recording spans (a recording under way starts anew)."""
        with self._lock:
            self._spans = []

    def stop(self) -> List[Span]:
        """Stop recording; the spans recorded since :meth:`start`, in the
        order they opened, [] without a recording."""
        with self._lock:
            spans, self._spans = self._spans, None
        return spans or []

    @contextlib.contextmanager
    def __call__(self, stage: str, step: Optional[int] = None):
        """Time ``stage``; ``step`` names the step of a root span."""
        spans = self._spans
        profiling = torch._C._autograd._profiler_enabled()
        if spans is None and not profiling:
            t = time.perf_counter()
            try:
                yield
            finally:
                self._add(stage, time.perf_counter() - t)
            return
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        if step is None and stack:
            step = stack[-1][2]
        span = index = None
        with torch.profiler.record_function(stage) if profiling else contextlib.nullcontext():
            t = time.perf_counter()
            if spans is not None:
                parent = stack[-1][1] if stack and stack[-1][0] is spans else None
                span = Span(stage, parent, step, threading.get_ident(), time.time_ns())
                with self._lock:
                    spans.append(span)
                    index = len(spans) - 1
            stack.append((spans, index, step))
            try:
                yield
            finally:
                stack.pop()
                if span is not None:
                    span.end_ns = time.time_ns()
                self._add(stage, time.perf_counter() - t)

    def _add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._s[stage] += seconds
            self._n[stage] += 1

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        """{stage: (seconds summed over threads, calls)}."""
        with self._lock:
            return {k: (self._s[k], self._n[k]) for k in sorted(self._s)}


HOST_TIMES = HostTimes()
