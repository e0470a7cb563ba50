"""The measured window: steps launched back to back for ``seconds``, at most
``DEPTH`` of them queued ahead of the device, a CUDA event recorded after
each on the step's stream. Nothing synchronises inside the window but the
wait on the event ``DEPTH`` steps back, which keeps the host from queueing
more work than the window can finish."""

from __future__ import annotations

import time
from typing import Callable, List

import torch

DEPTH = 2


def run(call: Callable[[int], dict], first: int, seconds: float, loss_key: str, on_card: bool) -> dict:
    """Steps ``first, first + 1, ...`` by ``call(i)`` until ``seconds`` have
    passed on the host's clock since the first launch, then a synchronise.
    Returns the steps, the window's seconds (first launch to that
    synchronise), each step's milliseconds between consecutive events (the
    first from an event recorded just before the first launch), the peak
    of allocated memory over the window and each step's loss tensor."""
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    events: List = []
    host_ends: List[float] = []
    losses = []
    i = first
    t0 = time.perf_counter()
    while True:
        if on_card and len(events) >= DEPTH:
            events[-DEPTH].synchronize()
        stats = call(i)
        losses.append(stats[loss_key].detach())
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            host_ends.append(time.perf_counter())
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if on_card:
        step_ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1], events)]
        peak = torch.cuda.max_memory_allocated()
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip([t0] + host_ends[:-1], host_ends)]
        peak = 0
    return {"steps": i - first, "seconds": t1 - t0, "step_ms": step_ms, "peak_bytes": peak,
            "losses": losses}
