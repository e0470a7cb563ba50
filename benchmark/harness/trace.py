"""The traced steps: ``torch.profiler`` over a few steps after the window,
reduced from its raw kineto events (building the profiler's FunctionEvent
list costs tens of microseconds of host time an event) to plain records
that the per-layer readers take:

- ``device``: every operation that ran on the card (kernel, copy, set) as
  (name, start ns, duration ns);
- ``ops``: each call of a host operator that some reader of the cell names
  in its ``HOST_OPS`` (:func:`host_ops`), with its input shapes, types and
  scalar arguments, and the device seconds of the operations it launched,
  linked by the launch's correlation id;
- ``wall_s``: the first stretch's span on the device's clock, from its
  first operation's start to its last one's end (CUPTI's start-up, a
  quarter of a second before the first operation, is not the program's).
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, Iterable, List

import torch


def host_ops(readers: Iterable) -> tuple:
    """The host operators whose calls the readers need with their shapes:
    the union of each reader module's ``HOST_OPS``."""
    return tuple(sorted({op for r in readers for op in getattr(r, "HOST_OPS", ())}))


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def _is_launch(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and not name.startswith("cudnn")


def _record(call, first: int, steps: int, on_card: bool, host_ops: bool):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    activities = ([ProfilerActivity.CPU] if host_ops or not on_card else []) + (
        [ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities, record_shapes=host_ops) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + steps):
            call(i)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host, launches = [], [], {}
    for e in _events(prof):
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), e.start_ns(), e.duration_ns(), e.correlation_id()))
        elif _is_launch(e.name()):
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        else:
            host.append(e)
    return wall, device, host, launches


def profile(call: Callable[[int], dict], first: int, steps: int, on_card: bool, ops: tuple = ()) -> dict:
    """Profiled stretches of ``steps`` steps each, from step ``first``: the
    device's operations alone (CUPTI's activity records cost the host next
    to nothing, so the device's idle time is the program's), then, where
    ``ops`` names host operators, a second with the host's operators and
    their shapes too, whose recording slows the host and is read only for
    ``ops``. A throwaway profile first sets CUPTI up."""
    if on_card:
        _record(lambda i: None, 0, 1, on_card, False)
    wall, device, _, _ = _record(call, first, steps, on_card, False)
    calls = []
    if ops:
        _, device_b, host, launches = _record(call, first + steps, steps, on_card, True)
        calls = _link_ops(host, launches, device_b, ops)
    if device:
        wall = (max(s + d for _, s, d, _ in device) - min(s for _, s, _, _ in device)) / 1e9
    return {"steps": steps, "wall_s": wall, "device": [d[:3] for d in device], "ops": calls}


def _link_ops(host, launches: Dict[int, tuple], device: List[tuple], ops: tuple) -> List[dict]:
    """Each call of an operator of ``ops`` with the device seconds of the
    operations launched inside it on its thread."""
    calls = []
    by_thread: Dict[int, List[tuple]] = {}
    for e in host:
        if e.name() not in ops:
            continue
        try:
            concrete = list(e.concrete_inputs())
        except (AttributeError, RuntimeError):
            concrete = []
        calls.append({"name": e.name(), "shapes": [list(s) for s in e.shapes()], "dtypes": list(e.dtypes()),
                      "concrete": [c if isinstance(c, (int, float, bool, list, type(None))) else str(c)
                                   for c in concrete], "device_s": 0.0})
        by_thread.setdefault(e.start_thread_id(), []).append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                                              len(calls) - 1))
    for spans in by_thread.values():
        spans.sort()
    starts = {t: [s[0] for s in spans] for t, spans in by_thread.items()}
    for name, start, dur, corr in device:
        thread, at = launches.get(corr, (None, None))
        spans = by_thread.get(thread)
        if not spans:
            continue
        j = bisect.bisect_right(starts[thread], at) - 1
        while j >= 0 and spans[j][1] < at:
            j -= 1  # an enclosing call starts earlier and ends after
        if j >= 0 and spans[j][0] <= at <= spans[j][1]:
            calls[spans[j][2]]["device_s"] += dur / 1e9
    return calls


def busy_and_gaps(device: List[tuple]):
    """The union of the device's intervals in seconds, and the idle gaps
    between them as (start ns, end ns)."""
    spans = sorted((s, s + d) for _, s, d in device)
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e9, gaps


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps, each named by the operation the device waited for."""
    by_name: Dict[str, float] = {}
    for name, _, dur in record["device"]:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    _, gaps = busy_and_gaps(record["device"])
    after = sorted((s, name) for name, s, _ in record["device"])
    starts = [a[0] for a in after]
    named = []
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        j = bisect.bisect_left(starts, ge)
        named.append([f"before {after[j][1]}" if j < len(after) else "end", (ge - gs) / 1e9])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
