"""Timers, meters, and the training helper state machine: the port's copy
of ``advise_tpu/engine/meters.py`` (pure Python).

Reference: ``utils/misc.py:25-59, 373-620``. Same dt/it/ep meters and log
line (`Epoch [e][it/iters] dt it loss acc grad_norm lr ETA`); the dt meter
(the wait for the next batch) over the it meter (one iteration) is the
input pipeline's share of the time. ``tb_logger`` is a tensorboardX
SummaryWriter or None (tensorboardX is optional, ``tools/run.py``).
"""

from __future__ import annotations

import bisect
import logging
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger(__name__)


class AverageMeter:
    """(reference utils/misc.py:545-620)."""

    def __init__(self, window: int = 20):
        self.reset()
        self.window = window
        self.history = deque(maxlen=window)

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.history = deque(maxlen=getattr(self, "window", 20))

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.history.append(float(val))

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    @property
    def local_avg(self) -> float:
        return sum(self.history) / max(len(self.history), 1)


class Timer:
    """Named tic/toc meters (reference utils/misc.py:25-49)."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}
        self._tic: Dict[str, float] = {}

    def tic(self, name: str):
        self._tic[name] = time.time()

    def toc(self, name: str) -> float:
        dt = time.time() - self._tic.get(name, time.time())
        self.meters.setdefault(name, AverageMeter()).update(dt)
        return dt


class TrainingHelper:
    """Per-epoch/iter bookkeeping + logging (reference utils/misc.py
    training_helper :373-542)."""

    def __init__(self, cfg, tb_logger=None):
        self.cfg = cfg
        self.timer = Timer()
        self.meters: Dict[str, AverageMeter] = {}
        self.tb = tb_logger
        self.rt = {
            "curr_ep": 0,
            "it": 0,
            "epoch_iters": 0,
            "curr_lr": 0.0,
            "global_it": 0,
            "best_criteria": float("inf"),
        }

    def epoch_start(self, epoch: int, epoch_iters: int):
        self.rt["curr_ep"] = epoch
        self.rt["epoch_iters"] = epoch_iters
        for m in self.meters.values():
            m.reset()
        self.timer.tic("ep_time")
        self.timer.tic("dt_time")

    def iter_start(self):
        self.timer.toc("dt_time")

    def update_stats(self, stats: Dict[str, float]):
        for k, v in stats.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v))

    def iter_end(self, it: int):
        self.rt["it"] = it
        self.rt["global_it"] += 1
        it_time = self.timer.toc("it_time") if "it_time" in self.timer._tic else 0.0
        self.timer.tic("it_time")
        self.timer.tic("dt_time")
        if it % max(self.cfg.TRAIN.LOG_FREQ, 1) == 0:
            self._log_iter(it)

    def _log_iter(self, it: int):
        dt = self.timer.meters.get("dt_time")
        itm = self.timer.meters.get("it_time")
        eta = ""
        if itm and itm.count:
            remain = (
                self.rt["epoch_iters"] - it - 1
                + (self.cfg.SOLVER.MAX_EPOCH - self.rt["curr_ep"] - 1)
                * self.rt["epoch_iters"]
            )
            secs = int(remain * itm.local_avg)
            eta = f"ETA: {secs // 3600}h{(secs % 3600) // 60:02d}m"
        stats = " ".join(
            f"{k}: {m.val:.4f} ({m.local_avg:.4f})" for k, m in self.meters.items()
        )
        logger.info(
            "Epoch [%d][%d/%d] dt: %.3f it: %.3f %s lr: %.2e %s",
            self.rt["curr_ep"],
            it,
            self.rt["epoch_iters"],
            dt.local_avg if dt else 0.0,
            itm.local_avg if itm else 0.0,
            stats,
            self.rt["curr_lr"],
            eta,
        )
        if self.tb is not None:
            for k, m in self.meters.items():
                self.tb.add_scalar(f"pt_it/{k}", m.val, self.rt["global_it"])
            self.tb.add_scalar("pt_it/lr", self.rt["curr_lr"], self.rt["global_it"])

    def epoch_end(self) -> Dict[str, float]:
        ep_time = self.timer.toc("ep_time")
        summary = {k: m.avg for k, m in self.meters.items()}
        summary["ep_time"] = ep_time
        dt = self.timer.meters.get("dt_time")
        itm = self.timer.meters.get("it_time")
        if dt and itm and itm.avg > 0:
            summary["input_pipeline_share"] = dt.avg / (itm.avg + 1e-9)
        logger.info(
            "Epoch %d done in %.1fs: %s",
            self.rt["curr_ep"],
            ep_time,
            {k: round(v, 4) for k, v in summary.items()},
        )
        if self.tb is not None:
            for k, v in summary.items():
                self.tb.add_scalar(f"pt_ep/{k}", v, self.rt["curr_ep"])
        return summary


def device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start, end) in microseconds from the first of them of every
    device event (kernel, copy, set) a stopped ``torch.profiler`` window
    recorded, read from its raw kineto events (annotation ranges left out):
    building the profiler's FunctionEvent list instead costs ~70 us of host
    time an event, over a minute for one MViT-L step."""
    raw = [(name, start, dur) for name, start, dur, _ in device_ops(prof)]
    base = min((start for _, start, _ in raw), default=0)  # integer ns: exact before the subtraction
    return [(name, (start - base) / 1e3, (start - base + dur) / 1e3) for name, start, dur in raw]


def device_ops(prof) -> List[Tuple[str, int, int, int]]:
    """(name, start ns, duration ns, correlation id) of every operation the
    card ran in a stopped ``torch.profiler`` window; not the ranges kineto
    draws on the card's timeline over what a ``record_function`` launched."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.duration_ns(), e.correlation_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]


def launch_times(prof) -> Dict[int, int]:
    """{correlation id: host ns} of each CUDA runtime or driver call of a
    stopped ``torch.profiler`` window: when the host launched the device
    operations of that correlation id."""
    from torch.autograd import DeviceType

    return {e.correlation_id(): e.start_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU and e.name().startswith(("cuda", "cu"))
            and not e.name().startswith("cudnn")}


def span_split(spans, ops: List[Tuple[str, int, int, int]], launched: Dict[int, int]) -> Dict[str, Dict[str, float]]:
    """Each device operation of ``ops`` (:func:`device_ops`) charged to the
    innermost span (``utils/host_times.py Span``) open when the host
    launched it (``launched``, :func:`launch_times`), by time against the
    spans of the threads that called the steps (those of the ``step``
    spans): the backward's launches come from autograd's device thread while
    the step's thread waits inside ``step.backward``. Per span name: ``busy_ms``,
    the busy time of the device that its operations add to the union of
    those before them (over all names it sums to the union); ``waited_ms``,
    the idle gaps that end at one of its operations; ``launches``, its
    operations. An operation launched outside every span, or whose launch
    is not in the window, is charged to ``"outside"``. The root's own time
    is under ``"step"``."""
    threads = {s.thread for s in spans if s.name == "step"}
    mine = sorted((i for i, s in enumerate(spans) if s.thread in threads), key=lambda i: spans[i].start_ns)
    starts = [spans[i].start_ns for i in mine]
    out: Dict[str, Dict[str, float]] = {}
    cur_end = None
    for _, start, dur, corr in sorted(ops, key=lambda op: op[1]):
        at = launched.get(corr)
        i = None
        if at is not None:
            j = bisect.bisect_right(starts, at) - 1
            i = mine[j] if j >= 0 else None
            # a span that holds the launch holds the last one to start before it (still open: no end)
            while i is not None and spans[i].end_ns is not None and spans[i].end_ns < at:
                i = spans[i].parent
        row = out.setdefault("outside" if i is None else spans[i].name,
                             {"busy_ms": 0.0, "waited_ms": 0.0, "launches": 0})
        row["launches"] += 1
        end = start + dur
        if cur_end is None:
            row["busy_ms"] += dur / 1e6
            cur_end = end
            continue
        if start > cur_end:
            row["waited_ms"] += (start - cur_end) / 1e6
        if end > cur_end:
            row["busy_ms"] += (end - max(start, cur_end)) / 1e6
            cur_end = end
    return out


def busy_ms(spans: Iterable) -> float:
    """Length of the union of ``(start, end)`` intervals given in
    microseconds, in ms: the time a device was busy with at least one
    kernel."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3
