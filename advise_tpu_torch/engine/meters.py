"""Timers, meters, and the training helper state machine: the port's copy
of ``advise_tpu/engine/meters.py`` (pure Python).

Reference: ``utils/misc.py:25-59, 373-620``. Same dt/it/ep meters and log
line (`Epoch [e][it/iters] dt it loss acc grad_norm lr ETA`); the dt meter
(the wait for the next batch) over the it meter (one iteration) is the
input pipeline's share of the time. ``tb_logger`` is a tensorboardX
SummaryWriter or None (tensorboardX is optional, ``tools/run.py``).
"""

from __future__ import annotations

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
    recorded, read from its raw kineto events: building the profiler's
    FunctionEvent list instead costs ~70 us of host time an event, over a
    minute for one MViT-L step."""
    from torch.autograd import DeviceType

    raw = [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    base = min((start for _, start, _ in raw), default=0)  # integer ns: exact before the subtraction
    return [(name, (start - base) / 1e3, (start - base + dur) / 1e3) for name, start, dur in raw]


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
