"""Host -> card batch transfer with prefetch: the counterpart of
``advise_tpu/data/prefetch.py`` (``device_put_batch``, ``prefetch_to_device``).

On a CUDA device each batch is copied from pinned host memory with
``non_blocking`` copies on a side stream, and an event is recorded after
its copies; :func:`prefetch_to_device` keeps ``size`` batches in flight
that way, and before it hands a batch over it makes the caller's current
stream wait on that batch's event and marks the batch's tensors as used
by that stream (so the caching allocator does not reuse their memory
while the step still reads them). On the CPU (the tests) the arrays are
wrapped as tensors.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from advise_tpu_torch.utils.host_times import HOST_TIMES

HostBatch = Tuple[np.ndarray, Dict[str, np.ndarray]]
DeviceBatch = Tuple[torch.Tensor, Dict[str, torch.Tensor]]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def device_put_batch(clips: np.ndarray, infos: Dict[str, np.ndarray], device,
                     stream: Optional["torch.cuda.Stream"] = None):
    """One batch onto ``device``. On a CUDA device the copies go from pinned
    memory onto ``stream`` (the current stream when None) without blocking
    the host, and the result is ``(clips, infos, event)`` with ``event``
    recorded after the copies; elsewhere ``(clips, infos, None)``."""
    device = torch.device(device)
    host = [_tensor(clips)] + [_tensor(v) for v in infos.values()]
    if device.type != "cuda":
        moved = [t.to(device) for t in host]
        return moved[0], dict(zip(infos, moved[1:])), None
    stream = stream if stream is not None else torch.cuda.current_stream(device)
    with torch.cuda.stream(stream), HOST_TIMES("pin_copy"):
        moved = [t.pin_memory().to(device, non_blocking=True) for t in host]
        event = torch.cuda.Event()
        event.record(stream)
    return moved[0], dict(zip(infos, moved[1:])), event


def _hand_over(batch) -> DeviceBatch:
    """Make the current stream wait for the batch's copies, and record the
    batch's tensors as used by it."""
    clips, infos, event = batch
    if event is not None:
        current = torch.cuda.current_stream(clips.device)
        current.wait_event(event)
        for t in [clips, *infos.values()]:
            t.record_stream(current)
    return clips, infos


def prefetch_to_device(iterator: Iterator[HostBatch], device, size: int = 2) -> Iterator[DeviceBatch]:
    """Yield device-resident batches, keeping ``size`` transfers in flight
    on a side stream (CUDA) so the next batches' copies overlap the step."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    queue = collections.deque()
    for clips, infos in iterator:
        queue.append(device_put_batch(clips, infos, device, stream))
        if len(queue) >= size:
            yield _hand_over(queue.popleft())
    while queue:
        yield _hand_over(queue.popleft())
