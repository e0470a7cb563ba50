"""Host-side data loader: threaded decode workers and deterministic seeding.
The port's copy of ``advise_tpu/data/loader.py`` (numpy; the port imports
nothing of the JAX package):

- a thread pool of decode workers (numpy releases the GIL in the frame
  synthesis and the resize);
- a bounded lookahead, so decode overlaps the card's step without
  unbounded memory;
- every item's randomness from ``SeedSequence([seed, epoch, item_index])``,
  reproducible per item whatever the worker schedule, and the same items
  and draws as the JAX loader's;
- hosts take strided slices of the permutation (``rank``/``world``).

Batches are uint8 ``[B, K, T, H, W, C]`` plus an ``infos`` dict of stacked
arrays; augmentation happens on the card. The eval phases take items one
by one, in order, through :func:`threaded_items`.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from advise_tpu_torch.utils.host_times import HOST_TIMES

Batch = Tuple[np.ndarray, Dict[str, np.ndarray]]


def threaded_items(dataset, n_items: int, seed_stream: Callable[[int], List[int]],
                   num_workers: int = 8, lookahead: int = 32, rank: int = 0,
                   world: int = 1) -> Iterator[Tuple[int, Batch]]:
    """Ordered threaded fetch of ``dataset.get(idx, rng)`` for idx in
    range(rank, n_items, world) (every item with the defaults), the eval
    phases' decode pool: ``rng`` is ``default_rng(SeedSequence(
    seed_stream(idx)))``, so each item draws what a serial loop would,
    whatever the worker schedule; at most ``lookahead`` items in flight."""
    order = list(range(rank, n_items, world))

    def fetch(idx: int):
        rng = np.random.default_rng(np.random.SeedSequence(seed_stream(idx)))
        with HOST_TIMES("item"):
            return dataset.get(idx, rng)

    with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
        inflight = {}
        horizon = min(len(order), max(lookahead, 1))
        for i in range(horizon):
            inflight[i] = pool.submit(fetch, order[i])
        next_submit = horizon
        for i in range(len(order)):
            out = inflight.pop(i).result()
            if next_submit < len(order):
                inflight[next_submit] = pool.submit(fetch, order[next_submit])
                next_submit += 1
            yield order[i], out


def _collate(samples) -> Batch:
    clips = np.stack([s[0] for s in samples])
    keys = samples[0][1].keys()
    infos = {k: np.stack([np.asarray(s[1][k]) for s in samples]) for k in keys}
    return clips, infos


class ClipLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 8, drop_last: bool = True, rank: int = 0,
                 world: int = 1, lookahead: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.rank = rank
        self.world = world
        self.lookahead = max(lookahead, 1)

    def epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        # pad so every host sees the same number of items, then take this
        # host's stride (torch DistributedSampler semantics)
        if self.world > 1:
            pad = (-len(order)) % self.world
            if pad:
                order = np.concatenate([order, order[:pad]])
            order = order[self.rank :: self.world]
        return order

    def steps_per_epoch(self, epoch: int = 0) -> int:
        n = len(self.epoch_indices(epoch))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _fetch(self, epoch: int, idx: int):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, idx]))
        with HOST_TIMES("item"):
            return self.dataset.get(idx, rng)

    def take_one(self, epoch: int) -> Optional[Batch]:
        """One collated batch, fetched synchronously with no worker pool."""
        order = self.epoch_indices(epoch)
        if len(order) == 0:
            return None
        return _collate([self._fetch(epoch, int(order[i]))
                         for i in range(min(self.batch_size, len(order)))])

    def epoch(self, epoch: int) -> Iterator[Batch]:
        order = self.epoch_indices(epoch)
        if self.drop_last:
            order = order[: (len(order) // self.batch_size) * self.batch_size]
        if len(order) == 0:
            return
        # a consumer that stops early (the kNN probe takes a few batches)
        # closes the generator: the decodes not yet started are cancelled
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            inflight = {}
            horizon = min(len(order), self.lookahead * self.batch_size + self.batch_size)
            for i in range(horizon):
                inflight[i] = pool.submit(self._fetch, epoch, int(order[i]))
            next_submit = horizon
            batch = []
            for i in range(len(order)):
                with HOST_TIMES("wait_items"):
                    batch.append(inflight.pop(i).result())
                if next_submit < len(order):
                    inflight[next_submit] = pool.submit(self._fetch, epoch, int(order[next_submit]))
                    next_submit += 1
                if len(batch) == self.batch_size:
                    with HOST_TIMES("collate"):
                        collated = _collate(batch)
                    yield collated
                    batch = []
            if batch and not self.drop_last:
                yield _collate(batch)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
