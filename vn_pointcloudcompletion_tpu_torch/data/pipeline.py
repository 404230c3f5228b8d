"""Input pipeline: threaded host-side batching + pinned-memory copies to the card.

Port of ``data/pipeline.py``.  :class:`BatchLoader` assembles numpy batches
on a thread pool, a few batches ahead; :func:`device_prefetch` turns them into
tensors on the device (:func:`stage_batch`), copying through pinned host
memory without blocking so that the copy of the next batch overlaps the
current batch's compute.

Under data-parallel training (``parallel/``) the ranks of one host split
each global batch as JAX's devices of one process do: every rank orders the
dataset as the one-process loader does (the same shuffle seed and global
batches of ``batch_size``) and loads only its rows of each global batch
(``BatchLoader(shard=(rank, world))``, ``batch_size // world`` rows), which
it stages onto its own card.  The global batch is the ranks' local batches
in rank order, as JAX's ``make_array_from_process_local_data`` forms it, so
``--mesh N`` trains on the batches of the one-process run, in its order; no
input row crosses ranks.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch


class BatchLoader:
    """Iterable over (partial, complete) numpy batches of a map-style dataset.

    Epoch shuffling is seeded and reproducible; ``drop_last`` drops the final
    short batch.  ``shard`` ``(rank, world)``: ``batch_size`` is the global
    batch, and the loader yields rank's ``batch_size // world`` rows of each
    (``parallel/mesh.py::data_sharding``'s rows); a short last batch would not
    split evenly, so a shard of more than one rank drops it.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 8, drop_last: bool = True,
                 shard: Tuple[int, int] = (0, 1)):
        rank, world = shard
        if batch_size % world:
            raise ValueError(f"batch_size={batch_size} does not split over {world} ranks")
        if world > 1 and not drop_last:
            raise ValueError("a loader sharded over ranks drops the short last batch")
        self.rows = slice(rank * (batch_size // world), (rank + 1) * (batch_size // world))
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 1_000_003 + self._epoch)
            rng.shuffle(order)
        nb = len(self)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = collections.deque()

            def submit(i):
                idxs = order[i * self.batch_size : (i + 1) * self.batch_size][self.rows]
                pending.append(pool.map(self.dataset.__getitem__, idxs))

            ahead = 3
            for i in range(min(ahead, nb)):
                submit(i)
            for i in range(nb):
                items = list(pending.popleft())
                if i + ahead < nb:
                    submit(i + ahead)
                yield (np.stack([it[0] for it in items]),
                       np.stack([it[1] for it in items]))


def stage_batch(batch, device: torch.device):
    """numpy arrays -> tensors on ``device`` (a rank's card: its local
    rows); CUDA copies go through pinned memory and do not block the
    host."""
    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return tuple(put(x) for x in batch)


def device_prefetch(iterator: Iterable, device: torch.device, size: int = 2):
    """Yield the batches of ``iterator`` on ``device``, ``size`` copies ahead."""
    q: collections.deque = collections.deque()
    it = iter(iterator)
    for batch in it:
        q.append(stage_batch(batch, device))
        if len(q) > size:
            yield q.popleft()
    while q:
        yield q.popleft()
