"""The host input pipeline (port of ``kmunet_tpu/data/pipeline.py``'s
``DataLoader`` on one process): worker threads read and resize items into a
bounded queue while the previous step runs, in JAX's order, and each batch
is copied to the device ``prefetch`` batches ahead of the step that takes
it.

The batches are JAX's: epoch e (counted from 1 at each ``iter``) visits
``np.random.default_rng(seed + e).permutation`` of the items when
``shuffle``, else their order, and ``drop_last`` drops the ragged tail. An
iteration abandoned mid-epoch (``--max_steps``) stops its feeder and workers
instead of leaving them blocked on the bounded queues.

Across cards (``mesh``) every rank draws the same order and reads and
yields only its block of rows of each global batch of ``batch_size``, as
JAX's ``device_put`` of the global batch places it on a one-host mesh
(``parallel.batch_sharding``); ``len`` counts global batches. (JAX's
multi-host loader, ``batch_size`` rows per process with strided indices,
is not this: the port follows the one-host run.)
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from kmunet_tpu_torch.serve import resolve_device


class DataLoader:
    """Epochs of (batch_size, ...) float32 batches of an indexable dataset of
    numpy items, as tensors on ``device`` (None: the card, which must
    exist)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, num_workers: int = 4, prefetch: int = 2, device=None,
                 mesh=None):
        axis = None if mesh is None else mesh.axis("data")
        self.rows = (0, 1) if axis is None else (axis.index, axis.size)  # (block, blocks)
        if batch_size % self.rows[1]:
            raise ValueError(f"global batch {batch_size} not divisible by data={self.rows[1]}")
        if self.rows[1] > 1 and not drop_last:
            raise ValueError("a batch split over the data axis needs drop_last")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self.epoch = 0  # epochs begun; the next ``iter`` shuffles with seed + epoch + 1

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self, epoch: int) -> np.ndarray:
        """The item order of ``epoch`` (counted from 1)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            idx = np.random.default_rng(self.seed + epoch).permutation(idx)
        return idx

    def _batches(self, idx: np.ndarray) -> Iterator[np.ndarray]:
        stop = len(idx) // self.batch_size * self.batch_size if self.drop_last else len(idx)
        if stop == 0:
            return
        block, blocks = self.rows
        size = self.batch_size // blocks
        if blocks > 1:  # this rank's rows of each global batch
            idx = idx[:stop].reshape(-1, self.batch_size)[:, block * size:(block + 1) * size]
            idx = idx.reshape(-1)
            stop = len(idx)
        work_q: queue.Queue = queue.Queue(maxsize=self.num_workers * 4)
        result_q: queue.Queue = queue.Queue(maxsize=self.num_workers * 4)
        # Set when the consumer stops (the epoch's end, or an abandoned
        # iteration): the feeder and workers then drain out.
        halt = threading.Event()

        def _put(q, item) -> bool:
            while not halt.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            while not halt.is_set():
                j = work_q.get()
                if j is None:
                    return
                if not _put(result_q, (j, self.dataset[int(idx[j])])):
                    return

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        def feeder():
            for j in range(stop):
                if not _put(work_q, j):
                    return
            for _ in threads:
                if not _put(work_q, None):
                    return

        threading.Thread(target=feeder, daemon=True).start()

        # Workers finish out of order: a stash keyed by position restores it.
        try:
            stash: dict[int, np.ndarray] = {}
            out = []
            for j in range(stop):
                while j not in stash:
                    k, item = result_q.get()
                    stash[k] = item
                out.append(stash.pop(j))
                if len(out) == size or (j == stop - 1 and not self.drop_last):
                    yield np.stack(out)
                    out = []
        finally:
            halt.set()
            for _ in threads:  # wake the workers parked on work_q.get
                try:
                    work_q.put_nowait(None)
                except queue.Full:
                    pass

    def __iter__(self) -> Iterator[torch.Tensor]:
        """The epoch's batches on the device (this rank's rows of each)."""
        self.epoch += 1
        buf = collections.deque()
        for batch in self._batches(self._indices(self.epoch)):
            buf.append(torch.from_numpy(batch).to(self.device, non_blocking=True))
            if len(buf) > self.prefetch:
                yield buf.popleft()
        while buf:
            yield buf.popleft()
