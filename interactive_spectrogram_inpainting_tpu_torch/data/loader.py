"""Host-side batching loaders feeding device-resident transforms.

Replaces ``GANsynth_pytorch.loader.WavToSpectrogramDataLoader`` /
``MaskedPhaseWavToSpectrogramDataLoader`` (reference ``train_vqvae.py:
585-611``): wav decode on CPU workers, batched; the wav -> spectrogram
transform runs ON DEVICE per batch (exactly the
reference's split of labor, which keeps the STFT on the accelerator).

Deterministic epoch shuffling via a seeded permutation (the reference's
``DistributedSampler.set_epoch`` pattern); sharding across processes by
``rows``: one data rank's block of every global batch, as a ``('data',)``
mesh splits it. The port's own copy of the JAX package's module.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Iterator, Optional

import numpy as np


class BatchLoader:
    """Iterate (audio [B, n], *labels) batches from an indexable dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, rows: Optional[slice] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rows = rows
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            return rng.permutation(n)
        return np.arange(n)

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def _make_batch(self, batch_idx: np.ndarray):
        if self.rows is not None:
            batch_idx = batch_idx[self.rows]
        items = [self.dataset[int(i)] for i in batch_idx]
        if isinstance(items[0], tuple):
            cols = list(zip(*items))
            return tuple(np.stack(col) if isinstance(col[0], np.ndarray)
                         else np.asarray(col) for col in cols)
        return np.stack(items)

    def __iter__(self) -> Iterator:
        idx = self._indices()
        num_batches = len(self)
        if self.prefetch <= 0:
            for b in range(num_batches):
                yield self._make_batch(
                    idx[b * self.batch_size:(b + 1) * self.batch_size])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for b in range(num_batches):
                    q.put(self._make_batch(
                        idx[b * self.batch_size:(b + 1) * self.batch_size]))
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
