"""Threaded prefetching batch loader (port of the in-process path of
ssl_audio_tpu/data/pipeline.py): per-epoch seeded shuffle, drop_last, a
thread pool for the per-item work and a bounded prefetch queue, so host
work overlaps device compute.  The native batch readers and multi-process
sharding are not ported yet.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8, seed: int = 0,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @staticmethod
    def _collate(items) -> Tuple[np.ndarray, np.ndarray]:
        return (np.stack([it[0] for it in items]),
                np.stack([np.asarray(it[1]) for it in items]))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._indices()
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Blocks while the queue is full, gives up once the consumer left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        rows = idx[b * self.batch_size:(b + 1) * self.batch_size]
                        items = list(pool.map(self.dataset.__getitem__, rows))
                        if not put(self._collate(items)):
                            return
                put(None)
            except BaseException as e:  # surface worker errors to the consumer
                put(e)
                if not isinstance(e, Exception):
                    raise

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)
