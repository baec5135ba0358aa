"""Prefetching batch loader (port of ssl_audio_tpu/data/pipeline.py):
per-epoch seeded shuffle, drop_last, a producer thread and a bounded
prefetch queue, so host work overlaps device compute.

A batch is made on one of three paths, chosen from the dataset and logged
once per loader:
- the C++ batch readers (data/native_loader.py), for a dataset with
  `supports_native` (`.npy` log-mels with no transform, or AudioSetWav): one
  call per batch, seeded seed * 1_000_003 + epoch * 131 + b as in JAX.  An
  IOError there (a corrupt file) makes that batch again on the Python path,
  where the dataset's own fallback applies;
- `dataset.load_batch` on a thread pool, for a dataset with `mel_per_batch`
  (--load_wav): one log-mel launch per batch;
- `dataset[i]` for every item on a thread pool otherwise.
A failed build of the C++ readers raises; nothing falls back to Python.

Given a CUDA `device`, batches are pinned host tensors from a ring of
prefetch + 2 slots, and the C++ readers write straight into them: the
consumer copies each to the card with non_blocking=True before it asks for
the next batch (the Trainer at --steps_per_dispatch N > 1: into its slot of
the CUDA graph's batch buffer).  When it asks, the loader records an event on the current
stream of the device after that copy, and the producer waits on a slot's
event before it writes that slot again.  Otherwise batches are numpy arrays
and nothing is pinned.  Labels are numpy arrays on every path.

Process sharding, as in JAX: `batch_size` is the rows this process
yields, and with process_count W > 1 global batch b is rows
idx[b * W * batch_size : (b + 1) * W * batch_size] of the epoch's shuffle,
of which process p reads the contiguous rows [p * batch_size, (p + 1) *
batch_size): concatenated in process order, the shards are the
single-process loader's batch of W * batch_size.  drop_last is required
there (a ragged last batch would split unevenly).  The C++ readers read
each process's rows with the batch's seed, so a row's crop draw follows
its position within the shard, as in the JAX loader.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch


class _PinnedRing:
    """`n` pinned host buffers, each with a CUDA event recorded once the
    copy out of it is queued."""

    def __init__(self, n: int, device: torch.device):
        self.device = device
        self.bufs: list[Optional[torch.Tensor]] = [None] * n
        self.events = [torch.cuda.Event() for _ in range(n)]

    def acquire(self, b: int, shape: tuple, dtype=torch.float32) -> torch.Tensor:
        """Batch b's slot, viewed as `shape` (the first shape[0] rows of a
        slot of `dtype` sized for a full batch), once the copy out of it is
        done."""
        i = b % len(self.bufs)
        self.events[i].synchronize()
        buf = self.bufs[i]
        if (buf is None or buf.shape[1:] != shape[1:] or buf.shape[0] < shape[0]
                or buf.dtype != dtype):
            buf = self.bufs[i] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return buf[: shape[0]]

    def release(self, b: int) -> None:
        self.events[b % len(self.bufs)].record(torch.cuda.current_stream(self.device))


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8, seed: int = 0,
                 prefetch: int = 2, device=None, log: Callable[[str], None] = print,
                 process_index: int = 0, process_count: int = 1):
        if process_count > 1 and not drop_last:
            raise ValueError("multi-process loading requires drop_last=True")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside 0..{process_count - 1}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.device = None if device is None else torch.device(device)
        self.log = log
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self._said = False

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    @property
    def global_batch(self) -> int:
        """Rows of one batch over every process."""
        return self.batch_size * self.process_count

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch
        return (n + self.global_batch - 1) // self.global_batch

    @property
    def pinned(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    @staticmethod
    def _collate(items) -> Tuple[np.ndarray, np.ndarray]:
        return (np.stack([it[0] for it in items]),
                np.stack([np.asarray(it[1]) for it in items]))

    def _native_reader(self):
        """The C++ reader for the dataset, or None where it has none (no
        `supports_native`).  Builds the reader's library: a failed build
        raises."""
        if not getattr(self.dataset, "supports_native", False):
            return None
        cfg = self.dataset.cfg
        if getattr(self.dataset, "returns_wav", False):
            from ssl_audio_tpu_torch.data.native_loader import NativeWavReader

            return NativeWavReader(self.dataset.unit_length, cfg.sample_rate,
                                   n_threads=self.num_workers)
        from ssl_audio_tpu_torch.data.native_loader import NativeBatchReader

        norm = self.dataset.norm_stats or (0.0, 1.0)
        return NativeBatchReader(cfg.n_mels, self.dataset.crop_frames, norm[0], norm[1],
                                 n_threads=self.num_workers)

    def _say_path(self, native) -> None:
        if self._said:
            return
        self._said = True
        name = type(self.dataset).__name__
        if native is not None:
            how = f"C++ {type(native).__name__} on {self.num_workers} threads"
        elif getattr(self.dataset, "mel_per_batch", False):
            how = f"load_batch on {self.num_workers} threads, one log-mel per batch"
        else:
            how = f"items on {self.num_workers} Python threads"
        where = f"pinned for {self.device}" if self.pinned else "host arrays"
        self.log(f"DataLoader({name}): {how}; {where}")

    def __iter__(self) -> Iterator[Tuple[object, np.ndarray]]:
        idx = self._indices()
        n_batches = len(self)
        native = self._native_reader()
        self._say_path(native)
        by_batch = native is None and getattr(self.dataset, "mel_per_batch", False)
        ring = _PinnedRing(self.prefetch + 2, self.device) if self.pinned else None
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

        def python_batch(pool, rows) -> Tuple[np.ndarray, np.ndarray]:
            if by_batch:
                return self.dataset.load_batch(rows, pool)
            return self._collate(list(pool.map(self.dataset.__getitem__, rows)))

        def make_batch(pool, b):
            first = b * self.global_batch + self.process_index * self.batch_size
            rows = idx[first:first + self.batch_size]
            if native is not None:
                paths, labels = self.dataset.batch_paths(rows)
                out = None
                if ring is not None:
                    shape = ((len(rows), self.dataset.unit_length)
                             if getattr(self.dataset, "returns_wav", False)
                             else (len(rows), 1, native.n_mels, native.crop_frames))
                    out = ring.acquire(b, shape)
                try:
                    xs = native.read(paths, seed=self.seed * 1_000_003 + self.epoch * 131 + b,
                                     out=None if out is None else out.numpy())
                    return (xs if out is None else out), np.stack(labels)
                except IOError:
                    pass        # a file the C++ reader cannot read: the dataset's own policy
            xs, ys = python_batch(pool, rows)
            if ring is None:
                return xs, ys
            # in the items' own type (CIFAR-10's uint8 images are cast on the card)
            out = ring.acquire(b, xs.shape, torch.from_numpy(xs[:0]).dtype)
            out.numpy()[...] = xs
            return out, ys

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        if not put((b, make_batch(pool, b))):
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
                b, batch = item
                try:
                    yield batch
                finally:
                    if ring is not None:
                        ring.release(b)
        finally:
            stop.set()
            thread.join(timeout=10)
