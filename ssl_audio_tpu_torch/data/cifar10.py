"""CIFAR-10 from the standard on-disk python-pickle batches (port of
ssl_audio_tpu/data/cifar10.py; the reference reads it with
torchvision.datasets.CIFAR10).

    data/cifar-10-batches-py/data_batch_1 .. data_batch_5, test_batch

(the extracted cifar-10-python.tar.gz).  Nothing is downloaded: a missing
tree raises FileNotFoundError with the instructions.  Images stay uint8
HWC on the host; the views cast them on the device (augment/cifar.py).
"""
from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np


def load_cifar10(data_dir: str = "data", train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """-> (images uint8 (N, 32, 32, 3), labels int64 (N,)): data_batch_1..5,
    or test_batch."""
    base = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        raise FileNotFoundError(
            f"{base} not found: place the extracted CIFAR-10 python batches "
            "(cifar-10-python.tar.gz) under data/."
        )
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for fname in files:
        with open(os.path.join(base, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x.astype(np.uint8), np.asarray(ys, np.int64)


class Cifar10:
    """The dataset view of load_cifar10: item -> (HWC uint8 image, int32
    label)."""

    def __init__(self, data_dir: str = "data", train: bool = True):
        self.images, self.labels = load_cifar10(data_dir, train)
        self.label_num = 10

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], np.int32(self.labels[idx])
