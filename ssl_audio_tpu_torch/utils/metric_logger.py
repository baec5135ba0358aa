"""SmoothedValue / MetricLogger (port of ssl_audio_tpu/utils/metric_logger.py;
reference old/utils/utils.py:89-260): windowed medians and averages, summed
over the ranks of a process group, and timestamped iteration lines with an
ETA.  The strings are the JAX package's."""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable, Optional

import numpy as np
import torch

from ssl_audio_tpu_torch import parallel


class SmoothedValue:
    """Track a series of values with window-smoothed statistics."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """(count, total) summed over the ranks of the process group (the
        reference's dist.all_reduce); nothing outside one."""
        if not parallel.is_distributed():
            return
        device = (torch.device("cuda", parallel.local_rank())
                  if torch.distributed.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.tensor([self.count, self.total], dtype=torch.float64, device=device)
        parallel.all_reduce_(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def log_every(self, iterable: Iterable, print_freq: int, header: Optional[str] = ""):
        i, start, end = 0, time.time(), time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        space = len(str(total)) if total else 6
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                print(f"{header} [{i:{space}d}/{total or '?'}]  {eta}{self}  "
                      f"time: {iter_time}  data: {data_time}")
            i += 1
            end = time.time()
        total_time = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(total_time))} "
              f"({total_time / max(i, 1):.4f} s / it)")
