"""Metric logging: windowed smoothing, the mean over processes, JSON-lines logs.

Counterpart of ``mapanything_tpu/utils/logging.py``: ``SmoothedValue``,
``MetricLogger``, ``JsonlLogger``, ``is_main_process``, ``print_main`` and
``all_reduce_mean``. Processes are those of ``torch.distributed``: with a group
initialised, ``all_reduce_mean`` averages over it and ``print_main`` prints on
rank 0; without one, there is one process.
"""

from __future__ import annotations

import datetime
import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist


class SmoothedValue:
    """A series with its window's median and mean and its global mean."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def all_reduce_mean(x: float) -> float:
    """The mean of a scalar over the processes of the default group (the value
    itself without one)."""
    if not _distributed() or dist.get_world_size() == 1:
        return float(x)
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else None
    t = torch.tensor(float(x), dtype=torch.float32, device=device)
    dist.all_reduce(t)
    return float(t) / dist.get_world_size()


class MetricLogger:
    """Iteration logger with smoothing and ETA printing."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in ("meters", "delimiter", "print_fn"):
            raise AttributeError(attr)
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        total = len(iterable) if hasattr(iterable, "__len__") else None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    self.print_fn(f"{header} [{i}/{total}] eta: {eta_str} {self} time: {iter_time} data: {data_time}")
                else:
                    self.print_fn(f"{header} [{i}] {self} time: {iter_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start_time
        self.print_fn(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}")

    def global_avg_dict(self, prefix: str = "") -> Dict[str, float]:
        return {f"{prefix}{k}": m.global_avg for k, m in self.meters.items()}


class JsonlLogger:
    """One JSON line a call (a line an epoch) appended to ``<output_dir>/<filename>``."""

    def __init__(self, output_dir: str, filename: str = "log.txt", enabled: bool = True):
        self.enabled = enabled
        self.path = Path(output_dir) / filename
        if enabled:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, stats: dict):
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(stats) + "\n")


def is_main_process() -> bool:
    return not _distributed() or dist.get_rank() == 0


def print_main(*args, **kwargs):
    """Print on rank 0 only."""
    if is_main_process():
        print(*args, **kwargs)
