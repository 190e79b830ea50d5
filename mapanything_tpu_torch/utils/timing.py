"""Timers and tracing of the port: block timers, a torch.profiler trace, a CUDA-event timer.

Counterpart of ``mapanything_tpu/utils/timing.py`` (:18-95). ``BlockTimer`` and
``BlockTimeManager`` are the same context-manager/decorator timers with window
statistics (host clock). ``trace`` stands for the JAX module's ``jax.profiler``
trace: a ``torch.profiler`` context (CPU and, where there is one, CUDA activity)
that writes a Chrome trace into ``log_dir``. ``time_jitted`` stands for the JAX
function of that name (steady-state seconds a call of a jitted function, blocking
on the results): warm-up calls, then the mean seconds a call over ``iters``,
timed by CUDA events around the calls on a CUDA device and by the host clock
after a synchronise elsewhere.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Callable, Dict, Union

import torch

from mapanything_tpu_torch.models.mapanything import resolve_device


class BlockTimer:
    """Context manager / decorator measuring wall time with window stats."""

    def __init__(self, name: str = "block", window: int = 50, print_fn=None):
        self.name = name
        self.window = deque(maxlen=window)
        self.total = 0.0
        self.count = 0
        self.print_fn = print_fn

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.window.append(dt)
        self.total += dt
        self.count += 1
        if self.print_fn:
            self.print_fn(f"[{self.name}] {dt * 1e3:.2f} ms (avg {self.avg * 1e3:.2f})")
        return False

    def __call__(self, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return wrapped

    @property
    def avg(self) -> float:
        return sum(self.window) / max(len(self.window), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class BlockTimeManager:
    """Named-timer registry."""

    def __init__(self):
        self.timers: Dict[str, BlockTimer] = defaultdict(BlockTimer)

    def __call__(self, name: str) -> BlockTimer:
        if name not in self.timers:
            self.timers[name] = BlockTimer(name)
        return self.timers[name]

    def summary(self) -> Dict[str, float]:
        return {k: t.global_avg for k, t in self.timers.items()}


@contextlib.contextmanager
def trace(log_dir: Union[str, Path] = "outputs/torch_trace"):
    """A ``torch.profiler`` context; on exit it writes ``trace.json`` (a Chrome trace,
    for Perfetto or chrome://tracing) into ``log_dir`` and yields that directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def time_jitted(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                device: Union[str, torch.device, None] = None) -> float:
    """Steady-state seconds a call of ``fn(*args)``: ``warmup`` calls, then the mean
    over ``iters`` calls. On a CUDA ``device`` (the default; without CUDA it raises
    unless ``device="cpu"``) CUDA events bracket the calls, read after a
    synchronise; on the CPU the host clock does."""
    device = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters
