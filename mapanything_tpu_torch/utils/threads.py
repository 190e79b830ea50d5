"""One intra-op thread for torch while many CPU-bound processes share a host,
and the freed heap handed back to the OS between the modules of a long-lived
test process.

With torch's default pool (a thread a core) in each of several busy
processes, every small op waits on the others' threads; one thread a
process is faster then. A test worker that runs many modules also keeps the
peak heap of each (the C allocator holds freed pages), unless it is trimmed.
The port's CPU tests make both an autouse fixture:

    lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import os
from typing import Iterator

import torch


def one_intra_op_thread() -> Iterator[None]:
    """Generator: torch on one intra-op thread, and ``OMP_NUM_THREADS=1`` for
    the processes spawned meanwhile (torch reads it in each), until it is
    resumed; then both are restored."""
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp


single_thread = contextlib.contextmanager(one_intra_op_thread)
"""The same as a context manager: ``with single_thread(): ...``."""


def trim_heap() -> None:
    """Collect garbage, then hand the C heap's free pages back to the OS (glibc's
    ``malloc_trim``; nothing where the C library has none). The small train-step
    tests leave a process at 4.5 GB resident without it, 0.9 GB with it."""
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def lean_module() -> Iterator[None]:
    """Generator for a test module's fixture: one intra-op thread while the module
    runs (``one_intra_op_thread``), and ``trim_heap`` after it."""
    yield from one_intra_op_thread()
    trim_heap()


# glibc's mallopt parameters, its largest mmap threshold, and its default thresholds.
_M_TRIM_THRESHOLD, _M_MMAP_THRESHOLD = -1, -3
_MAX_MMAP_THRESHOLD, _DEFAULT_THRESHOLD = 32 * 1024 * 1024, 128 * 1024


@contextlib.contextmanager
def large_heap() -> Iterator[None]:
    """While the context runs, glibc serves blocks up to 32 MiB from the heap and
    keeps up to 1 GiB of it free: a CPU train step that allocates and frees the
    same large tensors every step (the float64 copies of the products' weights,
    the optimizer's temporaries) then stops paying a page fault for each of their
    pages (a small multimodal step on 4 threads: 1.65 s, 1.05 s with it).
    Afterwards the thresholds go back to glibc's defaults and the heap is
    trimmed. Nothing where the C library has no ``mallopt``."""
    try:
        mallopt = ctypes.CDLL("libc.so.6").mallopt
    except (OSError, AttributeError):
        yield
        return
    mallopt(_M_MMAP_THRESHOLD, _MAX_MMAP_THRESHOLD)
    mallopt(_M_TRIM_THRESHOLD, 1 << 30)
    try:
        yield
    finally:
        mallopt(_M_MMAP_THRESHOLD, _DEFAULT_THRESHOLD)
        mallopt(_M_TRIM_THRESHOLD, _DEFAULT_THRESHOLD)
        trim_heap()
