"""One intra-op thread for torch while many CPU-bound processes share a host.

With torch's default pool (a thread a core) in each of several busy
processes, every small op waits on the others' threads; one thread a
process is faster then. The port's CPU tests make this an autouse fixture:

    one_intra_op_thread = pytest.fixture(scope="module", autouse=True)(threads.one_intra_op_thread)
"""

from __future__ import annotations

import contextlib
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
