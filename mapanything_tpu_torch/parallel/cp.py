"""Run-time context-parallel state (leaf module).

Counterpart of ``mapanything_tpu/parallel/cp.py`` (``CPContext`` :20,
``current_cp`` :32, ``context_parallel_attention`` :37). The JAX package
reads it while tracing; the port reads it on every forward: while the
context is active, ``MapAnything`` treats its views as this rank's block of
the group's views and routes the trunk's global layers through
``parallel/sharded_attention.py``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

from mapanything_tpu_torch.parallel.mesh import ViewGroup

SCHEDULES = ("allgather", "ring")


@dataclass(frozen=True)
class CPContext:
    """Active context-parallel configuration for trunk global attention."""

    group: ViewGroup
    schedule: str = "allgather"  # or "ring" (the O(T/n)-memory path)


_CP_STATE: Optional[CPContext] = None


def current_cp() -> Optional[CPContext]:
    return _CP_STATE


@contextlib.contextmanager
def context_parallel_attention(group: ViewGroup, schedule: str = "allgather"):
    """Shard the views of the forwards run inside over ``group``, with the
    given schedule for the trunk's global-attention layers."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of {SCHEDULES}")
    global _CP_STATE
    prev = _CP_STATE
    _CP_STATE = CPContext(group=group, schedule=schedule)
    try:
        yield _CP_STATE
    finally:
        _CP_STATE = prev
