"""Process-group set-up and a launcher of rank processes.

Counterpart of ``mapanything_tpu/parallel/distributed.py``
(``init_distributed_mode`` :18, ``barrier`` :61). On the TPU one JAX program
spans every chip; here each rank is one process, and ``torch.distributed``
joins them. The backend follows the device: NCCL for CUDA tensors, gloo for
CPU tensors. Nothing switches backend or device when NCCL or the card is
missing: the set-up raises.
"""

from __future__ import annotations

import datetime
import os
import pickle
from pathlib import Path
from typing import Any, Callable, List, Optional, Union

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=5)


def backend_for(device: Union[str, torch.device]) -> str:
    """The process-group backend for tensors on ``device``: NCCL for cuda, gloo for cpu."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"view parallelism runs on cuda or cpu, not {device}")


def init_distributed_mode(
    device: Union[str, torch.device, None] = None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> dict:
    """Join the process group that the caller or the environment describes.

    ``rank`` and ``world_size`` default to ``RANK`` and ``WORLD_SIZE``; the
    rendezvous is ``init_method`` or, without it, ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``). ``device`` is CUDA unless the caller
    names the CPU; a CUDA rank takes card ``LOCAL_RANK`` (default: its rank).
    With neither an ``init_method`` nor a ``WORLD_SIZE`` in the environment
    the run is single-process and no group is made, as the JAX version
    reports it ("Not using distributed mode"). Returns {"world_size",
    "rank", "local_devices", "distributed"}.
    """
    device = torch.device("cuda" if device is None else device)
    backend = backend_for(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to join a gloo group on the CPU")
    local_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    if not dist.is_initialized():
        if init_method is None and "WORLD_SIZE" not in os.environ and world_size is None:
            print("Not using distributed mode")
            return {"world_size": 1, "rank": 0, "local_devices": local_devices, "distributed": False}
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size, timeout=TIMEOUT)
    elif backend not in dist.get_backend():
        raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend} for {device.type}")
    size = dist.get_world_size()
    return {"world_size": size, "rank": dist.get_rank(), "local_devices": local_devices,
            "distributed": size > 1}


def barrier() -> None:
    """Cross-process sync point (the reference's ``torch.distributed.barrier``)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _rank_main(rank: int, fn: Callable, world_size: int, device: str, init_file: str, args: tuple) -> None:
    if device == "cpu":
        # One thread a rank: the ranks of one launch, and the test workers that
        # launch them side by side, share the host's cores.
        torch.set_num_threads(1)
    init_distributed_mode(device, f"file://{init_file}", rank, world_size)
    try:
        result = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    with open(f"{init_file}.rank{rank}", "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, world_size: int, device: str, init_file: Union[str, Path], *args) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes.

    The processes start with ``spawn`` and join one process group through the
    rendezvous file ``init_file`` (a path that does not exist yet): gloo for
    ``device="cpu"``, NCCL with one card a rank for ``device="cuda"``. ``fn``
    must be importable by its module path (``spawn`` unpickles it by
    importing its module), and its module should import no more than the
    ranks need. Returns each rank's return value, by rank; a rank that raises
    ends the others and the call raises.
    """
    backend_for(device)
    init_file = str(init_file)
    if os.path.exists(init_file):
        raise FileExistsError(f"the rendezvous file {init_file} exists already")
    torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world_size, str(device), init_file, args), nprocs=world_size,
        start_method="spawn", join=True,
    )
    results = []
    for rank in range(world_size):
        with open(f"{init_file}.rank{rank}", "rb") as f:
            results.append(pickle.load(f))  # written by the ranks above
    return results
