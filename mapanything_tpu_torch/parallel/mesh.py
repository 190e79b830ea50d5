"""The view and data axes: groups of ranks, block sharding, and collectives.

Counterpart of ``mapanything_tpu/parallel/mesh.py`` (``make_mesh`` :29,
``shard_views_pytree`` :59). On the TPU a (data, view) mesh lets XLA place the
collectives; here a ``ViewGroup`` names the ranks that share a batch's views,
rank r holds views [r·V/n, (r+1)·V/n) (so rank 0 holds view 0), and the
collectives are explicit. A ``Mesh`` is the 2-D group: data × view, view
fastest, as ``make_mesh`` lays the devices out; its ``view`` group is one row
(the ranks that split one block of samples' views) and its ``data`` group one
column (the ranks that hold the same views of the other blocks of samples),
both ``ViewGroup``s. The differentiable collectives carry their adjoints: the
backward of an all-gather is a reduce-scatter, of an all-reduce an all-reduce,
of a broadcast a sum back to its source.

Each rank holds its own copy of a replicated value, and a rank's loss
reaches its own copy only. The total gradient of a replicated value is then
the sum over ranks of the copies' gradients, which is what the step's
all-reduce of the parameters' gradients forms.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, fields, replace
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# The single-tensor collectives; torch 2.13 renamed them (the old names warn).
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

COLLECTIVES = Counter()  # collectives issued, by kind (read through sharded_attention.counts())


@dataclass(frozen=True)
class ViewGroup:
    """The ranks that split one batch's views: this process's ``rank`` in it,
    its ``size``, the members' global ranks and the process group (None: the
    default group)."""

    rank: int
    size: int
    ranks: Tuple[int, ...]
    group: Optional[dist.ProcessGroup] = None

    @property
    def next_rank(self) -> int:
        return self.ranks[(self.rank + 1) % self.size]

    @property
    def prev_rank(self) -> int:
        return self.ranks[(self.rank - 1) % self.size]


@dataclass(frozen=True)
class Mesh:
    """The 2-D group of every rank of the default process group: global rank r is
    data index r // n_view and view index r % n_view. ``view``: this rank's row;
    ``data``: its column; ``world``: every rank."""

    view: ViewGroup
    data: ViewGroup
    world: ViewGroup

    @property
    def is_main(self) -> bool:
        return self.world.rank == 0


def make_mesh(view_parallelism: int = 1, data_parallelism: Optional[int] = None) -> Mesh:
    """The (data, view) mesh over every rank of the default process group, view
    fastest. ``data_parallelism`` None or -1 takes the ranks that are left; another
    value must fit the world size. Every rank makes every row and column group, in
    one order, as ``torch.distributed.new_group`` demands; a group of every rank is
    the default group itself."""
    world = make_view_group()
    n, vp = world.size, view_parallelism
    if vp < 1 or n % vp:
        raise ValueError(f"{n} ranks do not split into rows of view_parallelism={vp}")
    if data_parallelism not in (None, -1) and data_parallelism * vp != n:
        raise ValueError(f"a {data_parallelism} x {vp} (data x view) mesh needs {data_parallelism * vp} ranks, "
                         f"not {n}")
    rows = [tuple(range(d * vp, (d + 1) * vp)) for d in range(n // vp)]
    cols = [tuple(range(v, n, vp)) for v in range(vp)]
    made = {}
    for ranks in rows + cols:
        if ranks not in made:
            made[ranks] = None if len(ranks) == n else dist.new_group(list(ranks))
    d, v = divmod(world.rank, vp)
    return Mesh(view=ViewGroup(rank=v, size=vp, ranks=rows[d], group=made[rows[d]]),
                data=ViewGroup(rank=d, size=n // vp, ranks=cols[v], group=made[cols[v]]),
                world=world)


def make_view_group(group: Optional[dist.ProcessGroup] = None) -> ViewGroup:
    """The view group over ``group`` (default: every rank of the default group)."""
    if not dist.is_initialized():
        raise RuntimeError("view parallelism needs a process group: call init_distributed_mode first")
    size = dist.get_world_size(group)
    ranks = tuple(range(size)) if group is None else tuple(dist.get_process_group_ranks(group))
    return ViewGroup(rank=dist.get_rank(group), size=size, ranks=ranks, group=group)


def _issue(vg: ViewGroup, x: torch.Tensor, kind: str) -> None:
    # Counts the collective. A CUDA tensor goes through NCCL and a CPU tensor
    # through gloo, or the call raises.
    COLLECTIVES[kind] += 1
    want = {"cuda": "nccl", "cpu": "gloo"}.get(x.device.type)
    backend = str(dist.get_backend(vg.group))
    if want is None or want not in backend:
        raise RuntimeError(f"a {x.device.type} tensor cannot go through the {backend} group")


def view_slice(vg: ViewGroup, num_views: int) -> slice:
    """This rank's block of ``num_views`` views."""
    if num_views % vg.size:
        raise ValueError(f"{num_views} views do not split over {vg.size} ranks")
    per = num_views // vg.size
    return slice(vg.rank * per, (vg.rank + 1) * per)


def _view_fields(tree) -> dict:
    # The (B, V, ...) tensor fields of a dataclass; per-batch fields and None are left out.
    values = {f.name: getattr(tree, f.name) for f in fields(tree)}
    return {k: x for k, x in values.items() if isinstance(x, torch.Tensor) and x.dim() >= 2}


def shard_views_pytree(tree, vg: ViewGroup):
    """This rank's views of every (B, V, ...) tensor of a dataclass of tensors.

    Fields with fewer than two dimensions (per-batch values) and None stay as
    they are; every (B, V, ...) field must have the same V.
    """
    views = _view_fields(tree)
    vs = {x.shape[1] for x in views.values()}
    if len(vs) != 1:
        raise ValueError(f"the (B, V, ...) fields disagree on V: {sorted(vs)}")
    sl = view_slice(vg, vs.pop())
    return replace(tree, **{k: x[:, sl] for k, x in views.items()})


# ---------------------------------------------------------------- plain collectives


def all_gather(x: torch.Tensor, vg: ViewGroup, dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), vg, dim).bool()
    _issue(vg, x, "all_gather")
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((vg.size * x.shape[0],) + x.shape[1:], dtype=x.dtype, device=x.device)
    _all_gather_single(out, x, group=vg.group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, vg: ViewGroup, dim: int = 1) -> torch.Tensor:
    """The sum over ranks of ``x``, of which this rank keeps its block along ``dim``."""
    _issue(vg, x, "reduce_scatter")
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // vg.size,) + x.shape[1:], dtype=x.dtype, device=x.device)
    _reduce_scatter_single(out, x, group=vg.group)
    return out.movedim(0, dim)


def all_reduce_(x: torch.Tensor, vg: ViewGroup) -> torch.Tensor:
    """``x`` (contiguous) replaced by the sum over ranks of ``x``, in place."""
    _issue(vg, x, "all_reduce")
    if not x.is_contiguous():
        raise ValueError("all_reduce_ needs a contiguous tensor")
    dist.all_reduce(x, group=vg.group)
    return x


def all_reduce(x: torch.Tensor, vg: ViewGroup) -> torch.Tensor:
    """The sum over ranks of ``x`` (a new tensor)."""
    return all_reduce_(x.contiguous().clone(), vg)


def broadcast_first(x: torch.Tensor, vg: ViewGroup) -> torch.Tensor:
    """The first rank's ``x`` on every rank (a new tensor)."""
    _issue(vg, x, "broadcast")
    out = x.contiguous().clone()
    dist.broadcast(out, src=vg.ranks[0], group=vg.group)
    return out


def ring_shift(tensors: Sequence[torch.Tensor], vg: ViewGroup) -> list:
    """Send each tensor to the next rank and receive the previous rank's (one
    batch of sends and receives)."""
    received = []
    ops = []
    for x in tensors:
        x = x.contiguous()
        buf = torch.empty_like(x)
        ops += [dist.P2POp(dist.isend, x, vg.next_rank, vg.group),
                dist.P2POp(dist.irecv, buf, vg.prev_rank, vg.group)]
        received.append(buf)
    _issue(vg, tensors[0], "ring_shift")
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


# ---------------------------------------------------------------- differentiable collectives


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, vg, dim):
        ctx.vg, ctx.dim = vg, dim
        return all_gather(x, vg, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.vg, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, vg):
        ctx.vg = vg
        return all_reduce(x, vg)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.vg), None


class _BroadcastFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, vg):
        ctx.vg = vg
        return broadcast_first(x, vg)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g, ctx.vg)
        return (total if ctx.vg.rank == 0 else torch.zeros_like(total)), None


def all_gather_views(x: torch.Tensor, vg: ViewGroup, dim: int = 1) -> torch.Tensor:
    """Differentiable ``all_gather``; its backward is a reduce-scatter."""
    return _AllGather.apply(x, vg, dim)


def all_reduce_sum(x: torch.Tensor, vg: ViewGroup) -> torch.Tensor:
    """Differentiable ``all_reduce``; its backward is an all-reduce."""
    return _AllReduce.apply(x, vg)


def broadcast_from_first(x: torch.Tensor, vg: ViewGroup) -> torch.Tensor:
    """Differentiable ``broadcast_first``; the first rank's input gets the sum
    of every rank's gradient, the others' none."""
    return _BroadcastFirst.apply(x, vg)


def sample_slice(dg: ViewGroup, num_samples: int) -> slice:
    """This rank's block of ``num_samples`` samples along the data axis."""
    if num_samples % dg.size:
        raise ValueError(f"{num_samples} samples do not split over {dg.size} ranks")
    per = num_samples // dg.size
    return slice(dg.rank * per, (dg.rank + 1) * per)


def shard_batch_pytree(tree, mesh: Mesh):
    """This rank's (data, view) block of a dataclass of tensors: every tensor field's
    samples (dim 0) by the data group, then its views (dim 1 of the (B, V, ...)
    fields) by the view group, as the JAX ``_shard_batch`` places (B, V, ...) and (B,)
    arrays on the mesh."""
    samples = {f.name: getattr(tree, f.name) for f in fields(tree)}
    samples = {k: x for k, x in samples.items() if isinstance(x, torch.Tensor) and x.dim() >= 1}
    bs = {x.shape[0] for x in samples.values()}
    if len(bs) != 1:
        raise ValueError(f"the tensor fields disagree on B: {sorted(bs)}")
    sl = sample_slice(mesh.data, bs.pop())
    return shard_views_pytree(replace(tree, **{k: x[sl] for k, x in samples.items()}), mesh.view)


def gather_views_pytree(tree, vg: ViewGroup):
    """The inverse of ``shard_views_pytree``: every (B, V, ...) field gathered
    over the ranks (no gradient); per-batch fields stay as they are."""
    with torch.no_grad():
        return replace(tree, **{k: all_gather(x, vg, 1) for k, x in _view_fields(tree).items()})
