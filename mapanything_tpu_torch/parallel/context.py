"""Context parallelism: many-view inference sharded over the view axis.

Counterpart of ``mapanything_tpu/parallel/context.py`` (``infer_view_sharded``
:50, ``max_views_per_chip_estimate`` :73; its ``shard_views`` :37 is
``parallel.mesh.shard_views_pytree`` here). The JAX package places the
views over the mesh and jits the forward; here every rank runs the forward
on its block of the views inside a ``parallel.cp`` context, the trunk's
global layers meet across ranks through
``parallel/sharded_attention.py``, and each rank returns its views'
predictions (``gather_predictions`` collects all of them).

View-order legality: the views are order-equivariant except view 0, so
block sharding keeps the semantics as long as the first rank holds view 0,
which block sharding guarantees.
"""

from __future__ import annotations

import torch

from mapanything_tpu_torch.models.mapanything import MapAnything, Predictions, Views
from mapanything_tpu_torch.parallel.cp import context_parallel_attention
from mapanything_tpu_torch.parallel.mesh import ViewGroup, gather_views_pytree, shard_views_pytree


def infer_view_sharded(model: MapAnything, views: Views, group: ViewGroup, schedule: str = "allgather") -> Predictions:
    """Run the forward with the views sharded over ``group``; every rank of
    the group calls it with the same ``views``. Returns this rank's views'
    predictions (the scale is the same on every rank)."""
    local = shard_views_pytree(views, group)
    with torch.inference_mode(), context_parallel_attention(group, schedule):
        return model(local)


def gather_predictions(preds: Predictions, group: ViewGroup) -> Predictions:
    """Every rank's predictions, views in order, on every rank."""
    return gather_views_pytree(preds, group)


def max_views_per_chip_estimate(
    image_hw, patch_size: int = 14, head_chunk: int = 1, hbm_bytes: int = 80 * 10**9
) -> int:
    """Rough static analogue of the reference's adaptive minibatch sizing
    (model.py:1440-1477, 680 MB a view at 518 px): how many views fit on one
    card of ``hbm_bytes`` (an 80 GB H100 by default) at this resolution."""
    h, w = image_hw
    scale = (h * w) / (518 * 518)
    per_view = int(680e6 * scale / max(head_chunk, 1))
    budget = int(hbm_bytes * 0.6)
    return max(1, budget // max(per_view, 1))
