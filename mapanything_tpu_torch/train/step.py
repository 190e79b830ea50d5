"""The train and eval steps of the port.

Counterpart of ``mapanything_tpu/train/step.py``: ``TrainState`` (:31),
``views_from_loss_batch`` (:38), ``make_train_step`` (:52-109),
``make_accum_train_step`` (:112-163) and ``make_eval_step``. A step samples
the modality masks and, where the model uses them, random view-PE indices;
runs the differentiable forward with the
ground-truth rays, depth and poses as inputs; takes the production loss
scaled by 2 / V (training.py:475-478); back-propagates; and applies the
optimizer. The parameters live in the model and are updated in place.
The accumulating step runs its micro-batches in turn, summing their
gradients in ``.grad``, and takes one update with their mean.

Under a view group (view parallelism; the JAX package's view-sharded step,
``__graft_entry__.py:377-418``) each rank passes its block of the views.
The masks and PE indices are drawn for all views from the shared generator
on every rank and sliced; the forward runs inside the group's ``parallel.cp``
context under the ring schedule; each rank back-propagates its part of the
loss; the parameters' gradients are all-reduced (summed) over the group, so
every rank applies the same update; the metrics are the group's sums, the
unsharded values.

Under a ``Mesh`` (data × view; the JAX ``Trainer``'s mesh) each rank passes its
(data, view) block of the global batch: its samples' views. The masks and PE
indices are drawn for the whole global batch and sliced; the forward runs
view-parallel over the mesh's view group; the loss's batch means divide by
counts summed over its data group (``train.losses``), so each rank's part,
summed over every rank of the mesh, is the unsharded loss of the global batch;
the gradients and the metrics are summed over every rank, and the clip reads
the norm of the summed gradients.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from mapanything_tpu_torch.models.mapanything import (
    GeometricInputConfig,
    MapAnything,
    ModalityMasks,
    Views,
    sample_modality_masks,
)
from mapanything_tpu_torch.parallel.cp import context_parallel_attention
from mapanything_tpu_torch.parallel.mesh import (
    Mesh, ViewGroup, all_reduce, all_reduce_, shard_batch_pytree, shard_views_pytree,
)
from mapanything_tpu_torch.train.losses import LossBatch, LossConfig, factored_geometry_scale_loss
from mapanything_tpu_torch.train.optim import AdamW, OptState, apply_updates


@dataclass
class TrainState:
    params: Dict[str, nn.Parameter]  # the model's own parameters, by name
    opt_state: OptState
    step: int


def init_train_state(model: nn.Module, optimizer: AdamW) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def views_from_loss_batch(batch: LossBatch, img: torch.Tensor) -> Views:
    """The model's inputs at train time: the images and the ground-truth geometry."""
    return Views(
        img=img,
        ray_directions=batch.ray_directions,
        depth_along_ray=batch.depth_along_ray,
        camera_pose_quats=batch.camera_pose_quats,
        camera_pose_trans=batch.camera_pose_trans,
        is_metric_scale=batch.is_metric_scale[:, None].expand(batch.valid_mask.shape[:2]),
    )


def make_loss_fn(
    model: MapAnything,
    loss_cfg: LossConfig = LossConfig(),
    view_group: Optional[ViewGroup] = None,
    data_group: Optional[ViewGroup] = None,
):
    """``loss_fn(batch, img, masks, pe_indices) -> (loss · 2 / V, details)``,
    the differentiable part of the step. With a ``view_group`` the inputs are
    this rank's views, the forward is view-parallel under the ring schedule
    (the JAX package's view-sharded step), V counts every rank's views, and
    the results are this rank's parts. With a ``data_group`` the inputs are this
    rank's samples, and the loss's batch means count every rank's samples."""
    n = 1 if view_group is None else view_group.size

    def loss_fn(batch: LossBatch, img: torch.Tensor, masks: ModalityMasks,
                pe_indices: Optional[torch.Tensor] = None):
        views = views_from_loss_batch(batch, img)
        if view_group is None:
            preds = model(views, masks, deterministic=True, non_ref_view_pe_indices=pe_indices)
        else:
            with context_parallel_attention(view_group, "ring"):
                preds = model(views, masks, deterministic=True, non_ref_view_pe_indices=pe_indices)
        loss, details = factored_geometry_scale_loss(batch, preds, loss_cfg, view_group, data_group)
        return loss * 2.0 / (batch.valid_mask.shape[1] * n), details

    return loss_fn


def _groups(view_group: Optional[ViewGroup], mesh: Optional[Mesh]):
    """(view group, data group, the group over which gradients and metrics sum)."""
    if mesh is not None:
        if view_group is not None:
            raise ValueError("give a view_group or a mesh, not both")
        return mesh.view, mesh.data, mesh.world
    return view_group, None, view_group


def _global_shape(batch: LossBatch, view_group, data_group):
    """(B, V, H, W) of the global batch of which ``batch`` is this rank's block."""
    B, V, H, W = batch.valid_mask.shape
    return (B * (1 if data_group is None else data_group.size), V * (1 if view_group is None else view_group.size),
            H, W)


def _shard_masks(masks: ModalityMasks, device, view_group, data_group, mesh) -> ModalityMasks:
    if mesh is not None:
        return shard_batch_pytree(masks.to(device), mesh)
    if view_group is not None:
        return shard_views_pytree(masks.to(device), view_group)
    return masks


def all_reduce_grads(params, view_group: ViewGroup) -> None:
    """Sum the parameters' gradients over the group, in place, one collective
    for each dtype; a parameter without a gradient gets the others' sum."""
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), view_group)
        torch._foreach_copy_(grads, [x.view_as(g) for x, g in zip(flat.split([g.numel() for g in grads]), grads)])


def draw_step_inputs(model: MapAnything, geo_cfg: GeometricInputConfig, generator: torch.Generator,
                     batch_shape, masks: Optional[ModalityMasks] = None):
    """``(masks, pe_indices)`` of one (micro-)batch of ``batch_shape`` = (B, V, H, W)
    over all its views: the modality masks drawn from ``generator`` unless given,
    then, where the model uses them, the random view-PE indices."""
    B, V, H, W = batch_shape
    if masks is None:
        masks = sample_modality_masks(generator, B, V, (H, W), geo_cfg, device=model.device)
    cfg = model.config
    pe_indices = None
    if cfg.use_pe_for_non_reference_views and cfg.use_rand_idx_pe_for_non_reference_views and V > 1:
        pe_indices = torch.randint(1, cfg.max_num_views_for_pe, (V - 1,), generator=generator)
    return masks, pe_indices


def apply_grads(optimizer: AdamW, state: TrainState) -> TrainState:
    """One optimizer update from the parameters' ``.grad``; ``state.opt_state.grad_norm``
    of the new state is their norm before clipping."""
    grads = {name: p.grad for name, p in state.params.items()}
    updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
    apply_updates(state.params, updates)
    return TrainState(params=state.params, opt_state=opt_state, step=state.step + 1)


def _sum_metrics(metrics: Dict[str, torch.Tensor], group: Optional[ViewGroup]) -> Dict[str, torch.Tensor]:
    """Each metric summed over ``group`` (as it is without one), in one collective."""
    if group is None:
        return metrics
    names = list(metrics)
    return dict(zip(names, all_reduce(torch.stack([metrics[k].float() for k in names]), group).unbind()))


def make_train_step(
    model: MapAnything,
    optimizer: AdamW,
    loss_cfg: LossConfig = LossConfig(),
    geo_cfg: GeometricInputConfig = GeometricInputConfig(),
    view_group: Optional[ViewGroup] = None,
    mesh: Optional[Mesh] = None,
):
    """``step(state, img, batch, generator, masks=None) -> (state, metrics)``.

    ``generator`` (a CPU ``torch.Generator``) draws the modality masks, unless
    ``masks`` (for all views) are given, and the view-PE indices. ``metrics``
    holds the loss details, ``loss`` and ``grad_norm`` (the norm before
    clipping), as 0-dim tensors on the model's device. With a ``view_group``,
    ``img`` and ``batch`` hold this rank's views (``shard_views_pytree``) and
    the step runs view-parallel under the ring; with a ``mesh``, this rank's
    (data, view) block (``shard_batch_pytree``; see the module's docstring).
    """
    view_group, data_group, group = _groups(view_group, mesh)
    loss_fn = make_loss_fn(model, loss_cfg, view_group, data_group)

    def step(state: TrainState, img: torch.Tensor, batch: LossBatch, generator: torch.Generator,
             masks: Optional[ModalityMasks] = None):
        masks, pe_indices = draw_step_inputs(model, geo_cfg, generator, _global_shape(batch, view_group, data_group),
                                             masks)
        masks = _shard_masks(masks, model.device, view_group, data_group, mesh)
        for p in state.params.values():
            p.grad = None
        loss, details = loss_fn(batch, img, masks, pe_indices)
        loss.backward()
        metrics = {k: v.detach() for k, v in details.items()}
        metrics["loss"] = loss.detach()
        if group is not None:
            all_reduce_grads(state.params.values(), group)
            metrics = _sum_metrics(metrics, group)
        state = apply_grads(optimizer, state)
        metrics["grad_norm"] = state.opt_state.grad_norm
        return state, metrics

    return step


def make_accum_train_step(
    model: MapAnything,
    optimizer: AdamW,
    accum_iter: int,
    loss_cfg: LossConfig = LossConfig(),
    geo_cfg: GeometricInputConfig = GeometricInputConfig(),
    mesh: Optional[Mesh] = None,
):
    """``step(state, imgs, batches, generator, masks=None) -> (state, metrics)``:
    one optimizer update from ``accum_iter`` micro-batches (the reference's
    accum_iter loop, training.py:433,512-526; the JAX package scans them).

    ``imgs`` and ``batches`` are sequences of ``accum_iter`` micro-batches. Each
    runs forward and backward in turn, its loss scaled by 2 / V, and its
    gradients add up in ``.grad``; the sum and the summed loss are then divided
    by ``accum_iter`` (JAX :150-151), and the optimizer takes the mean gradients.
    ``generator`` draws each micro-batch's modality masks, unless ``masks`` (one
    ``ModalityMasks`` a micro-batch) are given, then its view-PE indices, micro-batch
    by micro-batch. ``metrics`` holds ``loss`` and ``grad_norm`` (of the mean
    gradients, before clipping) as 0-dim tensors. With a ``mesh``, each micro-batch
    is this rank's (data, view) block of a global micro-batch, as in ``make_train_step``.
    """
    view_group, data_group, group = _groups(None, mesh)
    loss_fn = make_loss_fn(model, loss_cfg, view_group, data_group)

    def step(state: TrainState, imgs, batches, generator: torch.Generator, masks=None):
        if len(imgs) != accum_iter or len(batches) != accum_iter or (masks is not None and len(masks) != accum_iter):
            raise ValueError(f"the step accumulates {accum_iter} micro-batches")
        for p in state.params.values():
            p.grad = None
        loss_sum = None
        for i, (img, batch) in enumerate(zip(imgs, batches)):
            m, pe_indices = draw_step_inputs(model, geo_cfg, generator, _global_shape(batch, view_group, data_group),
                                             None if masks is None else masks[i])
            m = _shard_masks(m, model.device, view_group, data_group, mesh)
            loss, _ = loss_fn(batch, img, m, pe_indices)
            loss.backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        if group is not None:
            all_reduce_grads(state.params.values(), group)
            loss_sum = _sum_metrics({"loss": loss_sum}, group)["loss"]
        for p in state.params.values():
            if p.grad is not None:
                p.grad.div_(accum_iter)
        state = apply_grads(optimizer, state)
        return state, {"loss": loss_sum / accum_iter, "grad_norm": state.opt_state.grad_norm}

    return step


def make_eval_step(model: MapAnything, loss_cfg: LossConfig = LossConfig(), mesh: Optional[Mesh] = None):
    """``eval_step(img, batch) -> details``, no gradients. As in the JAX
    package, every ground-truth modality is an input (masks None). With a
    ``mesh``, ``img`` and ``batch`` are this rank's (data, view) block, the
    forward is view-parallel and the details are the mesh's sums."""
    view_group, data_group, group = _groups(None, mesh)

    def eval_step(img: torch.Tensor, batch: LossBatch) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            views = views_from_loss_batch(batch, img)
            if view_group is None:
                preds = model(views)
            else:
                with context_parallel_attention(view_group, "ring"):
                    preds = model(views)
            _, details = factored_geometry_scale_loss(batch, preds, loss_cfg, view_group, data_group)
            details = _sum_metrics(details, group)
            V = batch.valid_mask.shape[1] * (1 if view_group is None else view_group.size)
            return dict(details, loss=details["total_loss"] * 2.0 / V)

    return eval_step
