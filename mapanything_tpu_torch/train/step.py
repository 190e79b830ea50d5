"""The train and eval steps of the port.

Counterpart of ``mapanything_tpu/train/step.py``: ``TrainState`` (:31),
``views_from_loss_batch`` (:38), ``make_train_step`` (:52-109) and
``make_eval_step``. A step samples the modality masks and, where the model
uses them, random view-PE indices; runs the differentiable forward with the
ground-truth rays, depth and poses as inputs; takes the production loss
scaled by 2 / V (training.py:475-478); back-propagates; and applies the
optimizer. The parameters live in the model and are updated in place.
Gradient accumulation, the trainer loop, checkpoints and the data loader
wait for a later slice.
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


def make_loss_fn(model: MapAnything, loss_cfg: LossConfig = LossConfig()):
    """``loss_fn(batch, img, masks, pe_indices) -> (loss · 2 / V, details)``,
    the differentiable part of the step."""

    def loss_fn(batch: LossBatch, img: torch.Tensor, masks: ModalityMasks,
                pe_indices: Optional[torch.Tensor] = None):
        preds = model(views_from_loss_batch(batch, img), masks, deterministic=True,
                      non_ref_view_pe_indices=pe_indices)
        loss, details = factored_geometry_scale_loss(batch, preds, loss_cfg)
        return loss * 2.0 / batch.valid_mask.shape[1], details

    return loss_fn


def make_train_step(
    model: MapAnything,
    optimizer: AdamW,
    loss_cfg: LossConfig = LossConfig(),
    geo_cfg: GeometricInputConfig = GeometricInputConfig(),
):
    """``step(state, img, batch, generator) -> (state, metrics)``.

    ``generator`` (a CPU ``torch.Generator``) draws the modality masks and
    the view-PE indices. ``metrics`` holds the loss details, ``loss`` and
    ``grad_norm`` (the norm before clipping), as 0-dim tensors on the
    model's device.
    """
    loss_fn = make_loss_fn(model, loss_cfg)
    cfg = model.config

    def step(state: TrainState, img: torch.Tensor, batch: LossBatch, generator: torch.Generator):
        B, V, H, W = batch.valid_mask.shape
        masks = sample_modality_masks(generator, B, V, (H, W), geo_cfg, device=model.device)
        pe_indices = None
        if cfg.use_pe_for_non_reference_views and cfg.use_rand_idx_pe_for_non_reference_views and V > 1:
            pe_indices = torch.randint(1, cfg.max_num_views_for_pe, (V - 1,), generator=generator)
        for p in state.params.values():
            p.grad = None
        loss, details = loss_fn(batch, img, masks, pe_indices)
        loss.backward()
        grads = {n: p.grad for n, p in state.params.items()}
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        metrics = {k: v.detach() for k, v in details.items()}
        metrics.update(loss=loss.detach(), grad_norm=opt_state.grad_norm)
        return TrainState(params=state.params, opt_state=opt_state, step=state.step + 1), metrics

    return step


def make_eval_step(model: MapAnything, loss_cfg: LossConfig = LossConfig()):
    """``eval_step(img, batch) -> details``, no gradients. As in the JAX
    package, every ground-truth modality is an input (masks None)."""

    def eval_step(img: torch.Tensor, batch: LossBatch) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            preds = model(views_from_loss_batch(batch, img))
            _, details = factored_geometry_scale_loss(batch, preds, loss_cfg)
            return dict(details, loss=details["total_loss"] * 2.0 / batch.valid_mask.shape[1])

    return eval_step
