"""The train-time refinement of the ground truth's non-ambiguous masks.

Counterpart of ``mapanything_tpu/train/masks.py``:
``refine_batch_with_frustum_masks`` (:20-44). Cross-view frustum consistency of
the ground-truth depth and poses refines the non-ambiguous mask and the loss's
validity mask, before the loss and outside the model.
"""

from __future__ import annotations

import dataclasses

import torch

from mapanything_tpu_torch.geometry.frustum import calculate_in_frustum_mask
from mapanything_tpu_torch.geometry.quaternion import quats_trans_to_pose_matrix
from mapanything_tpu_torch.train.losses import LossBatch


def refine_batch_with_frustum_masks(batch: LossBatch, intrinsics: torch.Tensor) -> LossBatch:
    """A new ``LossBatch`` with ``non_ambiguous_mask`` and
    ``valid_non_ambiguous_mask`` from ``calculate_in_frustum_mask`` of every view
    against every view, and ``valid_mask & mask & valid`` (the reference's
    model.py:788). ``intrinsics`` (B, V, 3, 3) are the ground truth's pinhole K;
    the z-depth comes from ``pts3d_cam``."""
    depth_z = batch.pts3d_cam[..., 2]
    c2w = quats_trans_to_pose_matrix(batch.camera_pose_quats, batch.camera_pose_trans)
    mask, valid = calculate_in_frustum_mask(
        depth_z, intrinsics, c2w, batch.non_ambiguous_mask,
        depth_z, intrinsics, c2w, batch.non_ambiguous_mask,
    )
    return dataclasses.replace(
        batch, non_ambiguous_mask=mask, valid_non_ambiguous_mask=valid,
        valid_mask=batch.valid_mask & mask & valid,
    )
