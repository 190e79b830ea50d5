"""Rigid transforms: applying a transform to points, pose inverses, relative poses.

Counterpart of ``mapanything_tpu/geometry/transforms.py`` (:13-80): ``geotrf``,
``closed_form_pose_inverse`` (alias ``inv_pose``), ``relative_pose_transformation``
and ``extri_to_homo``, for any leading batch dimensions.
"""

from __future__ import annotations

import torch


def geotrf(trf: torch.Tensor, pts: torch.Tensor, norm: bool = False) -> torch.Tensor:
    """Apply a (..., 3, 3), (..., 3, 4) or (..., 4, 4) transform to points
    (..., N, 3) or (..., H, W, 3); the transform's leading dimensions broadcast
    against the points' batch dimensions. ``norm`` divides by the homogeneous
    coordinate."""
    d = pts.shape[-1]
    n_extra = pts.dim() - trf.dim() + 1  # spatial dims beyond the batch: (N,) or (H, W)
    mat = trf.reshape(trf.shape[:-2] + (1,) * n_extra + trf.shape[-2:])
    out = torch.einsum("...ik,...k->...i", mat[..., :d, :d], pts)
    if trf.shape[-1] > d:
        out = out + mat[..., :d, d]
    if norm and trf.shape[-2] > d:
        w = (torch.einsum("...k,...k->...", mat[..., d, :d], pts) + mat[..., d, d])[..., None]
        out = out / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return out


def closed_form_pose_inverse(pose: torch.Tensor) -> torch.Tensor:
    """Invert rigid (..., 4, 4) or (..., 3, 4) poses: [[R^T, -R^T t], [0, 1]]."""
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", rot_t, pose[..., :3, 3])
    top = torch.cat([rot_t, t_inv[..., :, None]], dim=-1)
    return torch.cat([top, _homogeneous_row(pose)], dim=-2)


inv_pose = closed_form_pose_inverse  # the reference's name, ``inv``


def relative_pose_transformation(trans_01: torch.Tensor, trans_02: torch.Tensor) -> torch.Tensor:
    """trans_12 = inv(trans_01) @ trans_02."""
    return torch.einsum("...ij,...jk->...ik", closed_form_pose_inverse(trans_01), trans_02)


def extri_to_homo(extris: torch.Tensor) -> torch.Tensor:
    """Pad (..., 3, 4) extrinsics to homogeneous (..., 4, 4)."""
    return torch.cat([extris, _homogeneous_row(extris)], dim=-2)


def _homogeneous_row(like: torch.Tensor) -> torch.Tensor:
    return like.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(like.shape[:-2] + (1, 4))


# The reference's name ``inv`` (geometry.py:1040), as the JAX package aliases it.
inv_pose = closed_form_pose_inverse
