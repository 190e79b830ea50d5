"""Scale normalisation of depths, translations and point clouds for the port.

Counterparts of ``mapanything_tpu/geometry/normalization.py``: ``safe_norm``
(:14), ``normalize_depth_using_non_zero_pixels`` (:32),
``normalize_pose_translations`` (:58), ``normalize_pointcloud`` (:75) and
``apply_log_to_norm`` (:129), over stacked (B, V, ...) tensors.

The two multi-view normalisers take an optional view group: with one, the
views given are this rank's block, and the sums over views are all-reduced
over the group (differentiably), so every rank gets the factor of all views.
"""

from __future__ import annotations

from typing import Optional

import torch

from mapanything_tpu_torch.parallel.mesh import ViewGroup, all_reduce_sum


def safe_norm(x: torch.Tensor, dim=-1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm that is exactly 0 at the origin, with a 0 gradient there."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    zero = sq == 0
    root = torch.sqrt(torch.where(zero, torch.ones_like(sq), sq))
    return torch.where(zero, torch.zeros_like(root), root)


def normalize_depth_using_non_zero_pixels(depth: torch.Tensor, return_norm_factor: bool = False):
    """Divide each leading-batch element of ``depth`` (B, ..., 1) by the mean of
    its non-zero pixels; the factor (B,) is floored at 1e-8."""
    dims = tuple(range(1, depth.dim()))
    valid = depth > 0
    valid_sum = torch.sum(torch.where(valid, depth, torch.zeros_like(depth)), dim=dims)
    norm_factor = torch.clamp(valid_sum / (valid.sum(dim=dims) + 1e-8), min=1e-8)
    normalized = depth / norm_factor.reshape((depth.shape[0],) + (1,) * (depth.dim() - 1))
    return (normalized, norm_factor) if return_norm_factor else normalized


def _view_sums(sums: torch.Tensor, counts: torch.Tensor, group: Optional[ViewGroup]):
    """Per-batch sums and counts over the views, over every rank's views with a group."""
    if group is None:
        return sums, counts
    both = all_reduce_sum(torch.stack([sums, counts.to(sums.dtype)]), group)
    return both[0], both[1]


def normalize_pose_translations(
    pose_translations: torch.Tensor, return_norm_factor: bool = False, group: Optional[ViewGroup] = None
):
    """Divide (B, V, 3) translations by the mean norm of the non-zero ones (B,)."""
    dist = safe_norm(pose_translations, dim=-1)
    nonzero = dist > 0
    total, count = _view_sums(dist.sum(dim=1), nonzero.sum(dim=1), group)
    norm_factor = torch.clamp(total / (count + 1e-8), min=1e-8)
    normalized = pose_translations / norm_factor[:, None, None]
    return (normalized, norm_factor) if return_norm_factor else normalized


def normalize_pointcloud(
    pts: torch.Tensor,
    valid_mask: Optional[torch.Tensor] = None,
    norm_mode: str = "avg_dis",
    ret_factor: bool = False,
    group: Optional[ViewGroup] = None,
):
    """Normalise a stacked multi-view point cloud (B, ..., 3) jointly per batch
    element by its mean (transformed) distance over ``valid_mask`` (B, ...).

    ``norm_mode`` is "avg_<dis>" with dis one of "dis", "log1p", "warp-log1p".
    The factor is returned as (B, 1, ..., 1).
    """
    norm, dis_mode = norm_mode.split("_", 1)
    if norm != "avg":
        raise ValueError(f"unsupported norm mode {norm}")
    if valid_mask is None:
        valid_mask = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    pts_z = torch.where(valid_mask[..., None], pts, torch.zeros_like(pts))
    dims = tuple(range(1, pts.dim() - 1))
    dis = safe_norm(pts_z, dim=-1)
    if dis_mode == "dis":
        pass
    elif dis_mode == "log1p":
        dis = torch.log1p(dis)
    elif dis_mode == "warp-log1p":
        log_dis = torch.log1p(dis)
        pts = pts * (log_dis / torch.clamp(dis, min=1e-8))[..., None]
        dis = log_dis
    else:
        raise ValueError(f"bad dis_mode={dis_mode}")
    masked = torch.where(valid_mask, dis, torch.zeros_like(dis))
    total, nnz = _view_sums(masked.sum(dim=dims), valid_mask.sum(dim=dims), group)
    norm_factor = torch.clamp(total / (nnz + 1e-8), min=1e-8)
    nf = norm_factor.reshape((pts.shape[0],) + (1,) * (pts.dim() - 1))
    res = pts / nf
    return (res, nf) if ret_factor else res


def apply_log_to_norm(x: torch.Tensor) -> torch.Tensor:
    """Rescale vectors to log1p of their norm, keeping the direction."""
    d = safe_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(d, min=1e-8) * torch.log1p(d)
