"""Cross-view frustum-consistency masks.

Counterpart of ``mapanything_tpu/geometry/frustum.py``:
``calculate_in_frustum_mask`` (:20-94). Every view-1 point is projected into
every view-2 camera at once, and view 2's depth and mask are read at the
nearest pixel by a gather.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mapanything_tpu_torch.geometry.camera import depthmap_to_camera_frame
from mapanything_tpu_torch.geometry.transforms import closed_form_pose_inverse


def calculate_in_frustum_mask(
    depth_1: torch.Tensor,
    intrinsics_1: torch.Tensor,
    c2w_1: torch.Tensor,
    mask_1: torch.Tensor,
    depth_2: torch.Tensor,
    intrinsics_2: torch.Tensor,
    c2w_2: torch.Tensor,
    mask_2: torch.Tensor,
    atol: float = 1e-1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which pixels of view set 1 are observed consistently by view set 2.

    ``depth_1`` (B, V1, H, W) z-depth, ``intrinsics_1`` (B, V1, 3, 3),
    ``c2w_1`` (B, V1, 4, 4), ``mask_1`` (B, V1, H, W) bool; the same for the
    V2 views of set 2. Returns ``(mask, valid_mask)``, both (B, V1, H, W):
    the pixel is re-observed (non-ambiguous) or already in ``mask_1``; and
    the mask's value at the pixel can be trusted.
    """
    b, v1, h, w = depth_1.shape
    v2 = depth_2.shape[1]

    # World-frame points of set 1, then in every camera of set 2: (B, V1, V2, H, W, 3).
    pts_cam, _ = depthmap_to_camera_frame(depth_1, intrinsics_1)
    pts_world = torch.einsum("bvik,bvhwk->bvhwi", c2w_1[..., :3, :3], pts_cam) + c2w_1[:, :, None, None, :3, 3]
    w2c_2 = closed_form_pose_inverse(c2w_2)
    cam_pts = (torch.einsum("buik,bvhwk->bvuhwi", w2c_2[..., :3, :3], pts_world)
               + w2c_2[:, None, :, None, None, :3, 3])

    # Project with set 2's intrinsics.
    z = cam_pts[..., 2]
    uvw = torch.einsum("buij,bvuhwj->bvuhwi", intrinsics_2, cam_pts)
    safe_z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = uvw[..., 0] / safe_z
    v = uvw[..., 1] / safe_z
    in_frustum = (u > 0) & (u < w) & (v > 0) & (v < h) & (z > 0)
    in_frustum_any = in_frustum.any(dim=2)
    non_zero_depth = depth_1 > 1e-6

    # Set 2's depth and mask at the projected pixel (floor: grid_sample's nearest
    # texel for in-bounds coordinates).
    ui = torch.clamp(torch.floor(u), 0, w - 1).long()
    vi = torch.clamp(torch.floor(v), 0, h - 1).long()
    flat_idx = vi * w + ui  # (B, V1, V2, H, W)
    gathered_depth = _gather_bv(depth_2.reshape(b, v2, h * w), flat_idx)
    gathered_mask = _gather_bv(mask_2.reshape(b, v2, h * w), flat_idx)

    close = torch.abs(z - gathered_depth) <= atol + 1e-5 * torch.abs(gathered_depth)  # jnp.isclose
    matching = close & gathered_mask & in_frustum
    valid_match = gathered_mask & in_frustum
    mask = (non_zero_depth & in_frustum_any & matching.any(dim=2)) | mask_1
    valid_mask = (non_zero_depth & ~(in_frustum_any & ~valid_match.any(dim=2))) | mask_1
    return mask, valid_mask


def _gather_bv(src_flat: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """``src_flat`` (B, V2, H·W) read at ``flat_idx`` (B, V1, V2, H, W)."""
    b, v1, v2, h, w = flat_idx.shape
    idx = flat_idx.permute(0, 2, 1, 3, 4).reshape(b, v2, v1 * h * w)
    out = torch.gather(src_flat, -1, idx)
    return out.reshape(b, v2, v1, h, w).permute(0, 2, 1, 3, 4)
