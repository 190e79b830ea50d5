"""Camera math for the port (``pointmap_from_rays_depth_pose`` of
``mapanything_tpu/geometry/camera.py`` :241). OpenCV RDF frames, cam2world
poses."""

from __future__ import annotations

import torch

from mapanything_tpu_torch.geometry.quaternion import quat_rotate


def pointmap_from_rays_depth_pose(
    ray_directions: torch.Tensor,
    depth_along_ray: torch.Tensor,
    pose_trans: torch.Tensor,
    pose_quats: torch.Tensor,
) -> torch.Tensor:
    """World-frame pointmap from the factored scene representation.

    Args:
        ray_directions: (..., H, W, 3) unit rays in the camera frame.
        depth_along_ray: (..., H, W, 1).
        pose_trans: (..., 3) cam2world translation.
        pose_quats: (..., 4) cam2world XYZW quaternion.
    """
    pts3d_local = depth_along_ray * ray_directions
    quats = pose_quats[..., None, None, :]
    trans = pose_trans[..., None, None, :]
    return quat_rotate(quats, pts3d_local) + trans
