"""Camera math for the port: pixel grids, rays, intrinsics recovery, depth
conversions and the factored pointmap.

Counterparts of every public function of ``mapanything_tpu/geometry/camera.py``:
``pixel_grid`` (:18), ``depthmap_to_camera_frame`` (:25),
``depthmap_to_world_frame`` (:54), ``transform_pts3d`` (:72),
``project_pts3d_to_image`` (:82), ``rays_in_camera_frame`` (:98),
``rays_in_world_frame`` (:132), ``recover_pinhole_intrinsics_from_ray_directions``
(:155), ``convert_z_depth_to_depth_along_ray`` (:208),
``depth_along_ray_to_z_depth`` (:221), ``pts3d_cam_from_rays_depth`` (:234),
``pointmap_from_rays_depth_pose`` (:241), ``colmap_to_opencv_intrinsics``
(:264) and ``opencv_to_colmap_intrinsics`` (:272). OpenCV RDF frames, pixel centres at integer coordinates, cam2world
poses; every function broadcasts over leading dimensions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mapanything_tpu_torch.geometry.quaternion import quat_rotate


def pixel_grid(
    height: int, width: int, dtype: torch.dtype = torch.float32, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer pixel-centre grids (x, y), each (H, W)."""
    y = torch.arange(height, dtype=dtype, device=device)[:, None]
    x = torch.arange(width, dtype=dtype, device=device)[None, :]
    return x.expand(height, width), y.expand(height, width)


def depthmap_to_camera_frame(depthmap: torch.Tensor, intrinsics: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unproject z-depth (..., H, W) with pinhole ``intrinsics`` (..., 3, 3):
    the camera-frame pointmap (..., H, W, 3) and where the depth is positive."""
    h, w = depthmap.shape[-2:]
    x_grid, y_grid = pixel_grid(h, w, depthmap.dtype, depthmap.device)
    fx, fy, cx, cy = (intrinsics[..., i, j][..., None, None] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    xx = (x_grid - cx) * depthmap / fx
    yy = (y_grid - cy) * depthmap / fy
    return torch.stack([xx, yy, depthmap], dim=-1), depthmap > 0.0


def _rigid(pose: torch.Tensor, pts: torch.Tensor, translate: bool = True) -> torch.Tensor:
    """Apply (..., 4, 4) (or (..., 3, 4)) ``pose`` to (..., H, W, 3) points."""
    rot = pose[..., None, None, :3, :3]
    out = (rot @ pts[..., None])[..., 0]
    return out + pose[..., None, None, :3, 3] if translate else out


def depthmap_to_world_frame(
    depthmap: torch.Tensor, intrinsics: torch.Tensor, camera_pose: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unproject z-depth (..., H, W) to a world-frame pointmap (..., H, W, 3) through
    the cam2world ``camera_pose`` (..., 4, 4) (the camera frame without one), and
    where the depth is positive."""
    pts3d_cam, valid_mask = depthmap_to_camera_frame(depthmap, intrinsics)
    if camera_pose is None:
        return pts3d_cam, valid_mask
    return _rigid(camera_pose, pts3d_cam), valid_mask


def transform_pts3d(pts3d: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    """Apply a (..., 4, 4) rigid transform to (..., H, W, 3) points."""
    return _rigid(transformation, pts3d)


def project_pts3d_to_image(pts3d: torch.Tensor, intrinsics: torch.Tensor, return_z_dim: bool = False) -> torch.Tensor:
    """Project camera-frame points (..., 3) with ``intrinsics`` (..., 3, 3) to pixels
    (..., 2), or (..., 3) with z appended; |z| below 1e-8 divides as 1e-8."""
    z = pts3d[..., 2:3]
    uv_h = (intrinsics @ pts3d[..., None])[..., 0]
    uv = uv_h[..., :2] / torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    return torch.cat([uv, z], dim=-1) if return_z_dim else uv


def rays_in_camera_frame(
    intrinsics: torch.Tensor, height: int, width: int, normalize_to_unit_sphere: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins (zeros) and directions (..., H, W, 3) in the
    camera frame of pinhole ``intrinsics`` (..., 3, 3): unit length if
    ``normalize_to_unit_sphere``, else on the z = 1 plane."""
    x_grid, y_grid = pixel_grid(height, width, intrinsics.dtype, intrinsics.device)
    fx, fy, cx, cy = (intrinsics[..., i, j][..., None, None] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    xx = (x_grid - cx) / fx
    yy = (y_grid - cy) / fy
    dirs = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
    if normalize_to_unit_sphere:
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return torch.zeros_like(dirs), dirs


def rays_in_world_frame(
    intrinsics: torch.Tensor,
    height: int,
    width: int,
    normalize_to_unit_sphere: bool = True,
    camera_pose: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins and directions (..., H, W, 3) in the world frame of the
    cam2world ``camera_pose`` (..., 4, 4): origins at the camera centre, directions
    rotated (the camera frame without a pose)."""
    origins, dirs = rays_in_camera_frame(intrinsics, height, width, normalize_to_unit_sphere)
    if camera_pose is None:
        return origins, dirs
    return _rigid(camera_pose, origins), _rigid(camera_pose, dirs, translate=False)


def recover_pinhole_intrinsics_from_ray_directions(ray_directions: torch.Tensor) -> torch.Tensor:
    """Pinhole K (..., 3, 3) fitted to a ray-direction map (..., H, W, 3).

    Per image, the 1-D least-squares fits u = fx·(x/z) + cx and
    v = fy·(y/z) + cy over all pixels, in closed form from the 2x2 normal
    equations, in the maps' dtype (fp32), as the JAX package computes them.
    """
    h, w = ray_directions.shape[-3:-1]
    x_grid, y_grid = pixel_grid(h, w, ray_directions.dtype, ray_directions.device)
    z = ray_directions[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    xz = ray_directions[..., 0] / safe_z
    yz = ray_directions[..., 1] / safe_z
    n = float(h * w)

    def solve_axis(t, u):
        st = torch.sum(t, dim=(-2, -1))
        su = torch.sum(u, dim=(-2, -1))
        stt = torch.sum(t * t, dim=(-2, -1))
        stu = torch.sum(t * u, dim=(-2, -1))
        denom = n * stt - st * st
        denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
        f = (n * stu - st * su) / denom
        return f, (su - f * st) / n

    fx, cx = solve_axis(xz, x_grid.expand_as(xz))
    fy, cy = solve_axis(yz, y_grid.expand_as(yz))
    K = torch.zeros(fx.shape + (3, 3), dtype=ray_directions.dtype, device=ray_directions.device)
    K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2], K[..., 2, 2] = fx, fy, cx, cy, 1.0
    return K


def convert_z_depth_to_depth_along_ray(z_depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """z-depth (..., H, W) to the length of the camera-frame point (..., H, W)."""
    h, w = z_depth.shape[-2:]
    _, dirs = rays_in_camera_frame(intrinsics, h, w, normalize_to_unit_sphere=False)
    return torch.linalg.norm(z_depth[..., None] * dirs, dim=-1)


def depth_along_ray_to_z_depth(depth_along_ray: torch.Tensor, ray_directions: torch.Tensor) -> torch.Tensor:
    """Depth along unit rays (..., H, W[, 1]) to z-depth (..., H, W): d · dir_z."""
    if depth_along_ray.shape[-1] == 1 and depth_along_ray.dim() == ray_directions.dim():
        depth_along_ray = depth_along_ray[..., 0]
    return depth_along_ray * ray_directions[..., 2]


def pts3d_cam_from_rays_depth(ray_directions: torch.Tensor, depth_along_ray: torch.Tensor) -> torch.Tensor:
    """Camera-frame pointmap from unit ray directions (..., 3) and depth along them (..., 1)."""
    return ray_directions * depth_along_ray


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


def colmap_to_opencv_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """COLMAP (pixel centres at 0.5) to OpenCV (centres at 0): the principal point
    of ``K`` (..., 3, 3) moves by -0.5; a new tensor."""
    K = K.clone()
    K[..., :2, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """OpenCV to COLMAP principal-point convention: +0.5; a new tensor."""
    K = K.clone()
    K[..., :2, 2] += 0.5
    return K
