"""Geometry of the port: cameras, rays, quaternions, normalisation, normals, frusta.

Counterpart of ``mapanything_tpu/geometry/__init__.py``: the same names, exported
from the same modules.
"""

from mapanything_tpu_torch.geometry.camera import (
    colmap_to_opencv_intrinsics,
    convert_z_depth_to_depth_along_ray,
    depth_along_ray_to_z_depth,
    depthmap_to_camera_frame,
    depthmap_to_world_frame,
    opencv_to_colmap_intrinsics,
    pixel_grid,
    pointmap_from_rays_depth_pose,
    project_pts3d_to_image,
    pts3d_cam_from_rays_depth,
    rays_in_camera_frame,
    rays_in_world_frame,
    recover_pinhole_intrinsics_from_ray_directions,
    transform_pts3d,
)
from mapanything_tpu_torch.geometry.frustum import calculate_in_frustum_mask
from mapanything_tpu_torch.geometry.normalization import (
    apply_log_to_norm,
    normalize_depth_using_non_zero_pixels,
    normalize_pointcloud,
    normalize_pose_translations,
)
from mapanything_tpu_torch.geometry.normals import (
    angle_diff_vec3,
    depth_edge,
    normals_edge,
    points_to_normals,
)
from mapanything_tpu_torch.geometry.quaternion import (
    pose_matrix_to_quats_trans,
    quat_inverse,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_standardize,
    quat_to_rotmat,
    quats_trans_to_pose_matrix,
    relative_pose_quats_trans,
    rotmat_to_quat,
)
from mapanything_tpu_torch.geometry.transforms import (
    closed_form_pose_inverse,
    extri_to_homo,
    geotrf,
    inv_pose,
    relative_pose_transformation,
)

__all__ = [k for k in dir() if not k.startswith("_")]
