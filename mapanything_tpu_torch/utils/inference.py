"""The port's user-facing inference pipeline: preprocess -> forward -> postprocess.

Counterpart of ``mapanything_tpu/utils/inference.py``: ``PostprocessConfig``
(:42), ``InferenceOutputs`` (:54), ``preprocess_inputs_for_inference`` (:73),
``_per_image_quantile`` (:146), ``postprocess_model_outputs_for_inference``
(:153) and ``infer`` (:214). The model holds its weights, so ``infer`` takes
no parameter tree. Everything after the inputs are moved runs on the model's
device: the confidence quantiles, normals and edge masks included, with no
copy to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from mapanything_tpu_torch.geometry.camera import (
    convert_z_depth_to_depth_along_ray,
    rays_in_camera_frame,
    recover_pinhole_intrinsics_from_ray_directions,
)
from mapanything_tpu_torch.geometry.normals import depth_edge, normals_edge, points_to_normals
from mapanything_tpu_torch.geometry.quaternion import (
    pose_matrix_to_quats_trans,
    quats_trans_to_pose_matrix,
)
from mapanything_tpu_torch.models.encoders.normalizations import IMAGE_NORMALIZATION_DICT
from mapanything_tpu_torch.models.mapanything import Predictions, Views, resolve_device


@dataclass(frozen=True)
class PostprocessConfig:
    """Masking options of the postprocess."""

    apply_mask: bool = True
    mask_edges: bool = True
    edge_normal_threshold: float = 5.0
    edge_depth_threshold: float = 0.03
    apply_confidence_mask: bool = False
    confidence_percentile: float = 10.0


@dataclass
class InferenceOutputs:
    """Postprocessed predictions, all (B, V, ...) on the model's device."""

    pts3d: torch.Tensor
    pts3d_cam: torch.Tensor
    ray_directions: torch.Tensor
    depth_along_ray: torch.Tensor
    depth_z: torch.Tensor  # (B, V, H, W, 1)
    intrinsics: torch.Tensor  # (B, V, 3, 3) recovered from the rays
    camera_poses: torch.Tensor  # (B, V, 4, 4) cam2world, view 0's frame
    cam_trans: torch.Tensor
    cam_quats: torch.Tensor
    metric_scaling_factor: torch.Tensor
    img_no_norm: torch.Tensor  # (B, V, H, W, 3) in [0, 1]
    conf: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None  # (B, V, H, W, 1), the combined mask
    non_ambiguous_mask: Optional[torch.Tensor] = None


def preprocess_inputs_for_inference(
    images: torch.Tensor,
    intrinsics: Optional[torch.Tensor] = None,
    depth_z: Optional[torch.Tensor] = None,
    depth_along_ray: Optional[torch.Tensor] = None,
    ray_directions: Optional[torch.Tensor] = None,
    camera_poses: Optional[torch.Tensor] = None,
    camera_pose_quats: Optional[torch.Tensor] = None,
    camera_pose_trans: Optional[torch.Tensor] = None,
    is_metric_scale: Optional[torch.Tensor] = None,
    data_norm_type: str = "dinov2",
) -> Views:
    """Model ``Views`` from user inputs, on the inputs' device.

    Args:
        images: (B, V, H, W, 3) RGB in [0, 1].
        intrinsics: optional (B, V, 3, 3) pinhole K (OpenCV convention),
            turned into unit ray directions.
        depth_z: optional (B, V, H, W[, 1]) z-depth, turned into depth along
            the ray; needs ``intrinsics``.
        depth_along_ray: optional (B, V, H, W, 1); needs calibration.
        ray_directions: optional (B, V, H, W, 3); excludes ``intrinsics``.
        camera_poses: optional (B, V, 4, 4) OpenCV cam2world in any
            consistent world frame (the model re-expresses them in view 0's);
            excludes ``camera_pose_quats``/``camera_pose_trans``.
        is_metric_scale: optional (B, V) bool; all True when not given.

    Raises:
        ValueError: for the five conflicting or incomplete combinations.
    """
    B, V, H, W, _ = images.shape
    if intrinsics is not None and ray_directions is not None:
        raise ValueError("provide either intrinsics or ray_directions, not both")
    if depth_z is not None and intrinsics is None:
        raise ValueError("depth_z input requires intrinsics (calibration)")
    if depth_along_ray is not None and intrinsics is None and ray_directions is None:
        raise ValueError("depth_along_ray requires intrinsics or ray_directions")
    if camera_pose_quats is not None and camera_poses is not None:
        raise ValueError("provide either camera_poses or quats/trans, not both")
    if depth_z is not None and depth_along_ray is not None:
        raise ValueError("provide either depth_z or depth_along_ray, not both")

    norm = IMAGE_NORMALIZATION_DICT[data_norm_type]
    img = (images - images.new_tensor(norm.mean)) / images.new_tensor(norm.std)

    rays = ray_directions
    if intrinsics is not None:
        _, rays = rays_in_camera_frame(intrinsics, H, W, normalize_to_unit_sphere=True)

    d_along = depth_along_ray
    if depth_z is not None:
        if depth_z.dim() == 5:
            depth_z = depth_z[..., 0]
        d_along = convert_z_depth_to_depth_along_ray(depth_z, intrinsics)[..., None]

    quats, trans = camera_pose_quats, camera_pose_trans
    if camera_poses is not None:
        quats, trans = pose_matrix_to_quats_trans(camera_poses)

    if is_metric_scale is None:
        is_metric_scale = torch.ones((B, V), dtype=torch.bool, device=images.device)

    return Views(
        img=img,
        ray_directions=rays,
        depth_along_ray=d_along,
        camera_pose_quats=quats,
        camera_pose_trans=trans,
        is_metric_scale=is_metric_scale,
    )


def _per_image_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile ``q`` of each (B, V) image of x (B, V, H, W) over its pixels,
    (B, V, 1, 1), by linear interpolation between the sorted values, with
    the position q·(n − 1) taken in fp32 as ``jnp.quantile`` takes it."""
    b, v, h, w = x.shape
    n = h * w
    srt = torch.sort(x.reshape(b, v, n), dim=-1).values
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = pos - low
    low_value = srt[..., int(low.clamp(0, n - 1))]
    high_value = srt[..., int(high.clamp(0, n - 1))]
    out = low_value * (1 - high_weight).item() + high_value * high_weight.item()
    return out.to(x.dtype)[..., None, None]


def postprocess_model_outputs_for_inference(
    preds: Predictions,
    views: Views,
    cfg: PostprocessConfig = PostprocessConfig(),
    data_norm_type: str = "dinov2",
) -> InferenceOutputs:
    """User-facing outputs and the combined validity mask: the non-ambiguous
    mask, optionally pixels above the per-image confidence percentile, less
    the pixels on both a depth edge and a normal edge."""
    norm = IMAGE_NORMALIZATION_DICT[data_norm_type]
    img_no_norm = views.img * views.img.new_tensor(norm.std) + views.img.new_tensor(norm.mean)
    if preds.rgb is not None:
        img_no_norm = preds.rgb

    depth_z = preds.pts3d_cam[..., 2:3]
    intrinsics = recover_pinhole_intrinsics_from_ray_directions(preds.ray_directions)
    camera_poses = quats_trans_to_pose_matrix(preds.cam_quats, preds.cam_trans)

    final_mask = None
    if cfg.apply_mask and preds.non_ambiguous_mask is not None:
        final_mask = preds.non_ambiguous_mask  # (B, V, H, W)

    if cfg.apply_confidence_mask and preds.conf is not None:
        thresh = _per_image_quantile(preds.conf, cfg.confidence_percentile / 100.0)
        conf_mask = preds.conf > thresh
        final_mask = conf_mask if final_mask is None else (final_mask & conf_mask)

    if cfg.apply_mask and cfg.mask_edges and final_mask is not None:
        normals, normals_mask = points_to_normals(preds.pts3d, final_mask)
        n_edge = normals_edge(normals, cfg.edge_normal_threshold, mask=normals_mask)
        d_edge = depth_edge(depth_z[..., 0], rtol=cfg.edge_depth_threshold, mask=final_mask)
        final_mask = final_mask & ~(d_edge & n_edge)

    pts3d, pts3d_cam, depth_along_ray = preds.pts3d, preds.pts3d_cam, preds.depth_along_ray
    mask_out = None
    if final_mask is not None:
        mask_out = final_mask[..., None]
        pts3d = pts3d * mask_out
        pts3d_cam = pts3d_cam * mask_out
        depth_along_ray = depth_along_ray * mask_out
        depth_z = depth_z * mask_out

    return InferenceOutputs(
        pts3d=pts3d,
        pts3d_cam=pts3d_cam,
        ray_directions=preds.ray_directions,
        depth_along_ray=depth_along_ray,
        depth_z=depth_z,
        intrinsics=intrinsics,
        camera_poses=camera_poses,
        cam_trans=preds.cam_trans,
        cam_quats=preds.cam_quats,
        metric_scaling_factor=preds.metric_scaling_factor,
        img_no_norm=img_no_norm,
        conf=preds.conf,
        mask=mask_out,
        non_ambiguous_mask=preds.non_ambiguous_mask,
    )


def _on(x, device: torch.device) -> torch.Tensor:
    """``x`` (tensor or array) as a tensor on ``device``; floats as fp32."""
    t = torch.as_tensor(x, device=device)
    return t.float() if t.is_floating_point() else t


def infer(
    model,
    images,
    postprocess_cfg: PostprocessConfig = PostprocessConfig(),
    data_norm_type: str = "dinov2",
    **modalities,
) -> InferenceOutputs:
    """One call from images (and optional modalities) to postprocessed outputs.

    ``images`` (B, V, H, W, 3) in [0, 1] and the ``modalities`` (the keyword
    arguments of ``preprocess_inputs_for_inference``: intrinsics, depth_z,
    camera_poses, ...) are tensors or arrays; they move to ``model.device``,
    floats as fp32. The forward runs under ``torch.inference_mode()`` and
    the outputs stay on the model's device. Modalities given to a model
    built without ``geometric_inputs=True`` raise ``ValueError``.
    """
    device = resolve_device(model.device)
    moved = {name: None if x is None else _on(x, device) for name, x in modalities.items()}
    with torch.inference_mode():
        views = preprocess_inputs_for_inference(_on(images, device), data_norm_type=data_norm_type, **moved)
        preds = model(views)
        return postprocess_model_outputs_for_inference(preds, views, postprocess_cfg, data_norm_type)
