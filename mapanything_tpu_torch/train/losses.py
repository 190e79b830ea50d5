"""The training losses of the port.

Counterpart of ``mapanything_tpu/train/losses.py``: ``LossBatch``,
``LossConfig``, ``masked_mean``, ``robust_regression_distance``,
``bce_with_logits``, ``compute_normal_loss``,
``compute_gradient_matching_loss``, ``exclude_top_n_percent_mean`` and
``factored_geometry_scale_loss`` (:59-472): the factored-geometry regression
with confidence weighting, top-N% exclusion on real data, the scale loss,
normal and gradient-matching terms on synthetic data, the RGB L1 of the
RGB-prediction models where a ``target_rgb`` is given, and the
non-ambiguous-mask BCE. One function over stacked (B, V, ...) tensors; every
reduction is a mask-weighted mean, and the top-N% exclusion sorts each image's
pixels. Also ``disentangled_factored_geometry_scale_loss`` (:475, taken when
``cfg.disentangled``), ``l1_distance``, ``l2_distance``,
``dust3r_regr3d_conf_loss`` (:590-639) and ``rgb_perception_loss`` (:642-682,
over the port's ``VGG19Features``).

Under view parallelism (an optional view group) each rank passes its block
of views. Every term but the scale loss is a sum over views of per-view
means, so it splits into one part a rank; the GT pose frame comes from view
0 by broadcast, and the joint point-cloud normalisers all-reduce their sums
over views. The scale loss is replicated and counts on the first rank only.

Under data parallelism (an optional data group: the ranks that hold the
same views of the other samples of the global batch) each rank passes its
block of samples. Every mean over the batch axis is a ratio of a sum over
samples and a count (of valid pixels, kept pixels, metric samples, views
with valid depth, samples): the counts, which carry no gradient, are summed
over the data group, and each rank's part is its own sum over that global
count. A mean of per-shard means would weigh a shard by its samples' counts
wrongly.

Each rank then returns its part of the loss and of each detail: their sum
over the ranks of the (data, view) group is the unsharded value on the
global batch. The disentangled loss splits the same way: its four point-map
terms are per-view masked means summed over views, its scale term is the
production loss's, and its GT frame and normaliser come from the same
broadcast and all-reduced sums.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mapanything_tpu_torch.geometry.camera import pointmap_from_rays_depth_pose
from mapanything_tpu_torch.geometry.normalization import (
    apply_log_to_norm,
    normalize_pointcloud,
    safe_norm,
)
from mapanything_tpu_torch.geometry.quaternion import (
    quat_inverse,
    quat_rotate,
    relative_pose_quats_trans,
)
from mapanything_tpu_torch.models.mapanything import Predictions
from mapanything_tpu_torch.models.perceptual import VGG19Features, perceptual_distance
from mapanything_tpu_torch.parallel.mesh import ViewGroup, all_reduce, broadcast_first


@dataclass
class LossBatch:
    """Ground truth for the loss, stacked (B, V, ...)."""

    pts3d: torch.Tensor  # (B, V, H, W, 3) world frame
    pts3d_cam: torch.Tensor  # (B, V, H, W, 3)
    depth_along_ray: torch.Tensor  # (B, V, H, W, 1)
    ray_directions: torch.Tensor  # (B, V, H, W, 3)
    camera_pose_quats: torch.Tensor  # (B, V, 4) cam2world XYZW
    camera_pose_trans: torch.Tensor  # (B, V, 3)
    valid_mask: torch.Tensor  # (B, V, H, W) bool
    non_ambiguous_mask: torch.Tensor  # (B, V, H, W) bool
    valid_non_ambiguous_mask: torch.Tensor  # (B, V, H, W) bool
    is_metric_scale: torch.Tensor  # (B,) bool
    is_synthetic: torch.Tensor  # (B,) bool
    target_rgb: Optional[torch.Tensor] = None  # (B, V, H, W, 3) in [0, 1], the RGB models' target

    def to(self, device) -> "LossBatch":
        return LossBatch(**{f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
                            for f in fields(self)})


def synthetic_loss_batch(B: int, V: int, H: int, W: int, seed: int = 0) -> LossBatch:
    """The benchmark's ground truth (bench.py ``_make_loss_batch``, :128-153),
    drawn with numpy from ``seed``: random points, unit rays facing +z,
    depths in [1, 5), random unit poses, every pixel valid, metric and real."""
    rng = np.random.RandomState(seed)
    dirs = rng.randn(B, V, H, W, 3).astype(np.float32)
    dirs[..., 2] = np.abs(dirs[..., 2]) + 0.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    quats = rng.randn(B, V, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    t = torch.from_numpy
    ones = torch.ones((B, V, H, W), dtype=torch.bool)
    return LossBatch(
        pts3d=t(rng.randn(B, V, H, W, 3).astype(np.float32)),
        pts3d_cam=t(rng.randn(B, V, H, W, 3).astype(np.float32)),
        depth_along_ray=t(rng.uniform(1, 5, (B, V, H, W, 1)).astype(np.float32)),
        ray_directions=t(dirs),
        camera_pose_quats=t(quats),
        camera_pose_trans=t(rng.randn(B, V, 3).astype(np.float32)),
        valid_mask=ones,
        non_ambiguous_mask=ones,
        valid_non_ambiguous_mask=ones,
        is_metric_scale=torch.ones((B,), dtype=torch.bool),
        is_synthetic=torch.zeros((B,), dtype=torch.bool),
    )


@dataclass(frozen=True)
class LossConfig:
    """Production loss hyperparameters (configs/loss/overall_loss.yaml)."""

    criterion: str = "robust"  # robust | l1 | l2
    disentangled: bool = False
    robust_alpha: float = 0.5
    robust_scaling_c: float = 0.05
    norm_mode: str = "avg_dis"
    loss_in_log: bool = True
    conf_alpha: float = 0.2
    top_n_percent: float = 5.0
    apply_exclusion_to_real_data_only: bool = True
    normal_loss_weight: float = 3.0
    gm_loss_weight: float = 3.0
    gm_scales: int = 4
    apply_normal_gm_to_synthetic_only: bool = True
    mask_loss_weight: float = 0.3
    rgb_loss_weight: float = 1.0  # the RGB models' L1 term
    world_points_weight: float = 1.0
    cam_points_weight: float = 1.0
    depth_weight: float = 1.0
    ray_directions_weight: float = 1.0
    pose_quats_weight: float = 1.0
    pose_trans_weight: float = 1.0
    scale_weight: float = 1.0


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None, data_group: Optional[ViewGroup] = None) -> torch.Tensor:
    """Mean of x over mask == True along ``dim`` (all dims when None); 0 when empty.
    With a ``data_group`` (``dim`` then covers the batch axis), this rank's part: its
    sum over the count summed over the group."""
    kept = torch.where(mask, x, torch.zeros_like(x))
    if dim is None:
        return kept.sum() / torch.clamp(global_count(mask.sum(), data_group), min=1)
    return kept.sum(dim=dim) / torch.clamp(global_count(mask.sum(dim=dim), data_group), min=1)


def global_count(count: torch.Tensor, data_group: Optional[ViewGroup]) -> torch.Tensor:
    """A count over this rank's samples summed over the data group (as it is without one)."""
    return count if data_group is None else all_reduce(count.detach(), data_group)


def robust_regression_distance(a: torch.Tensor, b: torch.Tensor, alpha: float, scaling_c: float) -> torch.Tensor:
    """Barron's general robust loss (arXiv:1701.03077), reducing the channel dim."""
    err = torch.sum(torch.square((a - b) / scaling_c), dim=-1)
    am2 = abs(alpha - 2)
    return (am2 / alpha) * (torch.pow(err / am2 + 1.0, alpha / 2) - 1.0)


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy with logits, per element."""
    return torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))


def _smooth_l1_angle(err: torch.Tensor, beta: float) -> torch.Tensor:
    return torch.where(err < beta, 0.5 * torch.square(err) / beta, err - 0.5 * beta)


def _angle_diff(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    cross = safe_norm(torch.linalg.cross(v1, v2, dim=-1), dim=-1)
    return torch.atan2(cross, torch.sum(v1 * v2, dim=-1) + eps)


def compute_normal_loss(points: torch.Tensor, gt_points: torch.Tensor, mask: torch.Tensor,
                        data_group: Optional[ViewGroup] = None) -> torch.Tensor:
    """Quad-cross-product normal consistency (MoGe). points (..., H, W, 3), mask (..., H, W);
    with a ``data_group``, this rank's part (``masked_mean``)."""
    lu, ru = points[..., :-1, :-1, :], points[..., :-1, 1:, :]
    ld, rd = points[..., 1:, :-1, :], points[..., 1:, 1:, :]
    glu, gru = gt_points[..., :-1, :-1, :], gt_points[..., :-1, 1:, :]
    gld, grd = gt_points[..., 1:, :-1, :], gt_points[..., 1:, 1:, :]
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)  # noqa: E731
    crosses = [
        (cross(ru - rd, ld - rd), cross(gru - grd, gld - grd)),
        (cross(lu - ru, rd - ru), cross(glu - gru, grd - gru)),
        (cross(ld - lu, ru - lu), cross(gld - glu, gru - glu)),
        (cross(rd - ld, lu - ld), cross(grd - gld, glu - gld)),
    ]
    m_lu, m_ru = mask[..., :-1, :-1], mask[..., :-1, 1:]
    m_ld, m_rd = mask[..., 1:, :-1], mask[..., 1:, 1:]
    quad_masks = [m_ru & m_ld & m_rd, m_lu & m_rd & m_ru, m_ld & m_ru & m_lu, m_rd & m_lu & m_ld]
    min_a, max_a, beta = math.radians(1), math.radians(90), math.radians(3)
    loss = 0.0
    for (pred_n, gt_n), qm in zip(crosses, quad_masks):
        ang = torch.clamp(_angle_diff(pred_n, gt_n), min_a, max_a)
        loss = loss + qm * _smooth_l1_angle(ang, beta)
    count = global_count(torch.sum(quad_masks[0] | quad_masks[1] | quad_masks[2] | quad_masks[3]), data_group)
    denom = torch.clamp(count, min=1) * (4 * max(points.shape[-3:-1]))
    total = torch.sum(loss) / denom
    return torch.where(count > 0, total, torch.zeros_like(total))


def compute_gradient_matching_loss(
    prediction: torch.Tensor, gt_target: torch.Tensor, mask: torch.Tensor, scales: int = 4,
    data_group: Optional[ViewGroup] = None,
) -> torch.Tensor:
    """Multi-scale gradient matching (MiDaS eq. 11). prediction, gt (B, H, W, C); mask (B, H, W);
    with a ``data_group``, this rank's part (``masked_mean``)."""

    def one_scale(pred, gt, m):
        m = m[..., None]
        diff = torch.where(m, pred - gt, torch.zeros_like(pred))
        gx = torch.abs(diff[:, :, 1:] - diff[:, :, :-1]) * (m[:, :, 1:] & m[:, :, :-1])
        gy = torch.abs(diff[:, 1:, :] - diff[:, :-1, :]) * (m[:, 1:, :] & m[:, :-1, :])
        total = torch.clamp(gx, max=100.0).sum() + torch.clamp(gy, max=100.0).sum()
        count = global_count(m.sum(), data_group)
        out = total / torch.clamp(count, min=1)
        return torch.where(count > 0, out, torch.zeros_like(out))

    loss = 0.0
    for s in range(scales):
        step = 2**s
        loss = loss + one_scale(
            prediction[:, ::step, ::step], gt_target[:, ::step, ::step], mask[:, ::step, ::step]
        )
    return loss


def _keep_lowest(loss: torch.Tensor, valid: torch.Tensor, percent: float):
    """Rows sorted with +inf at invalid entries, and the keep mask of the
    lowest floor(valid · percent / 100) entries of each row."""
    num_valid = valid.sum(dim=1)
    num_keep = torch.floor(num_valid * percent / 100.0).long()
    sorted_loss = torch.sort(torch.where(valid, loss, torch.full_like(loss, math.inf)), dim=1).values
    keep = torch.arange(loss.shape[1], device=loss.device)[None, :] < num_keep[:, None]
    return sorted_loss, keep, num_valid, num_keep


def exclude_top_n_percent_mean(
    loss: torch.Tensor, valid: torch.Tensor, bottom_percent: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row mean over the lowest ``bottom_percent``% of valid entries of
    loss (R, N); returns (mean (R,), has-any-kept (R,) bool)."""
    sorted_loss, keep, _, num_keep = _keep_lowest(loss, valid, bottom_percent)
    kept = torch.where(keep, sorted_loss, torch.zeros_like(sorted_loss))
    return masked_mean(kept, keep, dim=1), num_keep > 0


def _criterion(cfg: LossConfig):
    if cfg.criterion == "robust":
        return lambda a, b: robust_regression_distance(a, b, cfg.robust_alpha, cfg.robust_scaling_c)
    if cfg.criterion == "l1":
        return l1_distance
    if cfg.criterion == "l2":
        return l2_distance
    raise ValueError(f"unknown criterion {cfg.criterion}")


def factored_geometry_scale_loss(
    batch: LossBatch, preds: Predictions, cfg: LossConfig = LossConfig(),
    group: Optional[ViewGroup] = None, data_group: Optional[ViewGroup] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full production loss: (scalar, details). Loss sets: 0 world points
    (confidence-weighted), 1 camera points and 2 depth (top-N% excluded on
    real data), 3 ray directions, 4 pose quaternions, 5 pose translations,
    6 scale; then the normal, gradient-matching, RGB (where ``preds.rgb`` and
    ``batch.target_rgb`` are both given) and mask terms. With a view ``group``
    and/or a ``data_group``: this rank's part of each (see the module's
    docstring). ``cfg.disentangled`` takes the disentangled loss instead."""
    if cfg.disentangled:
        return disentangled_factored_geometry_scale_loss(batch, preds, cfg, group, data_group)
    B, V, H, W, _ = batch.pts3d.shape
    P = H * W
    crit = _criterion(cfg)
    dg = data_group
    valid = batch.valid_mask

    # Ground truth in view 0's frame.
    quats, trans = batch.camera_pose_quats, batch.camera_pose_trans
    q0, t0 = quats[:, :1], trans[:, :1]
    if group is not None:  # view 0 lives on the first rank
        q0, t0 = broadcast_first(q0, group), broadcast_first(t0, group)
    gt_quats, gt_trans = relative_pose_quats_trans(q0.expand_as(quats), t0.expand_as(trans), quats, trans)
    inv_q0 = quat_inverse(q0[:, 0])
    gt_pts_v0 = quat_rotate(inv_q0[:, None, None, None, :], batch.pts3d - t0[:, 0][:, None, None, None, :])

    # Predictions without the metric factor.
    s = preds.metric_scaling_factor
    s5 = s[:, None, None, None, None]
    pr_pts = preds.pts3d / s5
    pr_pts_cam = preds.pts3d_cam / s5
    pr_depth = preds.depth_along_ray / s5
    pr_trans = preds.cam_trans / s[:, None, None]

    # Joint multi-view normalisation, independently for GT and prediction.
    gt_pts_n, gt_nf = normalize_pointcloud(gt_pts_v0, valid, cfg.norm_mode, True, group)
    gt_nf_s = gt_nf.reshape(B)
    gt_pts_cam_n = batch.pts3d_cam / gt_nf
    gt_depth_n = batch.depth_along_ray / gt_nf
    gt_trans_n = gt_trans / gt_nf_s[:, None, None]
    pr_pts_n, pr_nf = normalize_pointcloud(pr_pts, valid, cfg.norm_mode, True, group)
    pr_nf_s = pr_nf.reshape(B)
    pr_pts_cam_n = pr_pts_cam / pr_nf
    pr_depth_n = pr_depth / pr_nf
    pr_trans_n = pr_trans / pr_nf_s[:, None, None]

    # The predicted metric norm factor: the geometry held fixed, times the scale.
    _, pr_metric_nf = normalize_pointcloud(pr_pts.detach() * s5, valid, cfg.norm_mode, True, group)
    pr_metric_nf_s = pr_metric_nf.reshape(B)
    metric_sample = batch.is_metric_scale & (gt_nf_s > 1e-8)

    if cfg.loss_in_log:
        gt_depth_l, pr_depth_l = apply_log_to_norm(gt_depth_n), apply_log_to_norm(pr_depth_n)
        gt_pts_cam_l, pr_pts_cam_l = apply_log_to_norm(gt_pts_cam_n), apply_log_to_norm(pr_pts_cam_n)
        gt_pts_l, pr_pts_l = apply_log_to_norm(gt_pts_n), apply_log_to_norm(pr_pts_n)
    else:
        gt_depth_l, pr_depth_l = gt_depth_n, pr_depth_n
        gt_pts_cam_l, pr_pts_cam_l = gt_pts_cam_n, pr_pts_cam_n
        gt_pts_l, pr_pts_l = gt_pts_n, pr_pts_n

    flat = lambda x: x.reshape(B, V, P, x.shape[-1])  # noqa: E731
    valid_flat = valid.reshape(B, V, P)
    pts3d_pix = crit(flat(pr_pts_l), flat(gt_pts_l)) * cfg.world_points_weight
    cam_pts_pix = crit(flat(pr_pts_cam_l), flat(gt_pts_cam_l)) * cfg.cam_points_weight
    depth_pix = crit(flat(pr_depth_l), flat(gt_depth_l)) * cfg.depth_weight
    rays_pix = crit(flat(preds.ray_directions), flat(batch.ray_directions)) * cfg.ray_directions_weight
    quats_loss = torch.minimum(crit(preds.cam_quats, gt_quats), crit(preds.cam_quats, -gt_quats))
    quats_loss = quats_loss * cfg.pose_quats_weight  # (B, V), the double cover by min(+q, -q)
    trans_loss = crit(pr_trans_n, gt_trans_n) * cfg.pose_trans_weight  # (B, V)
    view_has_valid = valid_flat.sum(dim=2) > 0

    # Each (set, view) term is a pixel-weighted mean; sets sum their views.
    details: Dict[str, torch.Tensor] = {}
    conf = preds.conf.reshape(B, V, P)
    conf_weighted = pts3d_pix * conf - cfg.conf_alpha * torch.log(conf)
    details["pts3d_conf_loss"] = masked_mean(conf_weighted, valid_flat, dim=(0, 2), data_group=dg).sum()

    def excluded_view_sum(pix_loss):
        # Per view: the mean over all synthetic pixels and the lowest
        # (100 - top_n)% of each real image's pixels.
        rows, vrows = pix_loss.reshape(B * V, P), valid_flat.reshape(B * V, P)
        sorted_loss, keep, num_valid, num_keep = _keep_lowest(rows, vrows, 100.0 - cfg.top_n_percent)
        lowest_sum = torch.where(keep, sorted_loss, torch.zeros_like(sorted_loss)).sum(dim=1)
        if cfg.apply_exclusion_to_real_data_only:
            synth = batch.is_synthetic[:, None].expand(B, V).reshape(B * V)
            kept_sum = torch.where(synth, torch.where(vrows, rows, torch.zeros_like(rows)).sum(dim=1), lowest_sum)
            kept_cnt = torch.where(synth, num_valid, num_keep)
        else:
            kept_sum, kept_cnt = lowest_sum, num_keep
        view_cnt = global_count(kept_cnt.reshape(B, V).sum(dim=0), dg)
        view_mean = kept_sum.reshape(B, V).sum(dim=0) / torch.clamp(view_cnt, min=1)
        return view_mean.sum()

    every = lambda x: torch.ones(x.shape, dtype=torch.bool, device=x.device)  # noqa: E731  (plain means)
    details["cam_pts3d_loss"] = excluded_view_sum(cam_pts_pix)
    details["depth_loss"] = excluded_view_sum(depth_pix)
    details["ray_dirs_loss"] = masked_mean(rays_pix, every(rays_pix), dim=(0, 2), data_group=dg).sum()
    details["pose_quats_loss"] = masked_mean(quats_loss, every(quats_loss), dim=0, data_group=dg).sum()
    details["pose_trans_loss"] = masked_mean(trans_loss, view_has_valid, dim=0, data_group=dg).sum()

    if cfg.loss_in_log:
        gt_sc, pr_sc = torch.log1p(gt_nf_s)[:, None], torch.log1p(pr_metric_nf_s)[:, None]
    else:
        gt_sc, pr_sc = gt_nf_s[:, None], pr_metric_nf_s[:, None]
    details["scale_loss"] = masked_mean(crit(pr_sc, gt_sc) * cfg.scale_weight, metric_sample, data_group=dg)
    if group is not None and group.rank != 0:
        details["scale_loss"] = details["scale_loss"] * 0.0  # replicated: counted on the first rank

    # Normal and gradient-matching terms (synthetic data only in production),
    # per-view scalars summed over the views.
    ngm_mask = valid
    if cfg.apply_normal_gm_to_synthetic_only:
        ngm_mask = ngm_mask & batch.is_synthetic[:, None, None, None]
    pr_z = apply_log_to_norm(pr_pts_cam_n[..., 2:])
    gt_z = apply_log_to_norm(gt_pts_cam_n[..., 2:])
    normal = sum(compute_normal_loss(pr_pts_cam_n[:, v], gt_pts_cam_n[:, v], ngm_mask[:, v], dg) for v in range(V))
    gm = sum(compute_gradient_matching_loss(pr_z[:, v], gt_z[:, v], ngm_mask[:, v], cfg.gm_scales, dg)
             for v in range(V))
    details["normal_loss"] = normal * cfg.normal_loss_weight
    details["gm_loss"] = gm * cfg.gm_loss_weight

    total = (
        details["pts3d_conf_loss"] + details["cam_pts3d_loss"] + details["depth_loss"]
        + details["ray_dirs_loss"] + details["pose_quats_loss"] + details["pose_trans_loss"]
        + details["scale_loss"] + details["normal_loss"] + details["gm_loss"]
    )
    # The RGB models' colour regression: per view, the masked L1 of the predicted
    # colours (in [0, 1]) against the target image over the valid pixels.
    if preds.rgb is not None and batch.target_rgb is not None:
        rgb_l1 = torch.abs(preds.rgb - batch.target_rgb).sum(dim=-1)
        details["rgb_loss"] = masked_mean(rgb_l1, valid, dim=(0, 2, 3), data_group=dg).sum()
        total = total + cfg.rgb_loss_weight * details["rgb_loss"]
    total = total + _mask_loss(batch, preds, cfg, details, dg)
    details["total_loss"] = total
    return total, details


def _mask_loss(batch: LossBatch, preds: Predictions, cfg: LossConfig, details: dict,
               data_group: Optional[ViewGroup] = None):
    """The weighted non-ambiguous-mask BCE (0 without mask logits); its unweighted
    value goes into ``details["mask_loss"]``."""
    if preds.non_ambiguous_mask_logits is None:
        return 0.0
    bce = bce_with_logits(preds.non_ambiguous_mask_logits, batch.non_ambiguous_mask.float())
    details["mask_loss"] = masked_mean(bce, batch.valid_non_ambiguous_mask, dim=(0, 2, 3), data_group=data_group).sum()
    return cfg.mask_loss_weight * details["mask_loss"]


def disentangled_factored_geometry_scale_loss(
    batch: LossBatch, preds: Predictions, cfg: LossConfig = LossConfig(),
    group: Optional[ViewGroup] = None, data_group: Optional[ViewGroup] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The disentangled ablation of the production loss: (scalar, details).

    Each factor's term compares view 0's-frame world pointmaps built with that
    factor predicted and the others from the ground truth (depth, ray directions,
    pose quaternions, pose translations); the scale term and the mask BCE are the
    production loss's. The same criterion, normalisation and log-space switches.
    With a view ``group`` and/or a ``data_group``: this rank's part of each, as the
    production loss splits its terms (see the module's docstring).
    """
    B = batch.pts3d.shape[0]
    crit = _criterion(cfg)
    dg = data_group
    valid = batch.valid_mask
    quats, trans = batch.camera_pose_quats, batch.camera_pose_trans
    q0, t0 = quats[:, :1], trans[:, :1]
    if group is not None:  # view 0 lives on the first rank
        q0, t0 = broadcast_first(q0, group), broadcast_first(t0, group)
    gt_quats, gt_trans = relative_pose_quats_trans(q0.expand_as(quats), t0.expand_as(trans), quats, trans)
    sc = preds.metric_scaling_factor
    s5 = sc[:, None, None, None, None]
    pr_depth = preds.depth_along_ray / s5
    pr_trans = preds.cam_trans / sc[:, None, None]

    inv_q0 = quat_inverse(q0[:, 0])
    gt_pts_v0 = quat_rotate(inv_q0[:, None, None, None, :], batch.pts3d - t0[:, 0][:, None, None, None, :])
    gt_pts_n, gt_nf = normalize_pointcloud(gt_pts_v0, valid, cfg.norm_mode, True, group)
    gt_nf_s = gt_nf.reshape(B)
    gt_trans_n = gt_trans / gt_nf_s[:, None, None]
    gt_depth_n = batch.depth_along_ray / gt_nf
    gt_rays = batch.ray_directions
    log = apply_log_to_norm if cfg.loss_in_log else (lambda x: x)

    def pointmap_term(rays, depth_n, trans_n, quats_):
        pts = pointmap_from_rays_depth_pose(rays, depth_n, trans_n, quats_)
        return masked_mean(crit(log(pts), log(gt_pts_n)), valid, dim=(0, 2, 3), data_group=dg).sum()

    details: Dict[str, torch.Tensor] = {
        "depth_loss": pointmap_term(gt_rays, pr_depth / gt_nf, gt_trans_n, gt_quats) * cfg.depth_weight,
        "ray_dirs_loss": pointmap_term(preds.ray_directions, gt_depth_n, gt_trans_n, gt_quats)
        * cfg.ray_directions_weight,
        "pose_quats_loss": pointmap_term(gt_rays, gt_depth_n, gt_trans_n, preds.cam_quats) * cfg.pose_quats_weight,
        "pose_trans_loss": pointmap_term(gt_rays, gt_depth_n, pr_trans / gt_nf_s[:, None, None], gt_quats)
        * cfg.pose_trans_weight,
    }
    total = details["depth_loss"] + details["ray_dirs_loss"] + details["pose_quats_loss"] + details["pose_trans_loss"]

    # The scale term, as the production loss's set 6.
    pr_pts = preds.pts3d / s5
    _, pr_metric_nf = normalize_pointcloud(pr_pts.detach() * s5, valid, cfg.norm_mode, True, group)
    pr_metric_nf_s = pr_metric_nf.reshape(B)
    metric_sample = batch.is_metric_scale & (gt_nf_s > 1e-8)
    if cfg.loss_in_log:
        gt_sc, pr_sc = torch.log1p(gt_nf_s)[:, None], torch.log1p(pr_metric_nf_s)[:, None]
    else:
        gt_sc, pr_sc = gt_nf_s[:, None], pr_metric_nf_s[:, None]
    details["scale_loss"] = masked_mean(crit(pr_sc, gt_sc) * cfg.scale_weight, metric_sample, data_group=dg)
    if group is not None and group.rank != 0:
        details["scale_loss"] = details["scale_loss"] * 0.0  # replicated: counted on the first rank
    total = total + details["scale_loss"] + _mask_loss(batch, preds, cfg, details, dg)
    details["total_loss"] = total
    return total, details


# ---------------------------------------------------------------- the simpler losses


def l1_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L1 distance: per-element |a - b| summed over the channels."""
    return torch.sum(torch.abs(a - b), dim=-1)


def l2_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L2 distance: the Euclidean norm of a - b over the channels."""
    return safe_norm(a - b, dim=-1)


def dust3r_regr3d_conf_loss(
    gt_pts3d: torch.Tensor,
    gt_valid: torch.Tensor,
    gt_pose0: Tuple[torch.Tensor, torch.Tensor],
    pred_pts3d: torch.Tensor,
    pred_conf: torch.Tensor,
    conf_alpha: float = 0.2,
    norm_mode: str = "avg_dis",
    loss_in_log: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """DUSt3R's Regr3D with its confidence loss: (scalar, details).

    The ground truth (world points, cam2world pose of view 0 as (quats (B, 4),
    trans (B, 3))) goes into view 0's frame; it and the predictions (already in
    that frame) are normalised independently by ``norm_mode``, compared by L2
    distance and confidence-weighted (loss · conf - alpha · log conf); per-view
    masked means summed over the views. gt_pts3d, pred_pts3d (B, V, H, W, 3);
    gt_valid, pred_conf (B, V, H, W).
    """
    q0, t0 = gt_pose0
    gt_v0 = quat_rotate(quat_inverse(q0)[:, None, None, None, :], gt_pts3d - t0[:, None, None, None, :])
    gt_n, _ = normalize_pointcloud(gt_v0, gt_valid, norm_mode, True)
    pr_n, _ = normalize_pointcloud(pred_pts3d, gt_valid, norm_mode, True)
    if loss_in_log:
        gt_n, pr_n = apply_log_to_norm(gt_n), apply_log_to_norm(pr_n)
    pix = l2_distance(pr_n, gt_n)
    conf_weighted = pix * pred_conf - conf_alpha * torch.log(pred_conf)
    total = masked_mean(conf_weighted, gt_valid, dim=(0, 2, 3)).sum()
    return total, {"regr3d_conf_loss": total, "regr3d_l2": masked_mean(pix, gt_valid)}


def rgb_perception_loss(
    vgg: VGG19Features,
    pred_rgb: torch.Tensor,
    gt_rgb: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The RGB models' VGG19 perceptual loss: (scalar, details).

    Per view, the prediction and the target (RGB in [0, 1], (B, V, H, W, 3)) go
    through the frozen ``vgg`` (``models.perceptual.VGG19Features``, in its
    compute dtype) and are compared at the pixels and the five taps with the
    fixed per-level weights; each sample's distance is scaled by its valid-pixel
    fraction where ``valid`` (B, V, H, W) is given, then averaged over the samples
    and summed over the views.
    """
    B, V = pred_rgb.shape[:2]
    flat = lambda x: x.reshape((B * V,) + tuple(x.shape[2:]))  # noqa: E731
    dist = perceptual_distance(vgg(flat(pred_rgb)), vgg(flat(gt_rgb)))
    if valid is not None:
        dist = dist * flat(valid).float().mean(dim=(-2, -1))
    total = dist.reshape(B, V).mean(dim=0).sum()
    return total, {"rgb_perception": total}
