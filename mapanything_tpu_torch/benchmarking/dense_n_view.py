"""Dense up-to-N-view benchmark of the port: pointmap, depth, pose, ray and scale metrics.

Counterpart of ``mapanything_tpu/benchmarking/dense_n_view.py`` (:40-245). Per
multi-view set:
  - pointmaps_abs_rel / pointmaps_inlier_thres_103 (view 0's frame, the ground
    truth and the prediction each normalised by its mean distance, avg_dis);
  - z_depth_abs_rel / z_depth_inlier_thres_103;
  - pose_ate_rmse (Horn-aligned) and pose_auc_5 (relative-pose AUC at 5 degrees);
  - ray_dirs_err_deg (unit-ray angular error);
  - metric_scale_abs_rel (predicted against ground-truth scene norm factor).

The normalisation runs in torch on the predictions' device in float32, as the
JAX module runs it in ``jnp``; only the per-set metric arithmetic goes to numpy
(``utils.metrics``). ``run_benchmark`` takes the model (an ``nn.Module`` that
holds its weights) in place of the JAX ``(model, params)``.

Two of the metrics are discontinuous: the inlier ratios count pixels under a
hard 1.03 ratio, and pose_auc_5 bins pair errors into 1-degree bins. Two runs
that agree to rounding can put a pixel or a pair on two sides of an edge;
``metric_edges`` counts, per set, the pixels and pairs within a margin of an
edge and turns them into how far each such metric may move.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mapanything_tpu_torch.geometry.normalization import normalize_pointcloud
from mapanything_tpu_torch.geometry.quaternion import (
    quat_inverse,
    quat_rotate,
    quats_trans_to_pose_matrix,
    relative_pose_quats_trans,
)
from mapanything_tpu_torch.models.mapanything import Predictions
from mapanything_tpu_torch.train.loop import loss_batch_from_numpy
from mapanything_tpu_torch.train.losses import LossBatch
from mapanything_tpu_torch.train.step import views_from_loss_batch
from mapanything_tpu_torch.utils.metrics import (
    calculate_auc,
    evaluate_ate,
    m_rel_ae,
    ray_angular_error_deg,
    se3_to_relative_pose_error,
    thresh_inliers,
)

METRIC_NAMES = (
    "metric_scale_abs_rel",
    "pointmaps_abs_rel",
    "pointmaps_inlier_thres_103",
    "pose_ate_rmse",
    "pose_auc_5",
    "z_depth_abs_rel",
    "z_depth_inlier_thres_103",
    "ray_dirs_err_deg",
)
INLIER_THRESH = 1.03
AUC_THRESHOLD_DEG = 5
# metric_edges' defaults: a pixel's norm ratio within this relative margin of 1.03,
# a pair's max(rotation, translation) error within this many degrees of a bin edge
# (the float32 rotation errors of two implementations differ by up to ~0.1 degree).
EDGE_RATIO_MARGIN = 1e-3
EDGE_DEG_MARGIN = 0.1


def _in_view0_frame(quats: torch.Tensor, trans: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """World points (B, V, H, W, 3) in view 0's camera frame."""
    inv_q0 = quat_inverse(quats[:, 0])
    return quat_rotate(inv_q0[:, None, None, None, :], pts - trans[:, 0][:, None, None, None, :])


def _poses_to_view0(quats: torch.Tensor, trans: torch.Tensor):
    """Each view's cam2world pose in view 0's frame: (quats, trans)."""
    return relative_pose_quats_trans(quats[:, :1].expand_as(quats), trans[:, :1].expand_as(trans), quats, trans)


def _normalized(pts_v0, pts3d_cam, quats, trans, valid):
    """Points, z-depth and 4x4 poses normalised by the set's avg_dis factor, on the
    tensors' device, and the factor (B,)."""
    B = pts_v0.shape[0]
    pts_n, nf = normalize_pointcloud(pts_v0, valid, "avg_dis", True)
    z = pts3d_cam[..., 2:3] / nf
    poses = quats_trans_to_pose_matrix(quats, trans / nf.reshape(B, 1, 1))
    return pts_n, z, poses, nf.reshape(B)


def set_arrays(batch: LossBatch, preds: Predictions) -> Dict[str, np.ndarray]:
    """The normalised ground truth and predictions of each set, as numpy float32
    (the JAX module's intermediate arrays): {gt,pr}_{pts,z,poses,nf}, the rays,
    the valid mask and the predicted metric scaling factor."""
    f = lambda x: x.float()  # noqa: E731
    gt_quats, gt_trans = _poses_to_view0(f(batch.camera_pose_quats), f(batch.camera_pose_trans))
    gt = _normalized(_in_view0_frame(f(batch.camera_pose_quats), f(batch.camera_pose_trans), f(batch.pts3d)),
                     f(batch.pts3d_cam), gt_quats, gt_trans, batch.valid_mask)
    # The model predicts in view 0's frame already; re-canonicalise anyway, as the
    # reference's pred_in_camera0 transform does.
    pr_quats, pr_trans = _poses_to_view0(f(preds.cam_quats), f(preds.cam_trans))
    pr = _normalized(_in_view0_frame(f(preds.cam_quats), f(preds.cam_trans), f(preds.pts3d)),
                     f(preds.pts3d_cam), pr_quats, pr_trans, batch.valid_mask)
    out = {f"{side}_{name}": x.cpu().numpy() for side, vals in (("gt", gt), ("pr", pr))
           for name, x in zip(("pts", "z", "poses", "nf"), vals)}
    out.update(gt_rays=f(batch.ray_directions).cpu().numpy(), pr_rays=f(preds.ray_directions).cpu().numpy(),
               valid=batch.valid_mask.cpu().numpy(), scale=f(preds.metric_scaling_factor).cpu().numpy())
    return out


def compute_set_metrics(batch: LossBatch, preds: Predictions) -> List[Dict[str, float]]:
    """Metrics of each multi-view set in the batch: a list of B dicts."""
    a = set_arrays(batch, preds)
    B, V = a["valid"].shape[:2]
    results = []
    for b in range(B):
        pm_rel, pm_inl, z_rel, z_inl, ray_err = [], [], [], [], []
        for v in range(V):
            m = a["valid"][b, v]
            pm_rel.append(m_rel_ae(a["gt_pts"][b, v], a["pr_pts"][b, v], mask=m))
            pm_inl.append(thresh_inliers(a["gt_pts"][b, v], a["pr_pts"][b, v], INLIER_THRESH, mask=m))
            z_rel.append(m_rel_ae(a["gt_z"][b, v], a["pr_z"][b, v], mask=m))
            z_inl.append(thresh_inliers(a["gt_z"][b, v], a["pr_z"][b, v], INLIER_THRESH, mask=m))
            l2 = np.linalg.norm(a["gt_rays"][b, v] - a["pr_rays"][b, v], axis=-1)
            ray_err.append(float(np.mean(ray_angular_error_deg(l2))))

        gt_poses, pr_poses = a["gt_poses"][b], a["pr_poses"][b]
        ate = evaluate_ate(gt_poses, pr_poses)
        r_err, t_err = se3_to_relative_pose_error(pr_poses, gt_poses, V)
        auc5, _ = calculate_auc(r_err, t_err, max_threshold=AUC_THRESHOLD_DEG)
        gt_nf, pr_nf = a["gt_nf"][b], a["pr_nf"][b]
        scale_abs_rel = float(np.abs(pr_nf * a["scale"][b] - gt_nf) / max(gt_nf, 1e-8))

        results.append({
            "metric_scale_abs_rel": scale_abs_rel,
            "pointmaps_abs_rel": float(np.nanmean(pm_rel)),
            "pointmaps_inlier_thres_103": float(np.nanmean(pm_inl)),
            "pose_ate_rmse": float(ate),
            "pose_auc_5": float(auc5 * 100.0),
            "z_depth_abs_rel": float(np.nanmean(z_rel)),
            "z_depth_inlier_thres_103": float(np.nanmean(z_inl)),
            "ray_dirs_err_deg": float(np.nanmean(ray_err)),
        })
    return results


def _inlier_edge_share(gt, pred, mask, margin: float) -> float:
    """The share of ``thresh_inliers``' valid pixels whose norm ratio lies within
    ``margin`` (relative) of the threshold, or NaN where the view has none valid."""
    gt_norm, pred_norm = np.linalg.norm(gt, axis=-1), np.linalg.norm(pred, axis=-1)
    valid = mask & (gt_norm > 0)
    if not valid.any():
        return np.nan
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.maximum(gt_norm / pred_norm, pred_norm / gt_norm)
    near = np.abs(ratio - INLIER_THRESH) <= margin * INLIER_THRESH
    return float(np.sum(near & valid) / np.sum(valid))


def metric_edges(batch: LossBatch, preds: Predictions, ratio_margin: float = EDGE_RATIO_MARGIN,
                 deg_margin: float = EDGE_DEG_MARGIN) -> List[Dict[str, float]]:
    """For each set, how far each discontinuous metric may move between two runs
    that agree to rounding: the counted pixels and pairs near an edge, each as the
    share of the metric that its flip moves. A pixel within ``ratio_margin`` of
    1.03 moves its view's inlier ratio by 1/(valid pixels), the set's mean by that
    over the views; a pair whose max(rotation, translation) error lies within
    ``deg_margin`` degrees of a bin edge 1..5 moves pose_auc_5 by 100/(5 pairs).
    Also ``pose_edge_pairs``, the count of such pairs."""
    a = set_arrays(batch, preds)
    B, V = a["valid"].shape[:2]
    edges = np.arange(1, AUC_THRESHOLD_DEG + 1)
    out = []
    for b in range(B):
        entry = {}
        for name, key in (("pointmaps_inlier_thres_103", "pts"), ("z_depth_inlier_thres_103", "z")):
            shares = [_inlier_edge_share(a[f"gt_{key}"][b, v], a[f"pr_{key}"][b, v], a["valid"][b, v], ratio_margin)
                      for v in range(V)]
            entry[name] = float(np.nanmean(shares)) if not np.all(np.isnan(shares)) else 0.0
        r_err, t_err = se3_to_relative_pose_error(a["pr_poses"][b], a["gt_poses"][b], V)
        worst = np.maximum(r_err, t_err)
        near = int(np.sum(np.min(np.abs(worst[:, None] - edges[None, :]), axis=1) <= deg_margin))
        entry["pose_auc_5"] = 100.0 * near / (AUC_THRESHOLD_DEG * max(len(worst), 1))
        entry["pose_edge_pairs"] = near
        out.append(entry)
    return out


def run_benchmark(model, data_loader, loss_batch_fn: Callable = loss_batch_from_numpy,
                  max_batches: Optional[int] = None, keep_rays: bool = False, keep_depth: bool = False,
                  keep_cam: bool = False, on_batch: Optional[Callable] = None) -> Dict[str, Dict[str, float]]:
    """Loop a test loader and aggregate the metrics by scene.

    Args:
        model: the MapAnything model (its weights and device its own).
        data_loader: yields collated numpy batches with a "label" list.
        loss_batch_fn: ``(numpy batch, device) -> LossBatch`` on the model's device
            (``train.loop.loss_batch_from_numpy``).
        keep_rays/keep_depth/keep_cam: which ground-truth modalities feed the model
            (the task presets: images_only none, calibrated_sfm rays, mvs rays and
            depth, posed_sfm rays and poses, ...); the model needs its geometric
            encoders (``geometric_inputs=True``) for any of them.
        on_batch: called as ``on_batch(index, batch, preds, set_metrics)`` after
            each batch (the parity checks hold on to predictions through it).

    Returns:
        {scene: {metric: mean over its sets}} and "overall", the mean over scenes.
    """
    device = model.device
    per_scene: Dict[str, Dict[str, list]] = {}
    with torch.inference_mode():
        for i, batch_np in enumerate(data_loader):
            if max_batches is not None and i >= max_batches:
                break
            batch = loss_batch_fn(batch_np, device=device)
            img = torch.as_tensor(np.asarray(batch_np["img"]), dtype=torch.float32).to(device)
            views = views_from_loss_batch(batch, img)
            views = dataclasses.replace(
                views,
                ray_directions=views.ray_directions if keep_rays else None,
                depth_along_ray=views.depth_along_ray if keep_depth else None,
                camera_pose_quats=views.camera_pose_quats if keep_cam else None,
                camera_pose_trans=views.camera_pose_trans if keep_cam else None,
            )
            preds = model(views)
            set_metrics = compute_set_metrics(batch, preds)
            if on_batch is not None:
                on_batch(i, batch, preds, set_metrics)
            labels = batch_np.get("label", [f"scene_{i}"] * len(set_metrics))
            for label, met in zip(labels, set_metrics):
                bucket = per_scene.setdefault(str(label), {k: [] for k in METRIC_NAMES})
                for k, val in met.items():
                    bucket[k].append(val)

    summary = {scene: {k: float(np.nanmean(v)) for k, v in buckets.items()} for scene, buckets in per_scene.items()}
    summary["overall"] = {k: float(np.nanmean([s[k] for s in summary.values()])) for k in METRIC_NAMES}
    return summary


def compute_set_metrics_global_pm_only(batch: LossBatch, pts3d_pred) -> List[Dict[str, float]]:
    """Pointmap-only variant, for baselines that predict only a global point cloud.

    ``pts3d_pred`` (B, V, H, W, 3): predicted points in any frame consistent across
    views (tensor or array); the ground truth goes to view 0's frame, and both are
    avg_dis-normalised.
    """
    f = lambda x: x.float()  # noqa: E731
    gt_v0 = _in_view0_frame(f(batch.camera_pose_quats), f(batch.camera_pose_trans), f(batch.pts3d))
    gt_n, _ = normalize_pointcloud(gt_v0, batch.valid_mask, "avg_dis", True)
    pr = torch.as_tensor(pts3d_pred).to(gt_v0.device, torch.float32)
    pr_n, _ = normalize_pointcloud(pr, batch.valid_mask, "avg_dis", True)
    gt_np, pr_np, valid = gt_n.cpu().numpy(), pr_n.cpu().numpy(), batch.valid_mask.cpu().numpy()
    B, V = valid.shape[:2]
    results = []
    for b in range(B):
        pm_rel = [m_rel_ae(gt_np[b, v], pr_np[b, v], mask=valid[b, v]) for v in range(V)]
        pm_inl = [thresh_inliers(gt_np[b, v], pr_np[b, v], INLIER_THRESH, mask=valid[b, v]) for v in range(V)]
        results.append({"pointmaps_abs_rel": float(np.nanmean(pm_rel)),
                        "pointmaps_inlier_thres_103": float(np.nanmean(pm_inl))})
    return results
