"""Benchmark metrics of the port: abs-rel, inliers, ATE (Horn), pose AUC, ray errors.

Counterpart of ``mapanything_tpu/utils/metrics.py`` (:18-159), host numpy as
there: the metrics run once per set on small arrays. The one step that is not
numpy is the rotation-matrix-to-quaternion conversion of ``rotation_angle_deg``:
the JAX module runs it through ``jnp`` with x64 off, so in float32, and a rotation
compared with itself reads up to ~0.06 degrees there, not 0. The port converts
through its own ``geometry.quaternion.rotmat_to_quat`` on a float32 tensor, the
same metric (float64 would be another); the two agree to ~0.1 degree, not to
1e-6, since the ops run in another order.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from mapanything_tpu_torch.geometry.quaternion import rotmat_to_quat


def valid_mean(arr, mask, axis=None):
    """Masked mean; returns (mean, is_valid)."""
    mask = mask.astype(arr.dtype) if mask.dtype == bool else mask
    num_valid = np.sum(mask, axis=axis)
    total = np.sum(arr * mask, axis=axis)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = total / num_valid
        is_valid = np.isfinite(mean)
        mean = np.nan_to_num(mean, nan=0, posinf=0, neginf=0)
    return mean, is_valid


def thresh_inliers(gt, pred, thresh=1.03, mask=None, output_scaling_factor=1.0):
    """Fraction of pixels whose norm ratio max(gt/pred, pred/gt) is below ``thresh``."""
    gt_norm = np.linalg.norm(gt, axis=-1)
    pred_norm = np.linalg.norm(pred, axis=-1)
    gt_valid = gt_norm > 0
    combined = (mask & gt_valid) if mask is not None else gt_valid
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_1 = np.nan_to_num(gt_norm / pred_norm, nan=thresh + 1, posinf=thresh + 1, neginf=thresh + 1)
        rel_2 = np.nan_to_num(pred_norm / gt_norm, nan=0, posinf=0, neginf=0)
    max_rel = np.maximum(rel_1, rel_2)
    inliers = ((0 < max_rel) & (max_rel < thresh)).astype(np.float32)
    ratio, valid = valid_mean(inliers, combined)
    return ratio * output_scaling_factor if valid else np.nan


def m_rel_ae(gt, pred, mask=None, output_scaling_factor=1.0):
    """Mean relative absolute error of the norm."""
    gt_norm = np.linalg.norm(gt, axis=-1)
    pred_norm = np.linalg.norm(pred, axis=-1)
    gt_valid = gt_norm > 0
    combined = (mask & gt_valid) if mask is not None else gt_valid
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_ae = np.nan_to_num(np.abs(gt_norm - pred_norm) / gt_norm, nan=0, posinf=0, neginf=0)
    mean, valid = valid_mean(rel_ae, combined)
    return mean * output_scaling_factor if valid else np.nan


def ray_angular_error_deg(l2_distance: np.ndarray) -> np.ndarray:
    """L2 distance between unit rays -> angular error in degrees."""
    return 2 * np.arcsin(np.clip(l2_distance / 2, -1, 1)) * 180.0 / math.pi


def horn_align(model: np.ndarray, data: np.ndarray):
    """Closed-form alignment of (3, N) point sets (Horn): (rot (3, 3), trans (3, 1),
    each point's translation error (N,))."""
    model_c = model - model.mean(1, keepdims=True)
    data_c = data - data.mean(1, keepdims=True)
    W = model_c @ data_c.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    aligned = rot @ model + trans
    err = np.sqrt(np.sum((aligned - data) ** 2, axis=0))
    return rot, trans, err


def evaluate_ate(gt_traj: np.ndarray, est_traj: np.ndarray) -> float:
    """Mean translation error after Horn alignment of (N, 4, 4) cam2world stacks."""
    gt_pts = gt_traj[:, :3, 3].T
    est_pts = est_traj[:, :3, 3].T
    _, _, err = horn_align(gt_pts, est_pts)
    return float(err.mean())


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotations to XYZW quaternions, in float32 (see the module's docstring)."""
    return rotmat_to_quat(torch.as_tensor(np.asarray(m), dtype=torch.float32)).numpy()


def rotation_angle_deg(rot_gt: np.ndarray, rot_pred: np.ndarray, eps=1e-15):
    """Quaternion-based geodesic rotation error in degrees."""
    q_pred = _mat_to_quat(rot_pred)
    q_gt = _mat_to_quat(rot_gt)
    loss_q = np.clip(1 - np.sum(q_pred * q_gt, axis=-1) ** 2, eps, None)
    err_q = np.arccos(1 - 2 * loss_q)
    return err_q * 180.0 / np.pi


def translation_angle_deg(t_gt: np.ndarray, t_pred: np.ndarray, eps=1e-15, ambiguity=True):
    """Angle between translation directions in degrees (folded to [0, 90] with ``ambiguity``)."""
    t = t_pred / (np.linalg.norm(t_pred, axis=-1, keepdims=True) + eps)
    tg = t_gt / (np.linalg.norm(t_gt, axis=-1, keepdims=True) + eps)
    loss_t = np.clip(1.0 - np.sum(t * tg, axis=-1) ** 2, eps, None)
    err_t = np.arccos(np.sqrt(1 - loss_t))
    err_t = np.nan_to_num(err_t, nan=1e6, posinf=1e6, neginf=1e6)
    deg = err_t * 180.0 / np.pi
    if ambiguity:
        deg = np.minimum(deg, np.abs(180 - deg))
    return deg


def calculate_auc(r_error: np.ndarray, t_error: np.ndarray, max_threshold=30):
    """Pose AUC over the histogram (1-degree bins) of max(rotation, translation) error:
    (auc in [0, 1], the normalised histogram)."""
    max_errors = np.maximum(r_error, t_error)
    bins = np.arange(max_threshold + 1)
    histogram, _ = np.histogram(max_errors, bins=bins)
    normalized = histogram.astype(float) / float(len(max_errors))
    return float(np.mean(np.cumsum(normalized))), normalized


def build_pair_index(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Indices of all unordered frame pairs."""
    i1, i2 = np.triu_indices(n, k=1)
    return i1, i2


def closed_form_inverse_se3(se3: np.ndarray) -> np.ndarray:
    """Batched rigid inverse of (N, 4, 4) (or (N, 3, 4)) transforms."""
    rt = np.transpose(se3[:, :3, :3], (0, 2, 1))
    tr = -rt @ se3[:, :3, 3:]
    out = np.tile(np.eye(4), (len(se3), 1, 1))
    out[:, :3, :3] = rt
    out[:, :3, 3:] = tr
    return out


def se3_to_relative_pose_error(pred_se3: np.ndarray, gt_se3: np.ndarray, num_frames: int):
    """Rotation and translation-direction errors (degrees) of every frame pair's relative pose."""
    i1, i2 = build_pair_index(num_frames)
    rel_gt = closed_form_inverse_se3(gt_se3[i1]) @ gt_se3[i2]
    rel_pred = closed_form_inverse_se3(pred_se3[i1]) @ pred_se3[i2]
    r_err = rotation_angle_deg(rel_gt[:, :3, :3], rel_pred[:, :3, :3])
    t_err = translation_angle_deg(rel_gt[:, :3, 3], rel_pred[:, :3, 3])
    return r_err, t_err
