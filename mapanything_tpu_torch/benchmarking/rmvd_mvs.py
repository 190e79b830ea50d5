"""RobustMVD-style multi-view-stereo depth benchmark of the port.

Counterpart of ``mapanything_tpu/benchmarking/rmvd_mvs.py`` (:18-88): the
keyframe's (view 0's) z-depth in the RobustMVD protocol, a per-sample
median-scale alignment, then Absrel and the inlier ratio (max(p/g, g/p) under
1.03) against the ground-truth depth, both in percent. ``run_benchmark`` takes
the model (an ``nn.Module`` that holds its weights) in place of the JAX
``(model, params)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mapanything_tpu_torch.models.mapanything import Views

INLIER_THRESH = 1.03


def median_scale_align(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> float:
    """Scale factor aligning ``pred`` to ``gt`` by the ratio of their medians over ``mask``."""
    p = pred[mask]
    g = gt[mask]
    if len(p) == 0 or np.median(p) <= 0:
        return 1.0
    return float(np.median(g) / np.median(p))


def _scaled_ratio(pred_depth, gt_depth, mask, align_scale):
    """(valid pixels, the scale, the aligned prediction, max(p/g, g/p)) of ``rmvd_depth_metrics``."""
    valid = gt_depth > 0
    if mask is not None:
        valid = valid & mask
    if not valid.any():
        return valid, np.nan, None, None
    scale = median_scale_align(pred_depth, gt_depth, valid) if align_scale else 1.0
    p = pred_depth * scale
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.maximum(
            np.nan_to_num(p / gt_depth, nan=np.inf),
            np.nan_to_num(gt_depth / np.maximum(p, 1e-9), nan=np.inf),
        )
    return valid, scale, p, ratio


def rmvd_depth_metrics(pred_depth: np.ndarray, gt_depth: np.ndarray, mask: Optional[np.ndarray] = None,
                       align_scale: bool = True) -> Dict[str, float]:
    """Absrel (%) and inlier ratio (max(p/g, g/p) < 1.03, %) of (H, W) z-depths.

    ``mask``: optional validity (ground truth <= 0 is always excluded);
    ``align_scale``: median-scale the prediction to the ground truth first.
    """
    valid, scale, p, ratio = _scaled_ratio(pred_depth, gt_depth, mask, align_scale)
    if p is None:
        return {"absrel": np.nan, "inlier103": np.nan, "scale": np.nan}
    with np.errstate(divide="ignore", invalid="ignore"):
        absrel = np.abs(p - gt_depth) / gt_depth
    return {
        "absrel": float(np.mean(absrel[valid]) * 100.0),
        "inlier103": float(np.mean(ratio[valid] < INLIER_THRESH) * 100.0),
        "scale": scale,
    }


def inlier_edge_allowance(pred_depth: np.ndarray, gt_depth: np.ndarray, mask: Optional[np.ndarray] = None,
                          margin: float = 1e-3) -> float:
    """How far ``rmvd_depth_metrics``' inlier103 (%) may move between two runs that
    agree to rounding: the share of valid pixels whose aligned ratio lies within
    ``margin`` (relative) of 1.03, in percent (each such pixel can flip)."""
    valid, _, p, ratio = _scaled_ratio(pred_depth, gt_depth, mask, True)
    if p is None:
        return 0.0
    near = np.abs(ratio[valid] - INLIER_THRESH) <= margin * INLIER_THRESH
    return float(np.mean(near) * 100.0)


def run_benchmark(model, data_loader, max_batches: Optional[int] = None) -> Dict[str, float]:
    """Evaluate the keyframe z-depth over a loader of collated batches (images only):
    the mean Absrel and inlier ratio over samples, and their number."""
    device = model.device
    absrels, inliers = [], []
    with torch.inference_mode():
        for i, batch_np in enumerate(data_loader):
            if max_batches is not None and i >= max_batches:
                break
            img = torch.as_tensor(np.asarray(batch_np["img"]), dtype=torch.float32).to(device)
            pred_z = model(Views(img=img)).pts3d_cam[..., 2].float().cpu().numpy()
            gt_z = np.asarray(batch_np["pts3d_cam"][..., 2])
            valid = np.asarray(batch_np["valid_mask"])
            for b in range(pred_z.shape[0]):
                m = rmvd_depth_metrics(pred_z[b, 0], gt_z[b, 0], valid[b, 0])
                absrels.append(m["absrel"])
                inliers.append(m["inlier103"])
    return {
        "absrel": float(np.nanmean(absrels)),
        "inlier103": float(np.nanmean(inliers)),
        "num_samples": len(absrels),
    }
