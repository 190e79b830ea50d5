"""Single-view calibration benchmark of the port: ray-direction angular error.

Counterpart of ``mapanything_tpu/benchmarking/calibration.py`` (:16-51): run
single-view inference, compare the predicted unit ray directions with the
ground-truth rays of the calibrated intrinsics, and report the mean angular
error in degrees per scene. ``run_benchmark`` takes the model (an ``nn.Module``
that holds its weights) in place of the JAX ``(model, params)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mapanything_tpu_torch.models.mapanything import Views
from mapanything_tpu_torch.utils.metrics import ray_angular_error_deg


def compute_calibration_metrics(gt_ray_directions, pred_ray_directions) -> float:
    """Mean angular error (degrees) between unit-ray maps (arrays or tensors)."""
    gt, pred = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                for x in (gt_ray_directions, pred_ray_directions))
    l2 = np.linalg.norm(gt - pred, axis=-1)
    return float(np.mean(ray_angular_error_deg(l2)))


def run_benchmark(model, data_loader, max_batches: Optional[int] = None) -> Dict[str, float]:
    """Loop collated batches, infer on each sample's first view alone, and aggregate
    the ray error by scene; "overall" is the mean over scenes."""
    device = model.device
    per_scene: Dict[str, list] = {}
    with torch.inference_mode():
        for i, batch_np in enumerate(data_loader):
            if max_batches is not None and i >= max_batches:
                break
            img = torch.as_tensor(np.asarray(batch_np["img"])[:, :1], dtype=torch.float32).to(device)
            preds = model(Views(img=img))
            err = compute_calibration_metrics(batch_np["ray_directions_cam"][:, 0], preds.ray_directions[:, 0])
            labels = batch_np.get("label", [f"scene_{i}"])
            for label in np.atleast_1d(labels):
                per_scene.setdefault(str(label), []).append(err)

    summary = {scene: float(np.mean(v)) for scene, v in per_scene.items()}
    summary["overall"] = float(np.mean(list(summary.values())))
    return summary
