"""Per-pixel cross-view depth-consistency confidence of WAI scenes, on the card.

Counterpart of ``mapanything_tpu/data_processing/depth_confidence.py``
(:1-215), after the reference's
``data_processing/wai_processing/scripts/depth_consistency_confidence.py``
(:36-157): every frame's depth is unprojected to world points and reprojected
into every other frame; each source pixel's reprojection is an inlier
(|expected - looked-up| < abs + rel * expected) or an outlier (> threshold)
per target view, and its confidence is inliers / (inliers + outliers + eps)
in [0, 1], stored as a ``depth_confidence`` modality beside the covisibility.

The reprojection is ``covisibility.py``'s, in the same chunks of source views
(a Python loop on ``device``, CUDA unless the caller names another, where the
JAX package runs a ``lax.map``). A view never scores against itself.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from mapanything_tpu_torch.data_processing.covisibility import lookup, pad_views, pose_inverse, reproject, world_points
from mapanything_tpu_torch.models.mapanything import resolve_device
from mapanything_tpu_torch.utils.exr import write_depth_exr


def compute_depth_consistency_confidence(
    depths: np.ndarray,
    intrinsics: np.ndarray,
    cam2worlds: np.ndarray,
    valid_masks: Optional[np.ndarray] = None,
    depth_assoc_error_thres: float = 0.1,
    depth_assoc_rel_error_thres: float = 0.005,
    chunk_size: int = 4,
    device: Union[str, torch.device, None] = None,
) -> np.ndarray:
    """Per-pixel depth-consistency confidence maps of one scene.

    Args:
        depths: (V, H, W) z-depth per view (0 = invalid).
        intrinsics: (V, 3, 3); cam2worlds: (V, 4, 4) OpenCV cam2world.
        valid_masks: optional (V, H, W) bool; defaults to depth > 0.
        depth_assoc_*: inlier threshold abs + rel * expected_depth
            (reference covisibility_gt_depth.yaml:17-19 defaults).
        chunk_size: source views a step.
        device: where it runs, CUDA unless given.

    Returns:
        (V, H, W) float32 confidence in [0, 1]; 0 where a pixel was never
        validly observed by another view.
    """
    device = resolve_device(device)
    V = depths.shape[0]
    if valid_masks is None:
        valid_masks = depths > 0
    chunk_size = min(chunk_size, V)
    d, K, c2w, valid = pad_views(chunk_size, depths, intrinsics, cam2worlds, valid_masks, device)
    abs_thres, rel_thres = float(depth_assoc_error_thres), float(depth_assoc_rel_error_thres)
    with torch.inference_mode():
        w2c = pose_inverse(c2w)
        world = world_points(d, K, c2w)
        view_ids = torch.arange(d.shape[0], device=device)
        maps = []
        for s in range(0, d.shape[0], chunk_size):
            z, in_bounds, flat = reproject(world[s:s + chunk_size], w2c, K)
            d_lu, m_lu = lookup(d, flat), lookup(valid, flat)
            err = torch.abs(z - d_lu)
            thres = abs_thres + rel_thres * z
            ok = (in_bounds & m_lu & valid[s:s + chunk_size, None]
                  & (view_ids[s:s + chunk_size, None, None, None] != view_ids[None, :, None, None]))
            inl = ((err < thres) & ok).sum(dim=1).to(torch.float32)
            outl = ((err > thres) & ok).sum(dim=1).to(torch.float32)
            maps.append(inl / (inl + outl + 1e-10))
        return torch.cat(maps)[:V].cpu().numpy()


def write_depth_confidence(
    scene_root,
    frame_names: Sequence[str],
    confidence: np.ndarray,
    method_name: str = "gt_depth",
    version: str = "v0",
) -> List[Path]:
    """Store per-frame confidence EXRs + register the WAI modality.

    Mirrors the reference's output layout
    (``depth_consistency_confidence.py:180-252``):
    ``covisibility/<version>/depth_confidence/<frame>.exr`` plus a
    ``depth_confidence`` entry in scene_meta's frame_modalities and a
    ``<method>_depth_confidence`` key on each frame.
    """
    scene_root = Path(scene_root)
    out_dir = scene_root / "covisibility" / version / "depth_confidence"
    out_dir.mkdir(parents=True, exist_ok=True)

    meta_path = scene_root / "scene_meta.json"
    meta: Dict = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    by_name = {fr.get("frame_name"): fr for fr in meta.get("frames", [])}

    paths = []
    key = f"{method_name}_depth_confidence"
    for name, conf in zip(frame_names, confidence):
        p = out_dir / f"{name}.exr"
        write_depth_exr(p, np.asarray(conf, np.float32))
        paths.append(p)
        if name in by_name:
            by_name[name][key] = str(p.relative_to(scene_root))

    if meta:
        fm = meta.setdefault("frame_modalities", {})
        dc = fm.setdefault("depth_confidence", {})
        dc[method_name] = {"frame_key": key, "format": "scalar"}
        meta_path.write_text(json.dumps(meta, indent=2))
    return paths
