"""Offline pairwise covisibility of WAI scenes, on the card.

Counterpart of ``mapanything_tpu/data_processing/covisibility.py`` (:1-170),
after the reference's ``data_processing/wai_processing/scripts/covisibility.py``
(:32-145): every view's depth is unprojected to world points and reprojected
into every view; the score of a pair is the share of points whose looked-up
depth matches the expected depth within an absolute + relative + temperature
threshold, over the target view's valid-depth count (``valid_target_depth``).

The JAX package jits one program with a ``lax.map`` over chunks of source
views; here the same chunks are a Python loop over batched tensor ops on
``device`` (CUDA unless the caller names another): the views are padded to a
multiple of ``chunk_size`` with identity poses and intrinsics and zero depth,
as there. The 3-term products accumulate as XLA's CPU dot does (``fma_dot``),
so a point at a pixel or image border falls on the JAX package's side;
rounding to the nearest pixel is half to even on both sides (``jnp.round``,
``torch.round``); gathers take int64 indices.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from mapanything_tpu_torch.geometry.camera import depthmap_to_camera_frame
from mapanything_tpu_torch.models.mapanything import resolve_device


def pad_views(chunk_size: int, depths, intrinsics, cam2worlds, valid_masks, device) -> Tuple[torch.Tensor, ...]:
    """The scene's arrays on ``device``, padded to a multiple of ``chunk_size``
    views: zero depth and validity, identity intrinsics and poses (invertible)."""
    V = depths.shape[0]
    pad = (-V) % chunk_size

    def put(x, dtype, fill=None):
        t = torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)
        if pad:
            extra = torch.zeros((pad,) + tuple(t.shape[1:]), dtype=dtype)
            if fill is not None:
                extra[:] = fill
            t = torch.cat([t, extra])
        return t.to(device)

    return (put(depths, torch.float32), put(intrinsics, torch.float32, torch.eye(3)),
            put(cam2worlds, torch.float32, torch.eye(4)), put(valid_masks, torch.bool))


def fma_dot(pairs) -> torch.Tensor:
    """sum_k a_k b_k of float32 tensors as XLA's CPU dot accumulates a short
    contraction: a0 b0, then fused multiply-adds in order. Each step is exact
    in float64 (the product of two float32 numbers is) and rounded once to
    float32, so the port's reprojection lands on the same side of a pixel or
    image border as the JAX package's on the CPU."""
    (a, b), *rest = pairs
    acc = a * b
    for a, b in rest:
        acc = torch.addcmul(acc.double(), a.double(), b.double()).float()
    return acc


def pose_inverse(pose: torch.Tensor) -> torch.Tensor:
    """Rigid (..., 4, 4) inverses [[R^T, -R^T t], [0, 1]], -R^T t summed by ``fma_dot``."""
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    t = pose[..., :3, 3]
    out = torch.zeros_like(pose)
    out[..., :3, :3] = rot_t
    out[..., :3, 3] = -torch.stack([fma_dot([(rot_t[..., i, k], t[..., k]) for k in range(3)]) for i in range(3)], -1)
    out[..., 3, 3] = 1.0
    return out


def world_points(depths: torch.Tensor, intrinsics: torch.Tensor, cam2worlds: torch.Tensor) -> torch.Tensor:
    """(V, H, W, 3) world points of each view's depth."""
    pts, _ = depthmap_to_camera_frame(depths, intrinsics)
    rot = cam2worlds[:, None, None, :3, :3]
    world = [fma_dot([(rot[..., i, k], pts[..., k]) for k in range(3)]) for i in range(3)]
    return torch.stack(world, -1) + cam2worlds[:, None, None, :3, 3]


def reproject(src_world: torch.Tensor, w2c: torch.Tensor, intrinsics: torch.Tensor):
    """Source points (C, H, W, 3) in every target camera (Vt): their camera
    z (C, Vt, H, W), where they land inside the image in front of the camera,
    and the flat index of the nearest target pixel (int64)."""
    H, W = src_world.shape[1:3]
    pw = src_world[:, None]  # (C, 1, H, W, 3)
    rot, t = w2c[None, :, None, None, :3, :3], w2c[None, :, None, None, :3, 3]
    cam = [fma_dot([(rot[..., i, k], pw[..., k]) for k in range(3)]) + t[..., i] for i in range(3)]
    K = intrinsics[None, :, None, None]
    u, v = (fma_dot([(K[..., i, k], cam[k]) for k in range(3)]) for i in range(2))
    z = cam[2]
    safe_z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u, v = u / safe_z, v / safe_z
    in_bounds = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 0)
    ui = torch.clamp(torch.round(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(v).to(torch.int64), 0, H - 1)
    return z, in_bounds, vi * W + ui


def lookup(values: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """out[c, m, h, w] = values[m].flatten()[flat[c, m, h, w]]."""
    C, Vt = flat.shape[:2]
    src = values.reshape(1, Vt, -1).expand(C, Vt, -1)
    return torch.gather(src, 2, flat.reshape(C, Vt, -1)).reshape(flat.shape)


def compute_pairwise_covisibility(
    depths: np.ndarray,
    intrinsics: np.ndarray,
    cam2worlds: np.ndarray,
    valid_masks: Optional[np.ndarray] = None,
    depth_assoc_error_thres: float = 0.1,
    depth_assoc_rel_error_thres: float = 0.02,
    depth_assoc_error_temp: float = 0.0,
    chunk_size: int = 8,
    device: Union[str, torch.device, None] = None,
) -> np.ndarray:
    """Full (V, V) covisibility matrix of one scene (float32, numpy).

    Args:
        depths: (V, H, W) z-depth per view (0 = invalid).
        intrinsics: (V, 3, 3); cam2worlds: (V, 4, 4).
        valid_masks: optional (V, H, W) bool; defaults to depth > 0.
        chunk_size: source views a step.
        device: where it runs, CUDA unless given.
    """
    device = resolve_device(device)
    V = depths.shape[0]
    if valid_masks is None:
        valid_masks = depths > 0
    chunk_size = min(chunk_size, V)
    d, K, c2w, valid = pad_views(chunk_size, depths, intrinsics, cam2worlds, valid_masks, device)
    abs_thres, rel_thres = float(depth_assoc_error_thres), float(depth_assoc_rel_error_thres)
    log_half_temp = -math.log(0.5) * float(depth_assoc_error_temp)
    with torch.inference_mode():
        w2c = pose_inverse(c2w)
        valid_counts = torch.clamp(valid.sum(dim=(1, 2)), min=1)
        world = world_points(d, K, c2w)
        rows = []
        for s in range(0, d.shape[0], chunk_size):
            z, in_bounds, flat = reproject(world[s:s + chunk_size], w2c, K)
            d_lu, m_lu = lookup(d, flat), lookup(valid, flat)
            err = torch.abs(z - d_lu)
            ok = (err < abs_thres + rel_thres * z + log_half_temp) & in_bounds & m_lu & valid[s:s + chunk_size, None]
            rows.append(torch.clamp(ok.sum(dim=(2, 3)) / valid_counts[None, :], 0.0, 1.0))
        out = torch.cat(rows).to(torch.float32).cpu().numpy()[:V, :V].copy()
    np.fill_diagonal(out, np.clip(np.diagonal(out), 1e-3, None))
    return out


def write_covisibility(scene_root, covis: np.ndarray, version: str = "v0"):
    """Store the matrix in the WAI layout consumed by the datasets."""
    out_dir = Path(scene_root) / "covisibility" / version
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "pairwise_covisibility.npy", covis)
    return out_dir / "pairwise_covisibility.npy"
