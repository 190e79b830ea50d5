"""Pseudo-depth of WAI scenes: monocular (MoGe) and multi-view (plane sweep), on the card.

Counterpart of ``mapanything_tpu/data_processing/pseudo_depth.py`` (:1-396),
after the reference's ``data_processing/wai_processing/scripts/run_moge.py``
(:46-140, MoGe monocular depth stored as a ``pred_depth/moge`` modality) and
``run_mvsanywhere.py`` (:198-281, multi-view-stereo depth stored as
``pred_depth/mvsanywhere``).

- :func:`run_moge_on_scene` batches the frames through the port's MoGe-1
  (``models/external/moge.py``), whose ViT runs the port's attention kernels.
- :func:`plane_sweep_depth` is a classical plane-sweep MVS: for every
  inverse-depth hypothesis the neighbour views are warped into the reference
  camera and scored with a box-filtered ZNCC; the winner takes all, with a
  photometric confidence and a 3-point parabolic sub-plane refinement. The
  JAX package jits it with a ``lax.map`` over chunks of hypotheses; here the
  chunks are a Python loop over batched tensor ops. The box filter is the
  window sum over the in-bounds count (``reduce_window`` "SAME"), the
  bilinear gather clips at ``W - 1.001`` as there, the hypotheses are
  ``jnp.linspace``'s, and the argmax takes the first of tied planes.

Both run on ``device`` (CUDA unless the caller names another); both writers
register the WAI ``pred_depth`` modality as the reference does.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from mapanything_tpu_torch.data import wai as wai_io
from mapanything_tpu_torch.data_processing.covisibility import fma_dot
from mapanything_tpu_torch.models.external.moge import MoGeConfig, MoGeWrapper
from mapanything_tpu_torch.models.mapanything import resolve_device
from mapanything_tpu_torch.utils.exr import write_depth_exr


# ---------------------------------------------------------------------------
# Monocular pseudo-depth (MoGe)
# ---------------------------------------------------------------------------


def run_moge_on_scene(
    scene_root,
    model: Optional[MoGeWrapper] = None,
    cfg: Optional[MoGeConfig] = None,
    batch_size: int = 4,
    method_name: str = "moge",
    rng_seed: int = 0,
    device: Union[str, torch.device, None] = None,
) -> List[Path]:
    """MoGe z-depth for every frame of a WAI scene (reference run_moge.py).

    ``model`` carries its weights and device; without one, a ``MoGeWrapper`` of
    ``cfg`` (``MoGeConfig.small()`` by default, as the JAX function) with
    weights seeded by ``rng_seed`` is built on ``device`` (CUDA unless given).
    The last batch is padded with the first frame. Depth is stored as
    ``pred_depth/<method>/depth/<frame>.exr`` with masked pixels at 0.
    """
    scene_root = Path(scene_root)
    meta = wai_io.load_scene_meta(scene_root)
    frames = meta["frames"]
    if model is None:
        model = MoGeWrapper(cfg or MoGeConfig.small(), device=resolve_device(device), seed=rng_seed)

    stack = np.stack([wai_io.load_image(scene_root / fr.get("image", fr.get("file_path"))) for fr in frames])
    V, H, W, _ = stack.shape
    depths = np.zeros((V, H, W), np.float32)
    pad = (-V) % batch_size
    padded = np.concatenate([stack, stack[:1].repeat(pad, 0)]) if pad else stack
    with torch.inference_mode():
        for s in range(0, V + pad, batch_size):
            view = model(torch.from_numpy(padded[s:s + batch_size]))[0]
            d = view["depth_z"][..., 0].float()
            m = view["non_ambiguous_mask"].bool()
            d = torch.where(m & (d > 0), d, torch.zeros_like(d)).cpu().numpy()
            depths[s:min(s + batch_size, V)] = d[:max(0, min(batch_size, V - s))]
    return _write_pred_depth(scene_root, meta, frames, depths, method_name)


# ---------------------------------------------------------------------------
# Multi-view-stereo pseudo-depth (plane sweep)
# ---------------------------------------------------------------------------


def _gray(img: torch.Tensor) -> torch.Tensor:
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Mean over the (2r+1)^2 window of the trailing two dims, the window cut at
    the border and divided by its in-bounds count."""
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape(-1, 1, *x.shape[-2:]), 2 * r + 1, stride=1, padding=r, count_include_pad=False)
    return y.reshape(*lead, *x.shape[-2:])


def _bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """img (N, H, W) sampled at float coords (..., N, H, W); out of bounds -> 0
    and invalid."""
    N, H, W = img.shape
    valid = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u = torch.clamp(u, 0.0, W - 1.001)
    v = torch.clamp(v, 0.0, H - 1.001)
    u0f, v0f = torch.floor(u), torch.floor(v)
    du, dv = u - u0f, v - v0f
    u0, v0 = u0f.to(torch.int64), v0f.to(torch.int64)
    flat = img.reshape(N, H * W)
    n = torch.arange(N, device=img.device)[:, None, None]

    def at(vy, ux):
        return flat[n, vy * W + ux]

    val = (at(v0, u0) * (1 - du) * (1 - dv) + at(v0, u0 + 1) * du * (1 - dv)
           + at(v0 + 1, u0) * (1 - du) * dv + at(v0 + 1, u0 + 1) * du * dv)
    return torch.where(valid, val, torch.zeros_like(val)), valid


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace``'s float32 arithmetic: start (1 - s) + stop s with
    s = i / (num - 1), the end point exact."""
    if num == 1:
        return start.reshape(1)
    step = torch.arange(num - 1, dtype=torch.float32, device=start.device) / float(num - 1)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


def _inverse_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """The inverse of a pinhole K as XLA's triangular solve gives it on the CPU
    (reciprocals of the focal lengths, multiplied); other matrices through
    ``torch.linalg.inv``."""
    if bool((K[[0, 1, 2, 2], [1, 0, 0, 1]] == 0).all() and K[2, 2] == 1):
        r0, r1 = 1.0 / K[0, 0], 1.0 / K[1, 1]
        out = torch.eye(3, dtype=K.dtype, device=K.device)
        out[0, 0], out[1, 1], out[0, 2], out[1, 2] = r0, r1, -K[0, 2] * r0, -K[1, 2] * r1
        return out
    return torch.linalg.inv(K)


def plane_scores(ref_img, nbr_imgs, K_ref, K_nbr, ref2nbr, dmin, dmax, num_planes: int = 64,
                 window_radius: int = 2, chunk: int = 8):
    """The sweep's (num_planes, H, W) mean-ZNCC scores and its inverse-depth
    hypotheses (num_planes,), from float32 tensors on one device."""
    H, W = ref_img.shape[:2]
    r = window_radius
    device = ref_img.device
    g_ref = _gray(ref_img)
    g_nbr = _gray(nbr_imgs)
    mu_r = _box_filter(g_ref, r)
    var_r = _box_filter(g_ref * g_ref, r) - mu_r * mu_r

    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    Kinv = _inverse_intrinsics(K_ref)
    pix = (xs, ys, torch.ones_like(xs))
    rays = torch.stack([fma_dot([(Kinv[i, j], pix[j]) for j in range(3)]) for i in range(3)], -1)  # (H, W, 3)

    inv_d = _linspace(1.0 / dmax, 1.0 / dmin, num_planes)
    R, t = ref2nbr[:, :3, :3], ref2nbr[:, :3, 3]

    def score_planes(inv_chunk):
        """Mean ZNCC across neighbours, (P, H, W), for P fronto-parallel planes."""
        pts = rays[None] / inv_chunk[:, None, None, None]  # (P, H, W, 3) in the ref camera
        p = pts[:, None]  # (P, 1, H, W, 3)
        Rb, tb = R[None, :, None, None], t[None, :, None, None]
        cam = [fma_dot([(Rb[..., i, j], p[..., j]) for j in range(3)]) + tb[..., i] for i in range(3)]
        Kb = K_nbr[None, :, None, None]
        uvw = [fma_dot([(Kb[..., i, j], cam[j]) for j in range(3)]) for i in range(2)]
        z = cam[2]
        safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        samp, valid = _bilinear_sample(g_nbr, uvw[0] / safe_z, uvw[1] / safe_z)
        valid = valid & (z > 0)
        sampf = torch.where(valid, samp, torch.zeros_like(samp))
        mu_s = _box_filter(sampf, r)
        var_s = _box_filter(sampf * sampf, r) - mu_s * mu_s
        cov = _box_filter(sampf * g_ref, r) - mu_s * mu_r
        zncc = cov * torch.rsqrt(torch.clamp(var_s * var_r, min=1e-8))  # (P, N, H, W)
        w = valid.to(torch.float32)
        return (zncc * w).sum(1) / torch.clamp(w.sum(1), min=1.0)

    scores = torch.cat([score_planes(inv_d[s:s + chunk]) for s in range(0, num_planes, chunk)])
    return scores, inv_d


def winner_depth(scores: torch.Tensor, inv_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner-takes-all depth with the 3-point parabolic refinement on the
    inverse-depth grid, and the winner's score clipped to [0, 1]."""
    num_planes = scores.shape[0]
    best = torch.argmax(scores, dim=0)  # the first of tied planes
    best_score = scores.amax(dim=0)
    ip = torch.clamp(best, 1, num_planes - 2)[None]
    s0, s1, s2 = (torch.gather(scores, 0, ip + k)[0] for k in (-1, 0, 1))
    denom = s0 - 2 * s1 + s2
    delta = torch.where(torch.abs(denom) > 1e-8, 0.5 * (s0 - s2) / denom, torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    step = (inv_d[1] - inv_d[0]) if num_planes > 1 else 0.0
    inv_best = inv_d[ip[0]] + delta * step
    return 1.0 / torch.clamp(inv_best, min=1e-8), torch.clamp(best_score, 0.0, 1.0)


def plane_sweep_depth(
    ref_img,
    nbr_imgs,
    K_ref,
    K_nbr,
    ref2nbr,
    dmin: float,
    dmax: float,
    num_planes: int = 64,
    window_radius: int = 2,
    chunk: int = 8,
    device: Union[str, torch.device, None] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Winner-takes-all plane-sweep MVS depth for one reference view.

    Args:
        ref_img: (H, W, 3) float in [0, 1].
        nbr_imgs: (N, H, W, 3) neighbour images.
        K_ref: (3, 3); K_nbr: (N, 3, 3).
        ref2nbr: (N, 4, 4) transforms from ref camera to each neighbour.
        dmin/dmax: scalar depth range; hypotheses are uniform in INVERSE
            depth between them (standard plane-sweep spacing).
        num_planes: hypothesis count.
        window_radius: ZNCC window radius.
        chunk: hypotheses a step (bounds memory at chunk * N * H * W floats).
        device: where it runs, CUDA unless given.

    Returns:
        depth (H, W) float32 and confidence (H, W) in [0, 1] (the mean ZNCC of
        the winning plane across valid neighbours, clipped), numpy.
    """
    device = resolve_device(device)
    inputs = [torch.as_tensor(np.asarray(x), dtype=torch.float32).to(device)
              for x in (ref_img, nbr_imgs, K_ref, K_nbr, ref2nbr, dmin, dmax)]
    with torch.inference_mode():
        depth, conf = winner_depth(*plane_scores(*inputs, num_planes=num_planes, window_radius=window_radius,
                                                 chunk=chunk))
        return depth.cpu().numpy(), conf.cpu().numpy()


def run_mvs_on_scene(
    scene_root,
    num_neighbors: int = 4,
    num_planes: int = 64,
    window_radius: int = 2,
    depth_range: Optional[Tuple[float, float]] = None,
    min_confidence: float = 0.2,
    method_name: str = "mvs",
    covis_version: str = "v0",
    device: Union[str, torch.device, None] = None,
) -> List[Path]:
    """Plane-sweep MVS pseudo-depth for every frame of a WAI scene.

    Neighbour selection follows the covisibility matrix when present
    (top-k most covisible views, the reference MVS pipeline's frame
    selection), otherwise nearest frame indices. Depth range defaults to
    the baseline-scaled [0.1 * b, 50 * b] with b = median camera-center
    spacing, so the sweep adapts to scene scale.
    """
    device = resolve_device(device)
    scene_root = Path(scene_root)
    meta = wai_io.load_scene_meta(scene_root)
    frames = meta["frames"]
    V = len(frames)

    imgs, Ks, poses = [], [], []
    for fr in frames:
        data = wai_io.load_frame(scene_root, fr["frame_name"], ["image", "intrinsics", "pose"], meta=meta)
        imgs.append(data["image"])
        Ks.append(data["intrinsics"])
        poses.append(data["pose"])
    imgs = np.stack(imgs)
    Ks = np.stack(Ks)
    c2w = np.stack(poses)
    w2c = np.linalg.inv(c2w)

    try:
        covis = np.asarray(wai_io.load_covisibility(scene_root, covis_version))
    except FileNotFoundError:
        covis = None

    centers = c2w[:, :3, 3]
    if depth_range is None:
        d = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
        b = float(np.median(d[d > 0])) if V > 1 and (d > 0).any() else 1.0
        depth_range = (0.1 * b, 50.0 * b)

    n_nbr = min(num_neighbors, max(V - 1, 1))
    depths = np.zeros(imgs.shape[:3], np.float32)
    for i in range(V):
        order = np.argsort(-covis[i]) if covis is not None else np.argsort(np.abs(np.arange(V) - i))
        nbrs = [j for j in order if j != i][:n_nbr]
        if not nbrs:
            continue
        ref2nbr = w2c[nbrs] @ c2w[i]
        depth, conf = plane_sweep_depth(imgs[i], imgs[nbrs], Ks[i], Ks[nbrs], ref2nbr.astype(np.float32),
                                        float(depth_range[0]), float(depth_range[1]), num_planes=num_planes,
                                        window_radius=window_radius, device=device)
        depth[conf < min_confidence] = 0.0
        depths[i] = depth

    return _write_pred_depth(scene_root, meta, frames, depths, method_name)


# ---------------------------------------------------------------------------
# Shared writer
# ---------------------------------------------------------------------------


def _write_pred_depth(
    scene_root: Path,
    meta: Dict,
    frames: Sequence[Dict],
    depths: np.ndarray,
    method_name: str,
) -> List[Path]:
    """Store ``pred_depth/<method>/depth/<frame>.exr`` + register the modality
    (reference run_moge.py:120-140 / run_mvsanywhere.py:257-281 layout)."""
    out_dir = scene_root / "pred_depth" / method_name / "depth"
    out_dir.mkdir(parents=True, exist_ok=True)
    key = f"{method_name}_depth"

    paths = []
    for fr, d in zip(frames, depths):
        p = out_dir / f"{fr['frame_name']}.exr"
        write_depth_exr(p, np.asarray(d, np.float32))
        fr[key] = str(p.relative_to(scene_root))
        paths.append(p)

    fm = meta.setdefault("frame_modalities", {})
    pd = fm.setdefault("pred_depth", {})
    pd[method_name] = {"frame_key": key, "format": "depth"}
    with open(scene_root / "scene_meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return paths


def sweep_agreement(depth: np.ndarray, other: np.ndarray, scores, inv_d, eps: float = 1e-5,
                    rtol: float = 1e-4) -> Dict[str, float]:
    """How far two float32 runs of the sweep agree, given one run's scores
    (P, H, W) and hypotheses: the refined depth of a pixel whose winner leads
    by more than ``eps`` is one parabola on the same three planes, so it stays
    within one plane step of inverse depth; it is within ``rtol`` relative
    unless a score change of ``eps`` moves it further (an ill-conditioned
    parabola). ``ties``: pixels whose top two planes are within ``eps``."""
    sc = np.asarray(scores, np.float64)
    inv = np.asarray(inv_d, np.float64)
    n = sc.shape[0]
    top2 = np.sort(sc, 0)[-2:]
    ties = top2[1] - top2[0] <= eps
    ip = np.clip(sc.argmax(0), 1, n - 2)
    s0, s1, s2 = (np.take_along_axis(sc, (ip + k)[None], 0)[0] for k in (-1, 0, 1))
    a, b = s0 - s2, s0 - 2 * s1 + s2
    step = inv[1] - inv[0]
    # |d delta / d s| summed over the three scores, delta = (s0 - s2) / (2 b)
    slope = (np.abs(b - a) / 2 + np.abs(a) + np.abs(b + a) / 2) / np.maximum(b * b, 1e-30)
    sensitive = depth * step * slope * eps > rtol
    rel = np.abs(depth - other) / np.maximum(np.abs(depth), 1e-12)
    plane_gap = np.abs(1.0 / np.maximum(depth, 1e-12) - 1.0 / np.maximum(other, 1e-12))
    return {"within_rtol": float((rel <= rtol).mean()),
            "within_rtol_or_sensitive": float(((rel <= rtol) | sensitive).mean()),
            "ties": int(ties.sum()), "sensitive": int((sensitive & ~ties).sum()),
            "beyond_one_plane_off_ties": int(((plane_gap > step * (1 + 1e-3)) & ~ties).sum()),
            "pixels": int(depth.size)}
