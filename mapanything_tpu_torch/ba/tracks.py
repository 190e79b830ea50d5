"""Correspondence tracks for bundle adjustment, from dense predictions or a tracker.

Counterpart of ``mapanything_tpu/ba/tracks.py``: ``Tracks`` (:26),
``extract_tracks_from_predictions`` (:41), ``_gather_per_cam`` (:129),
``tracks_from_photometric_tracker`` (:134), ``_assemble_tracks_from_uv`` (:174) and
``tracks_from_descriptor_matcher`` (:211).

From predictions: each view's most confident valid pixels (a small random tie-break
spreads them) are unprojected by the predicted pointmap, projected into every camera,
and kept as an observation where they land inside the image in front of the camera and
agree with that view's predicted depth (relative ``depth_consistency_rtol``); a track
needs two observations. The tie-break noise comes from a ``torch.Generator`` seeded with
``rng_seed`` (the JAX package draws it from ``jax.random.PRNGKey``); the selection is a
stable descending sort, as ``jnp.argsort`` is stable. From a tracker: the observations
are the tracker's, and each track's point is its query pixel unprojected with the query
view's predicted depth and camera (on the host, in numpy, as the JAX package does).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mapanything_tpu_torch.geometry.transforms import closed_form_pose_inverse


@dataclasses.dataclass
class Tracks:
    """The BA problem's inputs, static shapes with validity masks; N tracks, M cameras."""

    points3d: torch.Tensor  # (N, 3) initial world points
    observations_uv: torch.Tensor  # (N, M, 2) pixel observations
    valid: torch.Tensor  # (N, M) bool observation validity
    intrinsics: torch.Tensor  # (M, 3, 3)
    cam_from_world_rot: torch.Tensor  # (M, 3, 3) w2c rotations (initial)
    cam_from_world_trans: torch.Tensor  # (M, 3) w2c translations (initial)


def extract_tracks_from_predictions(pts3d, depth_z, intrinsics, camera_poses, conf, mask,
                                    points_per_view: int = 512, depth_consistency_rtol: float = 0.05,
                                    rng_seed: int = 0) -> Tracks:
    """Tracks from one scene's dense predictions: ``pts3d`` (V, H, W, 3) world points,
    ``depth_z`` (V, H, W), ``intrinsics`` (V, 3, 3), ``camera_poses`` (V, 4, 4) cam2world,
    ``conf`` (V, H, W), ``mask`` (V, H, W); N = V * points_per_view tracks."""
    V, H, W = depth_z.shape
    gen = torch.Generator(device=depth_z.device).manual_seed(rng_seed)
    noise = torch.rand((V, H, W), generator=gen, device=depth_z.device, dtype=torch.float32) * 1e-3
    return _extract_tracks(pts3d, depth_z, intrinsics, camera_poses, conf, mask, noise, points_per_view,
                           depth_consistency_rtol)


def _extract_tracks(pts3d, depth_z, intrinsics, camera_poses, conf, mask, noise, points_per_view: int,
                    depth_consistency_rtol: float) -> Tracks:
    """``extract_tracks_from_predictions`` with the tie-break ``noise`` (V, H, W) given."""
    V, H, W = depth_z.shape
    K = points_per_view
    mask = mask.to(torch.bool)
    score = torch.where(mask, conf + noise, torch.full_like(conf, -torch.inf))
    top_idx = torch.sort(-score.reshape(V, H * W), dim=1, stable=True).indices[:, :K]  # (V, K)
    seed_valid = torch.gather(mask.reshape(V, H * W), 1, top_idx)
    seeds3d = torch.gather(pts3d.reshape(V, H * W, 3), 1, top_idx[..., None].expand(V, K, 3))
    points3d = seeds3d.reshape(V * K, 3)

    w2c = closed_form_pose_inverse(camera_poses)
    rot, trans = w2c[:, :3, :3], w2c[:, :3, 3]
    cam_pts = torch.einsum("mij,nj->nmi", rot, points3d) + trans[None]  # (N, M, 3)
    z = cam_pts[..., 2]
    uvw = torch.einsum("mij,nmj->nmi", intrinsics, cam_pts)
    safe_z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    uv = uvw[..., :2] / safe_z[..., None]
    in_bounds = (uv[..., 0] >= 0) & (uv[..., 0] <= W - 1) & (uv[..., 1] >= 0) & (uv[..., 1] <= H - 1) & (z > 0)

    # Depth consistency against each view's predicted z-depth at the nearest pixel.
    ui = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, H - 1)
    flat = vi * W + ui  # (N, M)
    gathered_d = _gather_per_cam(depth_z.reshape(V, H * W), flat)
    gathered_m = _gather_per_cam(mask.reshape(V, H * W), flat)
    depth_ok = torch.abs(gathered_d - z) / torch.clamp(torch.abs(gathered_d), min=1e-6) < depth_consistency_rtol

    valid = in_bounds & depth_ok & gathered_m & seed_valid.reshape(V * K)[:, None]
    valid = valid & (valid.sum(1, keepdim=True) >= 2)  # tracks seen in two views or more
    return Tracks(points3d=points3d, observations_uv=uv, valid=valid, intrinsics=intrinsics,
                  cam_from_world_rot=rot, cam_from_world_trans=trans)


def _gather_per_cam(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (M, HW), idx (N, M) -> out (N, M) with out[n, m] = src[m, idx[n, m]]."""
    return torch.gather(src, 1, idx.T).T


def tracks_from_photometric_tracker(images, depth_z, intrinsics, camera_poses, max_query_pts: int = 512,
                                    query_frame_num: int = 3, vis_thresh: float = 0.6, tracker=None) -> Tracks:
    """BA tracks from the keypoint tracker (``ba.tracker.predict_tracks``): ``images``
    (V, H, W, 3) in [0, 1], ``depth_z`` (V, H, W), ``intrinsics`` (V, 3, 3),
    ``camera_poses`` (V, 4, 4) cam2world. With ``tracker`` (a ``VGGSfMTracker``, the JAX
    package's ``tracker_params``) the learned tracker predicts the observations, else
    the corner detector and coarse-to-fine NCC."""
    from mapanything_tpu_torch.ba.tracker import predict_tracks

    tracks_uv, vis, scores = predict_tracks(images, max_query_pts=max_query_pts, query_frame_num=query_frame_num,
                                            vis_thresh=vis_thresh, tracker=tracker)
    return _assemble_tracks_from_uv(tracks_uv, vis, scores, depth_z, intrinsics, camera_poses)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assemble_tracks_from_uv(tracks_uv, vis, scores, depth_z, intrinsics, camera_poses) -> Tracks:
    """(V, N, 2) / (V, N) tracker outputs -> Tracks on ``depth_z``'s device; each track's
    point from its query frame (score 1 by construction), in numpy."""
    device = depth_z.device if isinstance(depth_z, torch.Tensor) else torch.device("cpu")
    dz = _numpy(depth_z)
    V, H, W = dz.shape
    tracks_uv = _numpy(tracks_uv)
    N = tracks_uv.shape[1]
    q_frame = np.argmax(_numpy(scores), axis=0)
    Kn = _numpy(intrinsics)
    P = _numpy(camera_poses)
    pts3d = np.zeros((N, 3), np.float32)
    for n in range(N):
        q = int(q_frame[n])
        u, v = tracks_uv[q, n]
        ui, vi = int(round(float(u))), int(round(float(v)))
        ui = min(max(ui, 0), W - 1)
        vi = min(max(vi, 0), H - 1)
        z = float(dz[q, vi, ui])
        x = (float(u) - Kn[q, 0, 2]) * z / Kn[q, 0, 0]
        y = (float(v) - Kn[q, 1, 2]) * z / Kn[q, 1, 1]
        pts3d[n] = P[q, :3, :3] @ np.array([x, y, z], np.float32) + P[q, :3, 3]

    w2c = closed_form_pose_inverse(torch.from_numpy(np.ascontiguousarray(P)))
    as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return Tracks(points3d=as_t(pts3d), observations_uv=as_t(np.swapaxes(tracks_uv, 0, 1)),
                  valid=as_t(np.swapaxes(_numpy(vis), 0, 1)), intrinsics=as_t(Kn),
                  cam_from_world_rot=w2c[:, :3, :3].contiguous().to(device),
                  cam_from_world_trans=w2c[:, :3, 3].contiguous().to(device))


def tracks_from_descriptor_matcher(images, pair_desc_fn, intrinsics, camera_poses, depth_z,
                                   query_frame_num: int = 3, subsample: int = 8, sim_thresh: float = 0.2) -> Tracks:
    """Tracks from learned-descriptor matching (``ba.tracker.predict_tracks_descriptors``,
    e.g. MASt3R's local features), each point unprojected from its query pixel with the
    predicted depth, as ``tracks_from_photometric_tracker``."""
    from mapanything_tpu_torch.ba.tracker import predict_tracks_descriptors

    tracks, vis, scores = predict_tracks_descriptors(images, pair_desc_fn, query_frame_num=query_frame_num,
                                                     subsample=subsample, sim_thresh=sim_thresh)
    return _assemble_tracks_from_uv(tracks, vis, scores, depth_z, intrinsics, camera_poses)
