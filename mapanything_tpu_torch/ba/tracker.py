"""Keypoints and multi-view point tracks of the port: a classical tracker, the learned
VGGSfM one, and descriptor matching.

Counterpart of ``mapanything_tpu/ba/tracker.py``: ``_to_gray`` (:39), ``_box_filter``
(:45), ``harris_keypoints`` (:53), ``_bilinear`` (:102), ``_extract_patches`` (:122),
``_ncc`` (:136), ``_search_level`` (:148), ``_downsample`` (:205), ``track_points``
(:211), ``select_query_frames`` (:250), ``predict_tracks_learned`` (:265),
``predict_tracks`` (:326) and ``predict_tracks_descriptors`` (:418).

The classical tracker: Shi-Tomasi corners (the smaller eigenvalue of the box-filtered
structure tensor, 9x9 max-pool non-maximum suppression, a border, the ``max_points``
best; zero-score entries pad), then coarse-to-fine normalised cross-correlation of
11x11 patches over a three-level pyramid with a dense (2s+1)^2 search and a quadratic
sub-pixel fit. Ties keep the JAX package's order: ``jax.lax.top_k`` puts the lower
index first among equal scores (every zero-score padding entry is such a tie), so the
corners come from a stable descending sort; ``argmax`` takes the first maximum on both
sides. The pyramid's 2x downsample is ``jax.image.resize``'s antialiased bilinear
resize, written as its two weight matrices (``_resize_weights``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _to_gray(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) in [0, 1] -> (H, W) luma."""
    return img @ torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)


def _box_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    """Separable box filter of a 2-D input, zero outside (``np.convolve(mode="same")``
    along each axis)."""
    lo = (k - 1) // 2
    hi = k - 1 - lo
    kern = torch.full((1, 1, k), 1.0 / k, dtype=x.dtype, device=x.device)
    rows = F.conv1d(F.pad(x[:, None, :], (hi, lo)), kern)[:, 0]
    return F.conv1d(F.pad(rows.T[:, None, :], (hi, lo)), kern)[:, 0].T


def harris_keypoints(image: torch.Tensor, max_points: int = 512, nms_radius: int = 4, window: int = 5,
                     border: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shi-Tomasi corners of ``image`` (H, W, 3) in [0, 1]: (uv (max_points, 2) pixel
    coordinates, score (max_points,)); zero-score entries are padding."""
    g = _to_gray(image.to(torch.float32))
    H, W = g.shape
    dx = torch.gradient(g, dim=1)[0]
    dy = torch.gradient(g, dim=0)[0]
    ixx = _box_filter(dx * dx, window)
    iyy = _box_filter(dy * dy, window)
    ixy = _box_filter(dx * dy, window)
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    resp = tr / 2.0 - disc

    k = 2 * nms_radius + 1
    pooled = F.max_pool2d(resp[None, None], k, stride=1, padding=nms_radius)[0, 0]
    is_max = (resp >= pooled) & (resp > 0)
    v, u = torch.meshgrid(torch.arange(H, device=g.device), torch.arange(W, device=g.device), indexing="ij")
    inb = (u >= border) & (u < W - border) & (v >= border) & (v < H - border)
    score = torch.where(is_max & inb, resp, torch.zeros_like(resp)).reshape(-1)
    top = torch.sort(score, descending=True, stable=True)
    idx = top.indices[:max_points]
    uv = torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], -1)
    return uv, top.values[:max_points]


def _bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W) image at float (N, 2) uv (x, y), clamped inside."""
    H, W = img.shape
    x = torch.clamp(uv[:, 0], 0.0, W - 1.001)
    y = torch.clamp(uv[:, 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    at = lambda yy, xx: flat[yy * W + xx]  # noqa: E731
    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)


def _offsets(radius: int, device) -> torch.Tensor:
    """(P*P, 2) offsets (x, y) of a (2r+1)^2 window, x fastest."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([ox, oy], -1).reshape(-1, 2)


def _extract_patches(img: torch.Tensor, uv: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, P, P) patches centred at uv by bilinear sampling."""
    pts = uv[:, None, :] + _offsets(radius, img.device)[None]
    P = 2 * radius + 1
    return _bilinear(img, pts.reshape(-1, 2)).reshape(uv.shape[0], P, P)


def _ncc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normalised cross-correlation over the last two axes."""
    am = a - a.mean(dim=(-2, -1), keepdim=True)
    bm = b - b.mean(dim=(-2, -1), keepdim=True)
    num = (am * bm).sum((-2, -1))
    den = torch.sqrt((am * am).sum((-2, -1)) * (bm * bm).sum((-2, -1)))
    return num / torch.clamp(den, min=1e-8)


def _search_level(query_patches, target, centers, radius: int, search: int):
    """One pyramid level: dense NCC in a (2s+1)^2 window, then a sub-pixel quadratic fit
    where the peak is interior: (refined centers (N, 2), peak NCC (N,))."""
    cand = _offsets(search, target.device)
    C, N = cand.shape[0], centers.shape[0]
    P = 2 * radius + 1
    tp = _extract_patches(target, (centers[:, None, :] + cand[None]).reshape(-1, 2), radius).reshape(N, C, P, P)
    scores = _ncc(query_patches[:, None], tp)  # (N, C)
    best = torch.argmax(scores, dim=-1)
    peak = torch.gather(scores, 1, best[:, None])[:, 0]
    best_off = cand[best]

    S = 2 * search + 1
    bx, by = best % S, best // S
    grid = scores.reshape(N, S, S)

    def quad(fm1, f0, fp1):
        denom = fm1 - 2 * f0 + fp1
        return torch.where(torch.abs(denom) > 1e-8, torch.clamp(0.5 * (fm1 - fp1) / denom, -0.5, 0.5),
                           torch.zeros_like(denom))

    ix = torch.clamp(bx, 1, S - 2)
    iy = torch.clamp(by, 1, S - 2)
    n = torch.arange(N, device=target.device)
    dx = quad(grid[n, iy, ix - 1], grid[n, iy, ix], grid[n, iy, ix + 1])
    dy = quad(grid[n, iy - 1, ix], grid[n, iy, ix], grid[n, iy + 1, ix])
    sub = torch.stack([dx, dy], -1)
    interior = ((bx > 0) & (bx < S - 1) & (by > 0) & (by < S - 1))[:, None]
    return centers + best_off + torch.where(interior, sub, torch.zeros_like(sub)), peak


def _resize_weights(m: int, n: int) -> np.ndarray:
    """The (m, n) weights of ``jax.image.resize``'s antialiased bilinear resize of an axis
    of m samples to n (``compute_weight_mat`` with the triangle kernel), in fp32."""
    f32 = np.float32
    inv_scale = 1.0 / (n / m)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def _downsample(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H // 2, W // 2), ``jax.image.resize(..., "bilinear")`` (antialiased)."""
    H, W = img.shape
    wy = torch.from_numpy(_resize_weights(H, H // 2)).to(img.device)
    wx = torch.from_numpy(_resize_weights(W, W // 2)).to(img.device)
    return torch.einsum("hw,hy,wx->yx", img, wy, wx)


def track_points(query_image, target_image, query_uv, radius: int = 5, search: int = 4,
                 levels: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse-to-fine NCC tracking of ``query_uv`` (N, 2) from ``query_image`` into
    ``target_image`` ((H, W, 3) in [0, 1]): (target uv (N, 2), peak NCC (N,))."""
    pyr_q = [_to_gray(query_image.to(torch.float32))]
    pyr_t = [_to_gray(target_image.to(torch.float32))]
    for _ in range(levels - 1):
        pyr_q.append(_downsample(pyr_q[-1]))
        pyr_t.append(_downsample(pyr_t[-1]))
    centers = query_uv / 2.0 ** (levels - 1)
    score = torch.zeros(query_uv.shape[0], dtype=torch.float32, device=query_uv.device)
    for lvl in range(levels - 1, -1, -1):
        qp = _extract_patches(pyr_q[lvl], query_uv / (2.0**lvl), radius)
        centers, score = _search_level(qp, pyr_t[lvl], centers, radius, search)
        if lvl > 0:
            centers = centers * 2.0
    return centers, score


def select_query_frames(images, num_query: int) -> list:
    """Query frames spread over the sequence, frame 0 always among them."""
    S = images.shape[0]
    if num_query >= S:
        return list(range(S))
    idx = np.unique(np.linspace(0, S - 1, num_query).astype(int)).tolist()
    if 0 not in idx:
        idx = [0] + idx
    return idx


def _as_images(images) -> torch.Tensor:
    return images if isinstance(images, torch.Tensor) else torch.as_tensor(np.asarray(images))


def predict_tracks_learned(images, tracker, max_query_pts: int = 512, query_frame_num: int = 3,
                           vis_thresh: float = 0.5, coarse_iters: int = 6, fine_tracking: bool = True):
    """Tracks by the learned VGGSfM network ``tracker`` (a ``VGGSfMTracker``): for each
    query frame, the sequence reordered with it first, the corner detector's points as
    queries, the coarse-to-fine prediction mapped back; the query frame's observations
    are exact (score 1). ``images`` (S, H, W, 3) in [0, 1]; returns numpy (tracks (S, N,
    2), visibility (S, N), scores (S, N))."""
    images = _as_images(images).to(tracker.device, torch.float32)
    S = images.shape[0]
    all_tracks, all_scores = [], []
    for q in select_query_frames(images, query_frame_num):
        order = [q] + [s for s in range(S) if s != q]
        inv = np.argsort(order)
        uv, kp_score = harris_keypoints(images[q], max_points=max_query_pts)
        keep = (kp_score > 0).cpu().numpy()
        with torch.inference_mode():
            fine, _coarse, vis, _score = tracker(images[order][None], uv[None], coarse_iters=coarse_iters,
                                                 fine_tracking=fine_tracking)
        tr = fine[0].cpu().numpy()[inv]
        sc = vis[0].cpu().numpy()[inv]
        sc[q] = 1.0
        all_tracks.append(tr[:, keep])
        all_scores.append(sc[:, keep])
    tracks = np.concatenate(all_tracks, axis=1)
    scores = np.concatenate(all_scores, axis=1)
    return tracks, scores >= vis_thresh, scores


def _query_round(images, q: int, max_points: int, radius: int, search: int, levels: int):
    """One query frame's tracks into every frame: numpy (tracks (S, K, 2), scores (S, K))
    of its corners with a nonzero response."""
    uv, kp_score = harris_keypoints(images[q], max_points=max_points)
    tr, sc = [], []
    for s in range(images.shape[0]):
        if s == q:
            tr.append(uv)
            sc.append(torch.ones(uv.shape[0], dtype=torch.float32, device=uv.device))
        else:
            t_uv, t_sc = track_points(images[q], images[s], uv, radius=radius, search=search, levels=levels)
            tr.append(t_uv)
            sc.append(t_sc)
    keep = (kp_score > 0).cpu().numpy()
    return torch.stack(tr).cpu().numpy()[:, keep], torch.stack(sc).cpu().numpy()[:, keep]


def predict_tracks(images, max_query_pts: int = 512, query_frame_num: int = 3, vis_thresh: float = 0.5,
                   complete_non_vis: bool = True, radius: int = 5, search: int = 4, levels: int = 3, tracker=None):
    """Multi-view tracks of ``images`` (S, H, W, 3) in [0, 1]: with ``tracker`` (a
    ``VGGSfMTracker``) by ``predict_tracks_learned``, else by the classical tracker, then
    (``complete_non_vis``) one more query round from each of up to ``query_frame_num``
    frames with too few visible tracks. Returns numpy (tracks (S, N, 2), visibility
    (S, N) = score >= ``vis_thresh``, scores (S, N)); N grows with the query frames."""
    if tracker is not None:
        return predict_tracks_learned(images, tracker, max_query_pts=max_query_pts,
                                      query_frame_num=query_frame_num, vis_thresh=vis_thresh)
    images = _as_images(images)
    S = images.shape[0]
    rounds = [_query_round(images, q, max_query_pts, radius, search, levels)
              for q in select_query_frames(images, query_frame_num)]
    tracks = np.concatenate([t for t, _ in rounds], axis=1)
    scores = np.concatenate([s for _, s in rounds], axis=1)
    vis = scores >= vis_thresh
    if complete_non_vis:
        weak = [s for s in range(S) if vis[s].sum() < max(16, vis.shape[1] // 20)]
        for q in weak[:query_frame_num]:
            tr, sc = _query_round(images, q, max_query_pts // 2, radius, search, levels)
            tracks = np.concatenate([tracks, tr], axis=1)
            scores = np.concatenate([scores, sc], axis=1)
        vis = scores >= vis_thresh
    return tracks, vis, scores


def predict_tracks_descriptors(images, pair_desc_fn, query_frame_num: int = 3, subsample: int = 8,
                               sim_thresh: float = 0.0):
    """Tracks by mutual-nearest-neighbour matching of learned descriptors (MASt3R's local
    features): ``pair_desc_fn(img_a, img_b) -> (desc_a, desc_b)``, L2-normalised (H, W, D)
    maps of a pair; anchors on each query frame's ``subsample`` grid, a match visible
    where it is mutual and its cosine similarity reaches ``sim_thresh``. Returns numpy
    (tracks (S, N, 2), visibility (S, N), scores (S, N))."""
    from mapanything_tpu_torch.models.external.mast3r import reciprocal_matches

    images = _as_images(images)
    S = images.shape[0]
    all_tracks, all_vis, all_scores = [], [], []
    for q in select_query_frames(images, query_frame_num):
        per_frame, anchors = {}, None
        for s in range(S):
            if s == q:
                continue
            desc_q, desc_s = pair_desc_fn(images[q], images[s])
            pix1, pix2, valid = reciprocal_matches(desc_q, desc_s, subsample=subsample)
            if anchors is None:
                anchors = pix1.cpu().numpy().astype(np.float32)
            sim = (desc_q[pix1[:, 1], pix1[:, 0]] * desc_s[pix2[:, 1], pix2[:, 0]]).sum(-1)
            per_frame[s] = (pix2.cpu().numpy().astype(np.float32), (valid & (sim >= sim_thresh)).cpu().numpy(),
                            sim.float().cpu().numpy())
        n = anchors.shape[0]
        tracks = np.zeros((S, n, 2), np.float32)
        visibility = np.zeros((S, n), bool)
        scores = np.zeros((S, n), np.float32)
        tracks[q], visibility[q], scores[q] = anchors, True, 1.0
        for s, (t, v, c) in per_frame.items():
            tracks[s], visibility[s], scores[s] = t, v, c
        all_tracks.append(tracks)
        all_vis.append(visibility)
        all_scores.append(scores)
    return np.concatenate(all_tracks, axis=1), np.concatenate(all_vis, axis=1), np.concatenate(all_scores, axis=1)
