"""Global alignment of pairwise pointmaps of the port (DUSt3R's ``cloud_opt``).

Counterpart of ``mapanything_tpu/ba/global_alignment.py``: ``PairGraph`` (:51),
``make_complete_pairs`` (:66), ``weighted_umeyama`` (:75-95), ``_spanning_tree`` (:98),
``AlignedScene`` (:131) and ``global_align`` (:141).

For directed edges e = (i, j) with pair pointmaps X_e^i, X_e^j (both in frame i) and
confidences C, the objective is

    L = sum_e mean[log C_e^i |P_i D_i - s_e (R_e X_e^i + t_e)|] + (the same for j),

P_v D_v the world pointmap of view v from its depth, focal (principal point at the
image centre) and pose. Parameters: per view a quaternion, a translation, a log-focal
and a log-depth map; per edge a quaternion, a translation and a log-scale (recentred to
mean 0). The initialisation runs on the host in numpy, as the JAX package runs it: each
view's focal from its most confident rooted edge (``np.median``, which averages the two
middle values), a maximum spanning tree over the mean edge confidences
(``np.argsort(-scores)`` decides ties) chaining weighted Umeyama similarities, the
scale stripped into the depths. Then Adam on the device, written out as optax's
``adam(cosine_decay_schedule(lr, niter), b1=0.9, b2=0.9)`` computes it: the schedule
read at the step count before the update (step 0 takes ``lr``), bias-corrected moments,
eps 1e-8 outside the square root; view 0's pose gradients are zeroed (the gauge).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mapanything_tpu_torch.geometry.quaternion import quat_rotate, quat_to_rotmat, rotmat_to_quat


@dataclass
class PairGraph:
    """Stacked directed pair predictions over ``num_views`` views: ``edges`` (E, 2) int
    (i, j); ``pts_i``/``pts_j`` (E, H, W, 3) pair pointmaps in frame i;
    ``conf_i``/``conf_j`` (E, H, W) confidences (>= 1)."""

    num_views: int
    edges: np.ndarray
    pts_i: torch.Tensor
    pts_j: torch.Tensor
    conf_i: torch.Tensor
    conf_j: torch.Tensor


def make_complete_pairs(num_views: int) -> np.ndarray:
    """Every ordered pair (i, j), i != j, row-major: the symmetrised complete graph."""
    return np.asarray([(i, j) for i in range(num_views) for j in range(num_views) if i != j], np.int32)


def weighted_umeyama(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The weighted similarity (s, R, t) with dst ≈ s·R·src + t, over points src and
    dst (..., N, 3) with weights w (..., N) >= 0, batched over the leading axes: the
    SVD of the weighted cross-covariance with the sign of its determinant folded into
    the last singular direction, so R is a rotation (a reflection never). The SVD's
    signs cancel in R and s."""
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    mu_s = torch.sum(src * w[..., None], dim=-2)
    mu_d = torch.sum(dst * w[..., None], dim=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = (dc * w[..., None]).transpose(-1, -2) @ sc
    u, s, vh = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vh)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (u * d[..., None, :]) @ vh
    var_s = torch.sum(w * torch.sum(sc * sc, dim=-1), dim=-1)
    scale = torch.sum(s * d, dim=-1) / torch.clamp(var_s, min=1e-12)
    t = mu_d - scale[..., None] * (R @ mu_s[..., None])[..., 0]
    return scale, R, t


def _spanning_tree(num_views: int, edges: np.ndarray, scores: np.ndarray):
    """Maximum-score spanning tree: (root, [(parent, child, edge index)] in the order
    taken), Prim's from the view of the strongest edge."""
    order = np.argsort(-scores)
    root = int(edges[order[0]][0])
    seen = {root}
    tree = []
    while len(seen) < num_views:
        best = None
        for rank in order:
            i, j = int(edges[rank][0]), int(edges[rank][1])
            if (i in seen) != (j in seen):
                best = (i, j, int(rank)) if i in seen else (j, i, int(rank))
                break
        if best is None:  # a disconnected graph: attach the next view as it is
            rest = sorted(set(range(num_views)) - seen)
            tree.append((root, rest[0], -1))
            seen.add(rest[0])
            continue
        tree.append(best)
        seen.add(best[1])
    return root, tree


@dataclass
class AlignedScene:
    """The optimisation's result."""

    focals: np.ndarray  # (V,)
    intrinsics: np.ndarray  # (V, 3, 3)
    cam2world: np.ndarray  # (V, 4, 4)
    depthmaps: np.ndarray  # (V, H, W)
    loss: float


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _umeyama_np(src: np.ndarray, dst: np.ndarray, w: np.ndarray):
    s, R, t = weighted_umeyama(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (src, dst, w)))
    return float(s), R.numpy(), t.numpy()


def _init_params(graph: PairGraph) -> Dict[str, np.ndarray]:
    """The MST initialisation, in numpy: per-view quaternions, translations, log-focals and
    log-depths; per-edge transforms from their view i."""
    V = graph.num_views
    edges_np = graph.edges
    pts_i_np, pts_j_np = _numpy(graph.pts_i), _numpy(graph.pts_j)
    conf_i_np, conf_j_np = _numpy(graph.conf_i), _numpy(graph.conf_j)
    H, W = pts_i_np.shape[1:3]
    f32 = np.float32
    u = np.broadcast_to(np.arange(W, dtype=f32)[None, :], (H, W))
    v = np.broadcast_to(np.arange(H, dtype=f32)[:, None], (H, W))
    cx, cy = W / 2.0, H / 2.0
    r_pix = np.sqrt((u - f32(cx)) ** 2 + (v - f32(cy)) ** 2)

    focals0 = np.zeros(V, f32)
    depth0 = np.zeros((V, H, W), f32)
    for view in range(V):
        rooted = np.nonzero(edges_np[:, 0] == view)[0]
        if len(rooted) == 0:
            focals0[view] = 1.1 * max(H, W)
            depth0[view] = 1.0
            continue
        best = rooted[np.argmax(conf_i_np[rooted].mean(axis=(1, 2)))]
        pts = pts_i_np[best]
        f = pts[..., 2] * r_pix / np.maximum(np.sqrt(pts[..., 0] ** 2 + pts[..., 1] ** 2), f32(1e-9))
        mask = conf_i_np[best] > np.median(conf_i_np[best])
        fv = float(np.median(f[mask])) if mask.any() else float(np.median(f))
        if not np.isfinite(fv) or fv <= 0:  # degenerate pointmaps (z <= 0): a positive focal
            fv = 1.1 * max(H, W)
        focals0[view] = fv
        depth0[view] = np.maximum(pts[..., 2], 1e-4)

    scores = (conf_i_np.mean(axis=(1, 2)) + conf_j_np.mean(axis=(1, 2))) / 2
    _, tree = _spanning_tree(V, edges_np, scores)
    c2w0 = np.tile(np.eye(4, dtype=f32), (V, 1, 1))
    for parent, child, eidx in tree:
        if eidx < 0:
            continue
        i, j = int(edges_np[eidx][0]), int(edges_np[eidx][1])
        rooted_j = np.nonzero(edges_np[:, 0] == j)[0]
        if len(rooted_j) > 0:  # view j's own points: the self-view of an edge rooted at j
            src = pts_i_np[rooted_j[0]].reshape(-1, 3)
            w = conf_i_np[rooted_j[0]].reshape(-1)
        else:
            zz = depth0[j]
            src = np.stack([(u - cx) * zz / focals0[j], (v - cy) * zz / focals0[j], zz], -1).reshape(-1, 3)
            w = np.ones(H * W, f32)
        w = w * conf_j_np[eidx].reshape(-1)
        s, R, t = _umeyama_np(src, pts_j_np[eidx].reshape(-1, 3), w)
        T_ij = np.eye(4, dtype=f32)  # frame j -> frame i
        T_ij[:3, :3] = R * s
        T_ij[:3, 3] = t
        if parent == i:
            c2w0[j] = c2w0[i] @ T_ij
        else:
            Tinv = np.eye(4, dtype=f32)
            Tinv[:3, :3] = np.linalg.inv(R * s)
            Tinv[:3, 3] = -Tinv[:3, :3] @ t
            c2w0[i] = c2w0[j] @ Tinv

    quats0 = np.zeros((V, 4), f32)
    trans0 = np.zeros((V, 3), f32)
    for view in range(V):  # the scale goes from the rotations into the depths
        Rm = c2w0[view][:3, :3]
        s = np.cbrt(max(np.linalg.det(Rm), 1e-12))
        quats0[view] = rotmat_to_quat(torch.from_numpy(np.ascontiguousarray(Rm / s, dtype=f32))).numpy()
        trans0[view] = c2w0[view][:3, 3]
        depth0[view] = depth0[view] * s
    return {"quats": quats0, "trans": trans0, "log_focals": np.log(focals0),
            "log_depth": np.log(np.maximum(depth0, f32(1e-6))),
            "e_quats": quats0[edges_np[:, 0]], "e_trans": trans0[edges_np[:, 0]],
            "e_log_scale": np.zeros(len(edges_np), f32)}


def schedule_value(kind: str, lr: float, niter: int, step: torch.Tensor) -> torch.Tensor:
    """optax's ``cosine_decay_schedule(lr, niter)`` (``kind`` "cosine") or
    ``linear_schedule(lr, lr / 10, niter)`` at the fp32 step count ``step``."""
    t = torch.clamp(step, max=niter)
    if kind == "cosine":
        return lr * (0.5 * (1.0 + torch.cos(math.pi * t / niter)))
    return (lr - lr / 10.0) * (1.0 - t / niter) + lr / 10.0


def adam_run(params: Dict[str, torch.Tensor], loss_fn: Callable, lr: float, niter: int, b1: float, b2: float,
             frozen: Dict[str, Optional[int]], schedule: str = "cosine") -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``niter`` Adam steps on ``params`` (fp32 tensors, updated out of place), optax's
    arithmetic: the gradients of ``frozen`` (name -> row, or None for the whole tensor)
    zeroed first, moments m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g^2, bias
    correction at the step count t + 1, update -lr_t m^ / (sqrt(v^) + 1e-8) with lr_t
    the schedule at t. Returns the parameters and the loss before each step."""
    params = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    device = next(iter(params.values())).device
    losses = []
    for it in range(niter):
        for p in params.values():
            p.requires_grad_(True)
        loss = loss_fn(params)
        grads = {name: torch.zeros_like(params[name]) if g is None else g for name, g in  # unused: zero
                 zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True))}
        losses.append(loss.detach())
        with torch.no_grad():
            count = torch.tensor(float(it + 1), device=device)
            step_lr = schedule_value(schedule, lr, niter, count - 1)
            c1, c2 = 1 - b1**count, 1 - b2**count
            for name, g in grads.items():
                row = frozen.get(name, False)
                if row is None:
                    g = torch.zeros_like(g)
                elif row is not False:
                    g = torch.cat([g[:row], torch.zeros_like(g[row:row + 1]), g[row + 1:]])
                m[name] = b1 * m[name] + (1 - b1) * g
                v[name] = b2 * v[name] + (1 - b2) * g * g
                update = (m[name] / c1) / (torch.sqrt(v[name] / c2) + 1e-8)
                params[name] = (params[name].detach() - step_lr * update).detach()
    return params, torch.stack(losses)


def _unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


def global_align(graph: PairGraph, niter: int = 300, lr: float = 0.01, schedule: str = "cosine",
                 image_hw: Optional[Tuple[int, int]] = None) -> AlignedScene:
    """The MST initialisation, then ``niter`` Adam steps on the pair graph's device (with
    autograd on, also where the caller runs under ``torch.inference_mode``)."""
    with torch.inference_mode(False), torch.enable_grad():
        return _global_align(graph, niter, lr, schedule, image_hw)


def _on(x, device) -> torch.Tensor:
    """``x`` (a tensor, also one made under inference mode, or an array) as a new fp32
    tensor on ``device`` that autograd may save."""
    return (x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(_numpy(x))).to(
        device, torch.float32).clone()


def _global_align(graph: PairGraph, niter: int, lr: float, schedule: str, image_hw) -> AlignedScene:
    device = graph.pts_i.device if isinstance(graph.pts_i, torch.Tensor) else torch.device("cpu")
    H, W = graph.pts_i.shape[1:3]
    image_hw = image_hw or (H, W)
    edges_i = torch.as_tensor(graph.edges[:, 0], dtype=torch.int64, device=device)
    edges_j = torch.as_tensor(graph.edges[:, 1], dtype=torch.int64, device=device)
    as_dev = lambda x: _on(x, device)  # noqa: E731
    pts_i, pts_j = as_dev(graph.pts_i), as_dev(graph.pts_j)
    w_i = torch.log(torch.clamp(as_dev(graph.conf_i), min=1.0))
    w_j = torch.log(torch.clamp(as_dev(graph.conf_j), min=1.0))
    params0 = {k: torch.from_numpy(np.ascontiguousarray(x)).to(device) for k, x in _init_params(graph).items()}

    u = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    uv1 = torch.stack([u - W / 2.0, v - H / 2.0, torch.ones_like(u)], -1)

    def loss_fn(p):
        f = torch.exp(p["log_focals"])
        scale_xy = torch.stack([1.0 / f, 1.0 / f, torch.ones_like(f)], -1)
        pts_cam = uv1[None] * scale_xy[:, None, None, :] * torch.exp(p["log_depth"])[..., None]
        pts_world = quat_rotate(_unit(p["quats"])[:, None, None, :], pts_cam) + p["trans"][:, None, None, :]
        eq = _unit(p["e_quats"])[:, None, None, :]
        es = torch.exp(p["e_log_scale"] - p["e_log_scale"].mean())[:, None, None, None]

        def dist(view_pts, pts):
            d = view_pts - (es * quat_rotate(eq, pts) + p["e_trans"][:, None, None, :])
            return torch.sqrt((d * d).sum(-1) + 1e-12)

        return (w_i * dist(pts_world[edges_i], pts_i)).mean() + (w_j * dist(pts_world[edges_j], pts_j)).mean()

    params, losses = adam_run(params0, loss_fn, lr, niter, 0.9, 0.9, {"quats": 0, "trans": 0}, schedule)
    p = {k: x.cpu().numpy() for k, x in params.items()}
    f = np.exp(p["log_focals"])
    V = graph.num_views
    K = np.tile(np.eye(3, dtype=np.float32), (V, 1, 1))
    K[:, 0, 0] = f
    K[:, 1, 1] = f
    K[:, 0, 2] = image_hw[1] / 2.0
    K[:, 1, 2] = image_hw[0] / 2.0
    q = p["quats"] / np.linalg.norm(p["quats"], axis=-1, keepdims=True)
    c2w = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    c2w[:, :3, :3] = quat_to_rotmat(torch.from_numpy(q)).numpy()
    c2w[:, :3, 3] = p["trans"]
    return AlignedScene(focals=f, intrinsics=K, cam2world=c2w, depthmaps=np.exp(p["log_depth"]),
                        loss=float(losses[-1]))


__all__ = ["PairGraph", "AlignedScene", "make_complete_pairs", "weighted_umeyama", "global_align"]
