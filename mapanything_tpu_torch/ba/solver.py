"""Bundle adjustment of the port: Schur-complement Gauss-Newton with CG, in torch.

Counterpart of ``mapanything_tpu/ba/solver.py``: ``_exp_so3`` (:34), ``_project``
(:53), ``_huber_weight`` (:70), ``BAState`` (:76), ``_build_system`` (:82),
``_schur_solve`` (:114), ``_apply_update`` (:206), ``_total_cost`` (:214),
``_gauss_newton_loop`` (:218), ``ba_solve`` (:262), ``ba_solve_sharded`` (:279) and
``refined_camera_poses`` (:355).

The problem: pinhole reprojection residuals of N tracks in M cameras, a static
(N, M) layout with validity masks, Huber-robustified (IRLS weights); Levenberg-
Marquardt-damped normal equations reduced by the Schur complement (3x3 point blocks
inverted in closed form), the reduced camera system solved matrix-free by
Jacobi-preconditioned CG; rotations updated on the manifold by left increments
exp(w) R. The first camera is held by a strong prior inside the system (the gauge).
A step is taken only if it lowers the cost; lambda halves on a taken step and grows
4x on a refused one, clamped to [1e-8, 1e4]. Everything stays on the tracks' device
(no host synchronisation inside the loop).

The Jacobian blocks at the linearisation point (rot_delta = 0), which the JAX package
takes from ``jax.jacfwd``, are written in closed form: d(exp(w) y)/dw at w = 0 is
-[y]x, since ``_exp_so3``'s Taylor guard (kept here) makes R = I + K + K^2/2 near 0,
whose derivative there is that of K. ``ba_solve_sharded`` splits the track axis over a
``torch.distributed`` group: per-track work stays on its rank and the camera-sized
products (Hcc, the reduced right-hand side, each CG product, the costs) are completed
by ``all_reduce``, as ``psum`` completes them in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from mapanything_tpu_torch.ba.tracks import Tracks


def _skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices [w]x."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices by Rodrigues, R = I + A K + B K^2 with
    K = [w]x, A = sin(t)/t and B = (1 - cos t)/t^2 switching to their series near t = 0
    (a hard switch to I there would zero the derivative at the linearisation point)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-24)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))
    K = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def _project(K: torch.Tensor, R: torch.Tensor, trans: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) of world points in cameras x = R X + t (w2c), u = K x / z."""
    x = (R @ point[..., None])[..., 0] + trans
    z = torch.clamp(x[..., 2], min=1e-6)
    u = K[..., 0, 0] * x[..., 0] / z + K[..., 0, 2]
    v = K[..., 1, 1] * x[..., 1] / z + K[..., 1, 2]
    return torch.stack([u, v], -1)


def _huber_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight sqrt(w) of the Huber loss on a squared residual norm."""
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    return torch.where(r <= delta, torch.ones_like(r), torch.sqrt(delta / r))


@dataclasses.dataclass
class BAState:
    rot: torch.Tensor  # (M, 3, 3) current w2c rotations
    trans: torch.Tensor  # (M, 3)
    points: torch.Tensor  # (N, 3)


def _build_system(tracks: Tracks, state: BAState, huber_delta: float):
    """Huber-weighted residuals r (N, M, 2) and Jacobian blocks Jc (N, M, 2, 6) (rotation
    increment, then translation) and Jp (N, M, 2, 3), at rot_delta = 0."""
    K = tracks.intrinsics[None]  # (1, M, 3, 3)
    R = state.rot[None]  # (1, M, 3, 3)
    y = (R @ state.points[:, None, :, None])[..., 0]  # R X, (N, M, 3)
    x = y + state.trans[None]
    z_raw = x[..., 2]
    z = torch.clamp(z_raw, min=1e-6)
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    r = torch.stack([fx * x[..., 0] / z + cx, fy * x[..., 1] / z + cy], -1) - tracks.observations_uv
    # d(u, v)/dx: the clamp passes no derivative to z below 1e-6.
    dz = (z_raw > 1e-6).to(x.dtype)
    zero = torch.zeros_like(z)
    J = torch.stack([
        torch.stack([fx / z, zero, -fx * x[..., 0] / (z * z) * dz], -1),
        torch.stack([zero, fy / z, -fy * x[..., 1] / (z * z) * dz], -1),
    ], -2)  # (N, M, 2, 3)
    Jrot = J @ (-_skew(y))
    Jp = J @ R
    Jc = torch.cat([Jrot, J], -1)
    w = _huber_weight((r * r).sum(-1), huber_delta) * tracks.valid.to(r.dtype)
    sw = w[..., None]
    return r * sw, Jc * sw[..., None], Jp * sw[..., None]


def _batched_diag(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1)


def _schur_solve(r, Jc, Jp, lm_lambda, cg_iters: int, fix_first_cam: bool = True,
                 reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """The damped normal equations by Schur reduction and CG: (delta_cam (M, 6),
    delta_pts (N, 3)). With ``reduce`` (``ba_solve_sharded``), N is this rank's tracks
    and every track-contracted product is completed by it."""
    red = reduce or (lambda x: x)
    Hpp = torch.einsum("nmki,nmkj->nij", Jp, Jp)
    Hcc = red(torch.einsum("nmki,nmkj->mij", Jc, Jc))
    Hcp = torch.einsum("nmki,nmkj->nmij", Jc, Jp)
    bc = -red(torch.einsum("nmki,nmk->mi", Jc, r))
    bp = -torch.einsum("nmki,nmk->ni", Jp, r)

    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    eye6 = torch.eye(6, dtype=r.dtype, device=r.device)
    # Multiplicative (Marquardt) damping.
    Hpp = Hpp + lm_lambda * torch.diag_embed(torch.clamp(_batched_diag(Hpp), min=1e-6)) + 1e-8 * eye3
    Hcc = Hcc + lm_lambda * torch.diag_embed(torch.clamp(_batched_diag(Hcc), min=1e-6)) + 1e-8 * eye6
    if fix_first_cam:
        Hcc = torch.cat([Hcc[:1] + 1e12 * eye6, Hcc[1:]])
        bc = torch.cat([torch.zeros_like(bc[:1]), bc[1:]])
    Hpp_inv = torch.linalg.inv(Hpp)

    hinv_bp = torch.einsum("nij,nj->ni", Hpp_inv, bp)
    b_red = bc - red(torch.einsum("nmij,nj->mi", Hcp, hinv_bp))

    def s_matvec(v):
        hv = torch.einsum("mij,mj->mi", Hcc, v)
        t = torch.einsum("nmji,mj->ni", Hcp, v)
        t = torch.einsum("nij,nj->ni", Hpp_inv, t)
        return hv - red(torch.einsum("nmij,nj->mi", Hcp, t))

    diag = torch.clamp(_batched_diag(Hcc), min=1e-8)
    x = torch.zeros_like(b_red)
    rr = b_red
    p = rr / diag
    rz = (rr * p).sum()
    for _ in range(cg_iters):
        Ap = s_matvec(p)
        alpha = rz / torch.clamp((p * Ap).sum(), min=1e-12)
        x = x + alpha * p
        rr = rr - alpha * Ap
        z = rr / diag
        rz_new = (rr * z).sum()
        beta = rz_new / torch.clamp(rz, min=1e-12)
        p = z + beta * p
        rz = rz_new

    hpc_dc = torch.einsum("nmji,mj->ni", Hcp, x)
    delta_pts = torch.einsum("nij,nj->ni", Hpp_inv, bp - hpc_dc)
    return x, delta_pts


def _apply_update(state: BAState, delta_cam, delta_pts, fix_first_cam: bool) -> BAState:
    if fix_first_cam:
        delta_cam = torch.cat([torch.zeros_like(delta_cam[:1]), delta_cam[1:]])
    return BAState(rot=_exp_so3(delta_cam[:, :3]) @ state.rot, trans=state.trans + delta_cam[:, 3:],
                   points=state.points + delta_pts)


def _total_cost(tracks: Tracks, state: BAState, huber_delta: float, reduce=None) -> torch.Tensor:
    r, _, _ = _build_system(tracks, state, huber_delta)
    cost = (r * r).sum()
    return reduce(cost) if reduce is not None else cost


def _gauss_newton_loop(tracks: Tracks, num_iterations: int, cg_iters: int, huber_delta: float,
                       fix_first_cam: bool, lm_lambda: float, reduce=None) -> Tuple[BAState, torch.Tensor]:
    """The GN/LM loop; with ``reduce`` ``tracks`` is this rank's block of tracks."""
    state = BAState(rot=tracks.cam_from_world_rot, trans=tracks.cam_from_world_trans, points=tracks.points3d)
    lam = torch.tensor(lm_lambda, dtype=tracks.points3d.dtype, device=tracks.points3d.device)
    costs: List[torch.Tensor] = []
    for _ in range(num_iterations):
        r, Jc, Jp = _build_system(tracks, state, huber_delta)
        delta_cam, delta_pts = _schur_solve(r, Jc, Jp, lam, cg_iters, fix_first_cam, reduce)
        new_state = _apply_update(state, delta_cam, delta_pts, fix_first_cam)
        old_cost = (r * r).sum()
        if reduce is not None:
            old_cost = reduce(old_cost)
        new_cost = _total_cost(tracks, new_state, huber_delta, reduce)
        improved = new_cost < old_cost
        # Levenberg's lambda; a step that raises the cost is refused.
        state = BAState(*(torch.where(improved, new, old) for new, old in
                          zip(dataclasses.astuple(new_state), dataclasses.astuple(state))))
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        costs.append(new_cost)
    return state, torch.stack(costs)


def ba_solve(tracks: Tracks, num_iterations: int = 10, cg_iters: int = 20, huber_delta: float = 2.0,
             fix_first_cam: bool = True, lm_lambda: float = 1e-3) -> Tuple[BAState, torch.Tensor]:
    """Gauss-Newton BA on the tracks' device: (refined state, cost after each iteration)."""
    with torch.no_grad():
        return _gauss_newton_loop(tracks, num_iterations, cg_iters, huber_delta, fix_first_cam, lm_lambda)


def ba_solve_sharded(tracks: Tracks, group=None, num_iterations: int = 10, cg_iters: int = 20,
                     huber_delta: float = 2.0, fix_first_cam: bool = True,
                     lm_lambda: float = 1e-3) -> Tuple[BAState, torch.Tensor]:
    """``ba_solve`` with the track axis split over the ranks of ``group`` (a joined
    ``torch.distributed`` group; the default group when None). Every rank passes the same
    ``tracks``; each solves its block of N / world tracks (tracks padded with invalid
    observations, which weigh nothing, up to a multiple of the world size), the camera
    system's sums completed by ``all_reduce``, and all get the whole state back."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    N = tracks.valid.shape[0]
    pad = (-N) % world
    if pad:
        def pad_n(x):
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

        tracks = dataclasses.replace(tracks, points3d=pad_n(tracks.points3d),
                                     observations_uv=pad_n(tracks.observations_uv), valid=pad_n(tracks.valid))
    n = (N + pad) // world
    local = dataclasses.replace(tracks, points3d=tracks.points3d[rank * n:(rank + 1) * n],
                                observations_uv=tracks.observations_uv[rank * n:(rank + 1) * n],
                                valid=tracks.valid[rank * n:(rank + 1) * n])

    def reduce(x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    with torch.no_grad():
        state, costs = _gauss_newton_loop(local, num_iterations, cg_iters, huber_delta, fix_first_cam, lm_lambda,
                                          reduce)
        blocks = [torch.empty_like(state.points) for _ in range(world)]
        dist.all_gather(blocks, state.points.contiguous(), group=group)
    return dataclasses.replace(state, points=torch.cat(blocks)[:N]), costs


def refined_camera_poses(state: BAState) -> torch.Tensor:
    """BA state -> (M, 4, 4) cam2world poses."""
    rot_c2w = state.rot.transpose(-1, -2)
    t_c2w = -torch.einsum("mij,mj->mi", rot_c2w, state.trans)
    top = torch.cat([rot_c2w, t_c2w[..., None]], -1)
    bottom = torch.tensor([0.0, 0, 0, 1], dtype=state.rot.dtype, device=state.rot.device).expand(
        state.rot.shape[0], 1, 4)
    return torch.cat([top, bottom], -2)
