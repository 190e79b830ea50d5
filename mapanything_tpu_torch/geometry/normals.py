"""Normal maps and edge masks from pointmaps and depths, for the port.

Counterparts of ``mapanything_tpu/geometry/normals.py``: ``_max_pool_2d``
(:16), ``depth_edge`` (:28), ``points_to_normals`` (:61), ``normals_edge``
(:124) and ``angle_diff_vec3`` (:169). They run on the tensors' device, so the inference postprocess stays
there.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _max_pool_2d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Same-size max pool, stride 1, over the last two dims of a float tensor;
    the border is padded with -inf."""
    h, w = x.shape[-2:]
    pooled = F.max_pool2d(x.reshape(-1, 1, h, w), kernel_size, stride=1, padding=kernel_size // 2)
    return pooled.reshape(x.shape)


def depth_edge(
    depth: torch.Tensor,
    atol: Optional[float] = None,
    rtol: Optional[float] = None,
    kernel_size: int = 3,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pixels whose k x k neighbourhood spans a large depth range (..., H, W).

    ``atol``/``rtol``: absolute or relative (to the pixel's depth) range
    limits, either or both. Pixels outside ``mask`` are left out of the
    neighbourhood's extrema.
    """
    if mask is None:
        diff = _max_pool_2d(depth, kernel_size) + _max_pool_2d(-depth, kernel_size)
    else:
        neg_inf = torch.full_like(depth, -math.inf)
        diff = _max_pool_2d(torch.where(mask, depth, neg_inf), kernel_size) + _max_pool_2d(
            torch.where(mask, -depth, neg_inf), kernel_size
        )
    edge = torch.zeros(depth.shape, dtype=torch.bool, device=depth.device)
    if atol is not None:
        edge |= diff > atol
    if rtol is not None:
        edge |= diff / torch.where(depth == 0, torch.full_like(depth, math.inf), depth) > rtol
    return edge


def points_to_normals(
    point: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit normals (..., H, W, 3) of a pointmap (..., H, W, 3) from the cross
    products of its four neighbours, and where a normal exists (..., H, W).

    ``mask`` (..., H, W) marks valid points; the border counts as invalid.
    """
    mask = torch.ones(point.shape[:-1], dtype=torch.bool, device=point.device) if mask is None else mask
    pts = F.pad(point, (0, 0, 1, 1, 1, 1))
    mk = F.pad(mask, (1, 1, 1, 1))

    center = pts[..., 1:-1, 1:-1, :]
    up = pts[..., :-2, 1:-1, :] - center
    left = pts[..., 1:-1, :-2, :] - center
    down = pts[..., 2:, 1:-1, :] - center
    right = pts[..., 1:-1, 2:, :] - center
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)  # noqa: E731  (a x b sets the sign)
    normals = torch.stack([cross(up, left), cross(left, down), cross(down, right), cross(right, up)], dim=0)
    normals = normals / (torch.linalg.norm(normals, dim=-1, keepdim=True) + 1e-12)

    m_up, m_left = mk[..., :-2, 1:-1], mk[..., 1:-1, :-2]
    m_down, m_right = mk[..., 2:, 1:-1], mk[..., 1:-1, 2:]
    valid = torch.stack(
        [m_up & m_left, m_left & m_down, m_down & m_right, m_right & m_up], dim=0
    ) & mk[..., 1:-1, 1:-1][None]

    normal = torch.sum(normals * valid[..., None], dim=0)
    normal = normal / (torch.linalg.norm(normal, dim=-1, keepdim=True) + 1e-12)
    normal_mask = torch.any(valid, dim=0)
    return torch.where(normal_mask[..., None], normal, torch.zeros_like(normal)), normal_mask


def _edge_pad(x: torch.Tensor, pad: int, h_dim: int) -> torch.Tensor:
    """Pad dims ``h_dim`` and ``h_dim + 1`` (H, W) by repeating their edge
    values, as ``jnp.pad(mode="edge")``; any dtype, bool included."""
    for dim in (h_dim, h_dim + 1):
        n = x.shape[dim]
        idx = torch.arange(-pad, n + pad, device=x.device).clamp(0, n - 1)
        x = x.index_select(dim, idx)
    return x


def normals_edge(
    normals: torch.Tensor,
    tol_deg: float,
    kernel_size: int = 3,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pixels (..., H, W) where the normal turns by more than ``tol_deg``
    within a k x k window: the largest angle between each pixel's normal and
    its neighbours' (edge-padded; only neighbours inside ``mask`` count),
    max-pooled over the window."""
    normals = normals / (torch.linalg.norm(normals, dim=-1, keepdim=True) + 1e-12)
    pad = kernel_size // 2
    h, w = normals.shape[-3:-1]
    padded = _edge_pad(normals, pad, normals.dim() - 3)
    mask_pad = None if mask is None else _edge_pad(mask, pad, mask.dim() - 2)
    max_angle = torch.zeros(normals.shape[:-1], dtype=normals.dtype, device=normals.device)
    for di in range(kernel_size):
        for dj in range(kernel_size):
            shifted = padded[..., di:di + h, dj:dj + w, :]
            angle = torch.arccos(torch.clamp(torch.sum(normals * shifted, dim=-1), -1.0, 1.0))
            if mask_pad is not None:
                angle = torch.where(mask_pad[..., di:di + h, dj:dj + w], angle, torch.zeros_like(angle))
            max_angle = torch.maximum(max_angle, angle)
    return _max_pool_2d(max_angle, kernel_size) > math.radians(tol_deg)


def angle_diff_vec3(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The angle between 3-vectors (..., 3): atan2(|v1 x v2|, v1 · v2 + eps)."""
    cross = torch.linalg.norm(torch.linalg.cross(v1, v2, dim=-1), dim=-1)
    return torch.atan2(cross, torch.sum(v1 * v2, dim=-1) + eps)
