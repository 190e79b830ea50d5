"""Global alignment of pairwise pointmaps of the port: the closed-form head.

Counterpart of ``mapanything_tpu/ba/global_alignment.py``: ``PairGraph`` (:51),
``make_complete_pairs`` (:66) and ``weighted_umeyama`` (:75-95), the parts the
feed-forward baselines (MUSt3R, Pow3R) register their pointmaps with. The Adam
refinement (``global_align``, :141) and the rest of the module come with bundle
adjustment (ROADMAP section 1, item 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


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
