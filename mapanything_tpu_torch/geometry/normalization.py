"""Norms for the port's geometry (``safe_norm`` of
``mapanything_tpu/geometry/normalization.py`` :14)."""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim=-1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm that is exactly 0 at the origin, with a 0 gradient there."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    zero = sq == 0
    root = torch.sqrt(torch.where(zero, torch.ones_like(sq), sq))
    return torch.where(zero, torch.zeros_like(root), root)
