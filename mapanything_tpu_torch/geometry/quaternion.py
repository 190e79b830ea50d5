"""Quaternion rotation for the port (``quat_rotate`` of
``mapanything_tpu/geometry/quaternion.py`` :124). XYZW order."""

from __future__ import annotations

import torch


def quat_rotate(quat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (..., 3) by unit quaternions (..., 4), broadcasting.

    v + 2 w (q x v) + 2 q x (q x v), with q the vector part.
    """
    qvec, w = quat[..., :3], quat[..., 3:4]
    qvec, vec = torch.broadcast_tensors(qvec, vec)
    uv = torch.linalg.cross(qvec, vec, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return vec + 2.0 * (w * uv + uuv)
