"""Quaternion algebra for the port, XYZW (scalar last).

Counterparts of ``mapanything_tpu/geometry/quaternion.py``: ``quat_inverse``
(:106), ``quat_multiply`` (:113), ``quat_rotate`` (:124) and
``relative_pose_quats_trans`` (:137). Every function broadcasts over leading
dimensions.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quat_inverse(quat: torch.Tensor) -> torch.Tensor:
    """Conjugate over the squared norm (floored at 1e-12). (..., 4) -> (..., 4)."""
    conj = quat * quat.new_tensor([-1.0, -1.0, -1.0, 1.0])
    sq_norm = torch.sum(quat * quat, dim=-1, keepdim=True)
    return conj / torch.clamp(sq_norm, min=1e-12)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 q2 of XYZW quaternions."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    return torch.stack([x, y, z, w], dim=-1)


def quat_rotate(quat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (..., 3) by unit quaternions (..., 4), broadcasting.

    v + 2 w (q x v) + 2 q x (q x v), with q the vector part.
    """
    qvec, w = quat[..., :3], quat[..., 3:4]
    qvec, vec = torch.broadcast_tensors(qvec, vec)
    uv = torch.linalg.cross(qvec, vec, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return vec + 2.0 * (w * uv + uuv)


def relative_pose_quats_trans(
    quats1: torch.Tensor, trans1: torch.Tensor, quats2: torch.Tensor, trans2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pose 2 (cam2world) expressed in pose 1's camera frame: (quats, trans)."""
    inv_q1 = quat_inverse(quats1)
    return quat_multiply(inv_q1, quats2), quat_rotate(inv_q1, trans2 - trans1)
