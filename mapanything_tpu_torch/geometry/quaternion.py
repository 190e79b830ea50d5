"""Quaternion algebra for the port, XYZW (scalar last).

Counterparts of ``mapanything_tpu/geometry/quaternion.py``: ``quat_normalize``
(:19), ``quat_to_rotmat`` (:26), ``_sqrt_positive_part`` (:49),
``rotmat_to_quat`` (:56), ``quat_standardize`` (:101), ``quat_inverse``
(:106), ``quat_multiply`` (:113), ``quat_rotate`` (:124),
``relative_pose_quats_trans`` (:137), ``quats_trans_to_pose_matrix`` (:161)
and ``pose_matrix_to_quats_trans`` (:172). Every function broadcasts over
leading dimensions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mapanything_tpu_torch.geometry.normalization import safe_norm


def quat_normalize(quat: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-norm quaternions (..., 4); the norm is floored at ``eps``."""
    return quat / torch.clamp(safe_norm(quat, dim=-1, keepdim=True), min=eps)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """XYZW quaternions (..., 4), normalised first, to rotation matrices (..., 3, 3)."""
    x, y, z, w = quat_normalize(quat).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rot = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return rot.reshape(quat.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x == 0."""
    positive = x > 0
    root = torch.sqrt(torch.where(positive, x, torch.ones_like(x)))
    return torch.where(positive, root, torch.zeros_like(x))


def rotmat_to_quat(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) to XYZW quaternions (..., 4), w >= 0.

    The quaternion is computed through each of four candidate denominators
    and the best-conditioned one (the largest of the four square roots; the
    first on a tie, as ``jnp.argmax``) is selected by a one-hot sum.
    """
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = matrix.reshape(matrix.shape[:-2] + (9,)).unbind(-1)
    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        )
    )
    # Candidates in WXYZ order, each scaled by 2 q_abs[i].
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    onehot = torch.eye(4, dtype=matrix.dtype, device=matrix.device)[torch.argmax(q_abs, dim=-1)]
    wxyz = torch.sum(candidates * onehot[..., None], dim=-2)
    return quat_standardize(wxyz[..., [1, 2, 3, 0]])


def quat_standardize(quat: torch.Tensor) -> torch.Tensor:
    """Flip each quaternion whose real part w is negative."""
    return torch.where(quat[..., 3:4] < 0, -quat, quat)


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


def quats_trans_to_pose_matrix(quats: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """4x4 cam2world matrices (..., 4, 4) from XYZW quaternions and translations."""
    rot = quat_to_rotmat(quats)
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = rot.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(rot.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def pose_matrix_to_quats_trans(pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """4x4 (or 3x4) cam2world matrices to (XYZW quaternions, translations)."""
    return rotmat_to_quat(pose[..., :3, :3]), pose[..., :3, 3]
