"""Differentiable pose math: quaternion <-> rotation matrix, 7-dof poses.

Counterpart of `unislam_tpu/core/pose.py`. A pose is `[qw, qx, qy, qz, tx,
ty, tz]` (wxyz quaternion first); both conversions are branch-free.
"""

from __future__ import annotations

import torch


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) [w, x, y, z], normalised internally -> (..., 3, 3)."""
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(quat.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) [w, x, y, z] with w >= 0: the candidate
    built from the largest of the four squared components is kept."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    sw = _safe_sqrt(qw2)
    cand_w = torch.stack(
        [0.5 * sw, 0.5 * (m21 - m12) / sw, 0.5 * (m02 - m20) / sw,
         0.5 * (m10 - m01) / sw], dim=-1)
    sx = _safe_sqrt(qx2)
    cand_x = torch.stack(
        [0.5 * (m21 - m12) / sx, 0.5 * sx, 0.5 * (m01 + m10) / sx,
         0.5 * (m02 + m20) / sx], dim=-1)
    sy = _safe_sqrt(qy2)
    cand_y = torch.stack(
        [0.5 * (m02 - m20) / sy, 0.5 * (m01 + m10) / sy, 0.5 * sy,
         0.5 * (m12 + m21) / sy], dim=-1)
    sz = _safe_sqrt(qz2)
    cand_z = torch.stack(
        [0.5 * (m10 - m01) / sz, 0.5 * (m02 + m20) / sz,
         0.5 * (m12 + m21) / sz, 0.5 * sz], dim=-1)

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    sel = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, sel)[..., 0, :]
    return torch.where(q[..., :1] < 0, -q, q)


def cam_pose_to_matrix(pose7: torch.Tensor) -> torch.Tensor:
    """(B, 7) [quat(wxyz), t] -> (B, 4, 4) c2w matrices."""
    rot = quaternion_to_matrix(pose7[..., :4])
    # [0, 0, 0, 1] made on pose7's device: a host tensor copied there
    # would make the host wait for the device once per call
    bottom = torch.cat([torch.zeros_like(pose7[..., None, :3]),
                        torch.ones_like(pose7[..., None, :1])], dim=-1)
    top = torch.cat([rot, pose7[..., 4:, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def matrix_to_cam_pose(c2w: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) c2w matrices -> (B, 7) [quat(wxyz), t]."""
    return torch.cat([matrix_to_quaternion(c2w[..., :3, :3]),
                      c2w[..., :3, 3]], dim=-1)
