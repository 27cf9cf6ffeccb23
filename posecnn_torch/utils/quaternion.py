"""Quaternion math (w, x, y, z convention) on tensors.

Port of `posecnn_tpu/utils/quaternion.py`: `quat2mat`, `mat2quat`, and the
Hamilton product `qmult`, `qconj`, `rotate_points` and `quat_angle`.
"""

from __future__ import annotations

import torch


def quat2mat(q: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix (unit norm
    assumed unless `normalize`, as in the JAX version)."""
    if normalize:
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    s, u, v, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = s * s + u * u - v * v - w * w
    r01 = 2 * (u * v - s * w)
    r02 = 2 * (u * w + s * v)
    r10 = 2 * (u * v + s * w)
    r11 = s * s - u * u + v * v - w * w
    r12 = 2 * (v * w - s * u)
    r20 = 2 * (u * w - s * v)
    r21 = 2 * (v * w + s * u)
    r22 = s * s - u * u - v * v + w * w
    rows = [
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def mat2quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz unit quaternion with
    w >= 0, batched and branchless (Shepperd's method): all four candidate
    quaternions are formed and the best-conditioned one is kept."""
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    q0 = torch.stack([1.0 + t, m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]],
                     dim=-1)
    q1 = torch.stack([m[..., 2, 1] - m[..., 1, 2], 1.0 + m00 - m11 - m22, m[..., 0, 1] + m[..., 1, 0],
                      m[..., 0, 2] + m[..., 2, 0]], dim=-1)
    q2 = torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0], 1.0 + m11 - m00 - m22,
                      m[..., 1, 2] + m[..., 2, 1]], dim=-1)
    q3 = torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0], m[..., 1, 2] + m[..., 2, 1],
                      1.0 + m22 - m00 - m11], dim=-1)
    scores = torch.stack([1.0 + t, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    return torch.where(q[..., :1] < 0, -q, q)


def qmult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) wxyz quaternions."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def rotate_points(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) points rotated by (..., 4) quaternions."""
    return torch.einsum("...ij,...pj->...pi", quat2mat(q), pts)


def quat_angle(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """The rotation angle between two unit quaternions, in radians."""
    d = (q1 * q2).sum(dim=-1).abs()
    return 2.0 * torch.arccos(torch.clamp(d, -1.0, 1.0))
