"""Quaternion math (w, x, y, z convention) on tensors.

Port of `posecnn_tpu/utils/quaternion.py:quat2mat` and `mat2quat`.
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
