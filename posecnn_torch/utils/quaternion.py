"""Quaternion math (w, x, y, z convention) on tensors.

Port of `posecnn_tpu/utils/quaternion.py:quat2mat`.
"""

from __future__ import annotations

import torch


def quat2mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix (unit norm
    assumed, as in the JAX version's default)."""
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
