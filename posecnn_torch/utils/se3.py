"""Rigid transforms: the port's copies of `posecnn_tpu/utils/se3.py:se3_mul`
and `se3_inverse` (numpy) and `transform_points` (numpy or torch)."""

from __future__ import annotations

import numpy as np


def se3_mul(RT1: np.ndarray, RT2: np.ndarray) -> np.ndarray:
    """Compose rigid transforms: RT1 @ RT2 (3x4 each)."""
    R1, T1 = RT1[..., 0:3, 0:3], RT1[..., 0:3, 3:4]
    R2, T2 = RT2[..., 0:3, 0:3], RT2[..., 0:3, 3:4]
    return np.concatenate([np.matmul(R1, R2), np.matmul(R1, T2) + T1], axis=-1)


def se3_inverse(RT: np.ndarray) -> np.ndarray:
    """Inverse of a rigid transform [R|t] (3x4): [R^T | -R^T t]."""
    R = RT[..., 0:3, 0:3]
    T = RT[..., 0:3, 3:4]
    Rt = np.swapaxes(R, -1, -2)
    return np.concatenate([Rt, -np.matmul(Rt, T)], axis=-1)


def transform_points(RT, pts):
    """Apply (..., 3, 4) transforms to (..., P, 3) points -> (..., P, 3);
    numpy arrays or torch tensors."""
    R, T = RT[..., 0:3, 0:3], RT[..., 0:3, 3]
    Rt = R.transpose(-1, -2) if not isinstance(RT, np.ndarray) else np.swapaxes(R, -1, -2)
    return pts @ Rt + T[..., None, :]
