"""Rigid transforms in numpy: the port's copy of
`posecnn_tpu/utils/se3.py:se3_mul`."""

from __future__ import annotations

import numpy as np


def se3_mul(RT1: np.ndarray, RT2: np.ndarray) -> np.ndarray:
    """Compose rigid transforms: RT1 @ RT2 (3x4 each)."""
    R1, T1 = RT1[..., 0:3, 0:3], RT1[..., 0:3, 3:4]
    R2, T2 = RT2[..., 0:3, 0:3], RT2[..., 0:3, 3:4]
    return np.concatenate([np.matmul(R1, R2), np.matmul(R1, T2) + T1], axis=-1)
