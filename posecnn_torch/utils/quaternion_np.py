"""NumPy rotation matrix -> quaternion (wxyz).

Copy of `posecnn_tpu/utils/quaternion_np.py:mat2quat` (the transforms3d
convention: Bar-Itzhack's method, w >= 0).
"""

from __future__ import annotations

import numpy as np


def mat2quat(M) -> np.ndarray:
    M = np.asarray(M, dtype=np.float64)
    Qxx, Qyx, Qzx = M[0, 0], M[0, 1], M[0, 2]
    Qxy, Qyy, Qzy = M[1, 0], M[1, 1], M[1, 2]
    Qxz, Qyz, Qzz = M[2, 0], M[2, 1], M[2, 2]
    K = (
        np.array(
            [
                [Qxx - Qyy - Qzz, 0, 0, 0],
                [Qyx + Qxy, Qyy - Qxx - Qzz, 0, 0],
                [Qzx + Qxz, Qzy + Qyz, Qzz - Qxx - Qyy, 0],
                [Qyz - Qzy, Qzx - Qxz, Qxy - Qyx, Qxx + Qyy + Qzz],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q
