"""NumPy quaternion (wxyz) <-> rotation matrix.

Copy of `posecnn_tpu/utils/quaternion_np.py`: `quat2mat` and `mat2quat`
(the transforms3d convention: Bar-Itzhack's method, w >= 0), `qmult` and
`qinverse`.
"""

from __future__ import annotations

import numpy as np


def quat2mat(q) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    n = np.dot(q, q)
    if n < 1e-12:
        return np.eye(3)
    q = q * np.sqrt(2.0 / n)
    q = np.outer(q, q)
    return np.array(
        [
            [1.0 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0]],
            [q[1, 2] + q[3, 0], 1.0 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0]],
            [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1.0 - q[1, 1] - q[2, 2]],
        ]
    )


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


def qmult(q1, q2) -> np.ndarray:
    """Hamilton product of two wxyz quaternions."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def qinverse(q) -> np.ndarray:
    """The inverse quaternion (float64): the conjugate over the squared norm."""
    q = np.asarray(q, dtype=np.float64)
    return np.array([q[0], -q[1], -q[2], -q[3]]) / np.dot(q, q)
