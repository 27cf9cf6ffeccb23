"""Per-image meta data row.

Copy of `posecnn_tpu/data/minibatch.py:build_meta_data` (that module imports
cv2, which the port does not need).
"""

from __future__ import annotations

import numpy as np


def build_meta_data(K: np.ndarray, im_scale: float = 1.0, flip_x: bool = False) -> np.ndarray:
    """(48,) float32: K (row-major) in [0:9], its pseudo-inverse in [9:18]."""
    K = np.asarray(K, dtype=np.float64) * im_scale
    K[2, 2] = 1
    Kinv = np.linalg.pinv(K)
    mdata = np.zeros(48, dtype=np.float32)
    mdata[0:9] = K.flatten()
    mdata[9:18] = np.asarray(Kinv).flatten()
    if flip_x:
        mdata[0] *= -1
        mdata[9] *= -1
        mdata[11] *= -1
    return mdata
