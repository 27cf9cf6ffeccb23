"""Host NMS.

Copy of `posecnn_tpu/ops/nms.py:nms_np` (that module imports jax at module
level, so the port keeps its own copy of the NumPy function).
"""

from __future__ import annotations

import numpy as np


def nms_np(dets: np.ndarray, thresh: float) -> np.ndarray:
    """dets: (N,5) [x1,y1,x2,y2,score] -> kept indices (descending score)."""
    if dets.size == 0:
        return np.zeros((0,), dtype=np.int64)
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = (w * h) / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= thresh]
    return np.array(keep, dtype=np.int64)
