"""Hough inputs built from a frozen frame's ground truth, in numpy.

A frozen frame (`data/lov_syn_val_v{3,4}/*.npz`) holds color, label, poses
(3, 4, N), projected centers (N, 2), cls_indexes (N,) and K. The vertex
field here is the one the vertex head is trained to predict: for each pixel
of object k, the unit direction to its projected centre and log of its depth
(`posecnn_tpu/ops/vertex_targets.py`), in channels 3*cls .. 3*cls+2.
"""

from __future__ import annotations

import numpy as np


def gt_vertex_field(label: np.ndarray, cls_indexes, centers: np.ndarray, poses: np.ndarray, num_classes: int) -> np.ndarray:
    """label (H,W) int -> vertex field (H,W,3C) float32, zero off-object."""
    H, W = label.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    vert = np.zeros((H, W, 3 * num_classes), np.float32)
    for k, cls in enumerate(np.asarray(cls_indexes).astype(np.int64)):
        m = label == cls
        dx = np.float32(centers[k, 0]) - xs[m]
        dy = np.float32(centers[k, 1]) - ys[m]
        n = np.maximum(np.sqrt(dx * dx + dy * dy), np.float32(1e-10))
        vert[m, 3 * cls] = dx / n
        vert[m, 3 * cls + 1] = dy / n
        vert[m, 3 * cls + 2] = np.log(np.float32(poses[2, 3, k]))
    return vert
