"""Host-side frame helpers of the training data, in numpy.

The port's own copies of `posecnn_tpu/data/minibatch.py:Frame`, `pose_rows`
(:308) and `rescale_points` (:319), and `posecnn_tpu/utils/blob.py:pad_im`;
`load_frozen_frame` reads one frozen frame (`data/lov_syn_val_v4/*.npz`,
with its depth where the file has one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from posecnn_torch.utils.quaternion_np import mat2quat


@dataclass
class Frame:
    """One annotated frame (the fields of the JAX package's `Frame` that the
    training bank and the evaluation read)."""

    color: np.ndarray             # (H,W,3) uint8 BGR
    label: np.ndarray             # (H,W) int class ids
    cls_indexes: np.ndarray       # (N,) class ids present
    poses: np.ndarray             # (3,4,N) [R|t] per instance
    center: np.ndarray            # (N,2) projected object centres (x, y)
    intrinsic_matrix: np.ndarray  # (3,3)
    depth: Optional[np.ndarray] = None  # (H,W) uint16, metres * factor_depth
    factor_depth: float = 1.0


def load_frozen_frame(path: str) -> Frame:
    with np.load(path) as d:
        return Frame(
            color=d["color"], label=d["label"], cls_indexes=d["cls_indexes"], poses=d["poses"],
            center=d["center"], intrinsic_matrix=d["intrinsic_matrix"],
            depth=d["depth"] if "depth" in d.files else None,
            factor_depth=float(d["factor_depth"]) if "factor_depth" in d.files else 1.0,
        )


def pad_im(im: np.ndarray, factor: int) -> np.ndarray:
    """Zero-pad the bottom and right edges up to a multiple of `factor`."""
    height, width = im.shape[0], im.shape[1]
    pad_height = int(np.ceil(height / float(factor)) * factor - height)
    pad_width = int(np.ceil(width / float(factor)) * factor - width)
    return np.pad(im, ((0, pad_height), (0, pad_width)) + ((0, 0),) * (im.ndim - 2))


def pose_rows(frame_index: int, frame: Frame) -> np.ndarray:
    """(N, 13) GT pose rows: [frame_index, cls, 0 x 4, quaternion wxyz, t]."""
    n = frame.poses.shape[2]
    qt = np.zeros((n, 13), dtype=np.float32)
    for j in range(n):
        qt[j, 0] = frame_index
        qt[j, 1] = frame.cls_indexes[j]
        qt[j, 6:10] = mat2quat(frame.poses[:, :3, j])
        qt[j, 10:] = frame.poses[:, 3, j]
    return qt


def rescale_points(points: np.ndarray, extents: np.ndarray, symmetry: np.ndarray) -> np.ndarray:
    """The ADD loss's model points, scaled per class by max(10, 2/extent)
    and 4x more for a symmetric class (reference minibatch.py:49-63)."""
    out = points.copy()
    for i in range(1, points.shape[0]):
        ext_max = np.amax(extents[i, :])
        weight = 2.0 / ext_max if ext_max > 0 else 10.0
        if weight < 10:
            weight = 10
        if symmetry[i] > 0:
            out[i] = 4 * weight * points[i]
        else:
            out[i] = weight * points[i]
    return out
