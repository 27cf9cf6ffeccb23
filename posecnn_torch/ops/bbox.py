"""Box IoU and bbox-regression transforms.

Port of `posecnn_tpu/ops/bbox.py` (`bbox_overlaps` :22, `bbox_transform`
:38, `bbox_transform_inv` :58, `clip_boxes` :88). Each function takes
torch tensors or numpy arrays and returns the same kind, as the JAX
functions take numpy arrays or JAX arrays. The reference's Pascal VOC "+1"
pixel-area convention is kept.

`clip_boxes` clips with `maximum` then `minimum` against the bounds, as
`jnp.clip` does: at a coordinate exactly on a bound the gradient is split
in half between the coordinate and the bound, where `torch.clamp` would
pass all of it.
"""

from __future__ import annotations

import numpy as np
import torch


def _stack(xs, axis: int):
    if isinstance(xs[0], np.ndarray):
        return np.stack(xs, axis=axis)
    return torch.stack(xs, dim=axis)


def _minimum(a, b):
    return np.minimum(a, b) if isinstance(a, np.ndarray) else torch.minimum(a, b)


def _maximum(a, b):
    return np.maximum(a, b) if isinstance(a, np.ndarray) else torch.maximum(a, b)


def bbox_overlaps(boxes, query_boxes):
    """IoU matrix. boxes (N,4), query_boxes (K,4) -> (N,K)."""
    b_x1, b_y1, b_x2, b_y2 = boxes[:, 0:1], boxes[:, 1:2], boxes[:, 2:3], boxes[:, 3:4]
    q_x1, q_y1, q_x2, q_y2 = query_boxes[:, 0], query_boxes[:, 1], query_boxes[:, 2], query_boxes[:, 3]
    iw = _minimum(b_x2, q_x2[None, :]) - _maximum(b_x1, q_x1[None, :]) + 1
    ih = _minimum(b_y2, q_y2[None, :]) - _maximum(b_y1, q_y1[None, :]) + 1
    zero = iw.dtype.type(0) if isinstance(iw, np.ndarray) else torch.zeros((), dtype=iw.dtype, device=iw.device)
    iw = _maximum(iw, zero)
    ih = _maximum(ih, zero)
    inter = iw * ih
    area_b = (b_x2 - b_x1 + 1) * (b_y2 - b_y1 + 1)
    area_q = (q_x2 - q_x1 + 1) * (q_y2 - q_y1 + 1)
    union = area_b + area_q[None, :] - inter
    return inter / union


def bbox_transform(ex_rois, gt_rois):
    """Regression targets (dx, dy, dw, dh) from example to GT boxes."""
    log = np.log if isinstance(ex_rois, np.ndarray) else torch.log
    ex_widths = ex_rois[:, 2] - ex_rois[:, 0] + 1.0
    ex_heights = ex_rois[:, 3] - ex_rois[:, 1] + 1.0
    ex_ctr_x = ex_rois[:, 0] + 0.5 * ex_widths
    ex_ctr_y = ex_rois[:, 1] + 0.5 * ex_heights

    gt_widths = gt_rois[:, 2] - gt_rois[:, 0] + 1.0
    gt_heights = gt_rois[:, 3] - gt_rois[:, 1] + 1.0
    gt_ctr_x = gt_rois[:, 0] + 0.5 * gt_widths
    gt_ctr_y = gt_rois[:, 1] + 0.5 * gt_heights

    dx = (gt_ctr_x - ex_ctr_x) / ex_widths
    dy = (gt_ctr_y - ex_ctr_y) / ex_heights
    dw = log(gt_widths / ex_widths)
    dh = log(gt_heights / ex_heights)
    return _stack([dx, dy, dw, dh], 1)


def bbox_transform_inv(boxes, deltas):
    """Decode predicted deltas to boxes. boxes (N,4), deltas (N,4K) -> (N,4K)."""
    exp = np.exp if isinstance(boxes, np.ndarray) else torch.exp
    widths = boxes[:, 2] - boxes[:, 0] + 1.0
    heights = boxes[:, 3] - boxes[:, 1] + 1.0
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights

    dx = deltas[:, 0::4]
    dy = deltas[:, 1::4]
    dw = deltas[:, 2::4]
    dh = deltas[:, 3::4]

    pred_ctr_x = dx * widths[:, None] + ctr_x[:, None]
    pred_ctr_y = dy * heights[:, None] + ctr_y[:, None]
    pred_w = exp(dw) * widths[:, None]
    pred_h = exp(dh) * heights[:, None]

    out = _stack(
        [pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h, pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h],
        2,
    )
    return out.reshape(boxes.shape[0], -1)


def _clip(x, hi):
    """`jnp.clip(x, 0, hi)`: maximum with 0, then minimum with hi."""
    if isinstance(x, np.ndarray):
        return np.minimum(np.maximum(x, 0), hi)
    lo = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), torch.full((), hi, dtype=x.dtype, device=x.device))


def clip_boxes(boxes, im_shape):
    """Clip (N,4K) boxes to the image bounds (H, W)."""
    h, w = im_shape[0], im_shape[1]
    x1 = _clip(boxes[:, 0::4], w - 1)
    y1 = _clip(boxes[:, 1::4], h - 1)
    x2 = _clip(boxes[:, 2::4], w - 1)
    y2 = _clip(boxes[:, 3::4], h - 1)
    return _stack([x1, y1, x2, y2], 2).reshape(boxes.shape[0], -1)
