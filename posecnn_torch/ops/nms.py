"""Non-maximum suppression: host NMS, and the greedy keep mask on the card.

`nms_np` is a copy of `posecnn_tpu/ops/nms.py:nms_np` (that module imports
jax at module level, so the port keeps its own copy of the NumPy function).

`nms_keep` ports `posecnn_tpu/ops/nms.py:nms_jax` (:38): a stable
`argsort(-scores)`, the "+1" areas, IoU = inter / (a_i + a_j - inter) in
float32, and a box suppressed when a kept box before it overlaps it by
IoU > thresh; the keep mask comes back in the input order. The JAX package
sweeps an (N, N) IoU matrix in a fori_loop; the port sorts with torch and
computes the keep mask of the sorted boxes with `nms_keep_sorted`: on a
CUDA tensor the kernel `csrc/nms.cu` (a pass of 64-bit suppression masks,
then one block's sweep), on a CPU tensor the plain version. The RPN's
proposal layer runs it over 6000 boxes a frame, which in eager PyTorch
would be 6000 dependent steps.
"""

from __future__ import annotations

import numpy as np
import torch

# Kernel launches by `nms_keep_sorted` since the count was last reset (one
# call launches the mask pass and the sweep; it counts once).
NMS_LAUNCHES = 0


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


# rows of the IoU matrix a chunk of the plain version computes
_PLAIN_ROWS = 512


def suppression_matrix(boxes: torch.Tensor, thresh: float) -> np.ndarray:
    """(N, N) bool on the host: IoU(i, j) > thresh, with the IoU arithmetic
    of `nms_jax`, computed on the boxes' device."""
    n = boxes.shape[0]
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    rows = []
    for r0 in range(0, n, _PLAIN_ROWS):
        s = slice(r0, r0 + _PLAIN_ROWS)
        iw = torch.maximum(zero, torch.minimum(x2[s, None], x2[None, :]) - torch.maximum(x1[s, None], x1[None, :]) + 1)
        ih = torch.maximum(zero, torch.minimum(y2[s, None], y2[None, :]) - torch.maximum(y1[s, None], y1[None, :]) + 1)
        inter = iw * ih
        iou = inter / (areas[s, None] + areas[None, :] - inter)
        rows.append(iou > thresh)
    return torch.cat(rows).cpu().numpy() if n else np.zeros((0, 0), bool)


def nms_keep_sorted_plain(boxes: torch.Tensor, thresh: float) -> torch.Tensor:
    """Keep mask (N,) bool of boxes (N,4) sorted by score, highest first:
    the suppression matrix, then the greedy sweep on the host (a box
    removes only the boxes after it)."""
    n = boxes.shape[0]
    over = suppression_matrix(boxes, thresh)
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~over[i, i + 1:]
    return torch.from_numpy(keep).to(boxes.device)


def _launch(boxes: torch.Tensor, thresh: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; counts the launch."""
    global NMS_LAUNCHES
    from posecnn_torch._build import nms_lib

    n = boxes.shape[0]
    keep = torch.empty((n,), dtype=torch.uint8, device=boxes.device)
    mask = torch.empty((n * ((n + 63) // 64),), dtype=torch.int64, device=boxes.device)
    lib = nms_lib()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nms_launch(boxes.data_ptr(), n, float(thresh), mask.data_ptr(), keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nms_launch failed: CUDA error {err}")
    NMS_LAUNCHES += 1
    return keep.bool()


def nms_keep_sorted(boxes: torch.Tensor, thresh: float) -> torch.Tensor:
    """Keep mask (N,) bool of float32 boxes (N,4) sorted by score. A CUDA
    tensor goes to the kernel (or raises); a CPU tensor goes to the plain
    version."""
    if boxes.dtype != torch.float32 or boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"nms_keep_sorted takes float32 (N, 4) boxes, got {boxes.dtype} {tuple(boxes.shape)}")
    boxes = boxes.contiguous()
    if boxes.device.type == "cuda":
        if boxes.shape[0] > 64 * 6144:  # the sweep's words must fit in 48 KB of shared memory
            raise ValueError(f"nms_keep_sorted: at most {64 * 6144} boxes, got {boxes.shape[0]}")
        return _launch(boxes, thresh)
    if boxes.device.type == "cpu":
        return nms_keep_sorted_plain(boxes, thresh)
    raise ValueError(f"nms_keep_sorted: unsupported device {boxes.device}")


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, thresh: float) -> torch.Tensor:
    """`nms_jax`: boxes (N,4), scores (N,) -> keep mask (N,) bool in the
    input order. The sort is stable: on equal scores the lower index comes
    first, as jnp.argsort orders them."""
    order = torch.sort(-scores, stable=True).indices
    keep_sorted = nms_keep_sorted(boxes.detach()[order].float(), thresh)
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return keep
