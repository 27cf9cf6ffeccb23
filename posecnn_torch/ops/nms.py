"""Non-maximum suppression: host NMS, and the greedy keep mask on the card.

`nms_np` is a copy of `posecnn_tpu/ops/nms.py:nms_np` (that module imports
jax at module level, so the port keeps its own copy of the NumPy function).

`nms_keep` ports `posecnn_tpu/ops/nms.py:nms_jax` (:38): a stable
`argsort(-scores)`, the "+1" areas, IoU = inter / (a_i + a_j - inter) in
float32, and a box suppressed when a kept box before it overlaps it by
IoU > thresh; the keep mask comes back in the input order. The JAX package
sweeps an (N, N) IoU matrix in a fori_loop; the port sorts with torch and
computes the keep mask of the sorted boxes with `nms_keep_sorted`: on a
CUDA tensor the kernel `csrc/nms.cu` (a pass of 64-bit suppression words
over the upper triangle of 64 x 64 tiles, then one block's sweep over
them, staged in shared memory), on a CPU tensor the plain version. The
RPN's proposal layer runs it over 6000 boxes a frame, which in eager
PyTorch would be 6000 dependent steps. The helpers below give the
kernel's layout and its sweep's shared memory for N boxes; the kernel
computes the same offsets.
"""

from __future__ import annotations

import numpy as np
import torch

# Kernel launches by `nms_keep_sorted` since the count was last reset (one
# call launches the mask pass and the sweep; it counts once).
NMS_LAUNCHES = 0

# boxes in a row or column block: the bits of one suppression word
BLOCK = 64
# the bytes of dynamic shared memory the sweep may take: 220 KB of the 227
# KB an sm_90 block can have, beside its static part (the walker's ring of
# tiles and the barriers, 4.1 KB)
SWEEP_SMEM = 225280
# row blocks whose tiles the sweep's helpers stage ahead (their buffers)
SWEEP_STAGES = 3
# the most boxes the kernel takes: its `removed` words and kept bits (one
# each a column block) must leave room for a window of tiles in shared
# memory
MAX_BOXES = 64 * 6144


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


def col_blocks(n: int) -> int:
    """C: the row (and column) blocks of 64 boxes."""
    return -(-n // BLOCK)


def row_tile(r: int, cb: int) -> int:
    """The first tile of row block r in the mask: the tiles (r, c), c >= r,
    are stored row block by row block, cb - r of them in row block r."""
    return r * cb - r * (r - 1) // 2


def tile_count(n: int) -> int:
    """The tiles of the upper triangle, c >= r: C (C + 1) / 2."""
    return row_tile(col_blocks(n), col_blocks(n))


def mask_words(n: int) -> int:
    """The mask pass's 64-bit words: 64 for each tile."""
    return tile_count(n) * BLOCK


def sweep_smem_bytes(n: int, window: int) -> int:
    """The sweep's dynamic shared memory: `removed` and the kept bits (C
    words each, rounded up to an even count) and SWEEP_STAGES buffers of
    `window` tiles of 512 bytes."""
    cb = col_blocks(n)
    return 16 * (cb + (cb & 1)) + SWEEP_STAGES * window * BLOCK * 8


def sweep_window(n: int, smem: int = SWEEP_SMEM) -> int:
    """Tiles of a row block that the sweep's helpers stage in shared memory,
    past the two that its walker stages: all C - 2 of the first row block
    where they fit in `smem` bytes, else as many as fit."""
    cb = col_blocks(n)
    return max(0, min(max(cb - 2, 0), (smem - sweep_smem_bytes(n, 0)) // (SWEEP_STAGES * BLOCK * 8)))


def sweep_route(n: int, smem: int = SWEEP_SMEM) -> str:
    """"staged" where every row block's tiles fit in shared memory, else
    "window" (the first `sweep_window` of the helpers' tiles staged, the
    rest read from global memory)."""
    return "staged" if sweep_window(n, smem) >= col_blocks(n) - 2 else "window"


def _launch(boxes: torch.Tensor, thresh: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; counts the launch."""
    global NMS_LAUNCHES
    from posecnn_torch._build import nms_lib

    n = boxes.shape[0]
    if boxes.data_ptr() % 16:  # the mask pass reads a box as one float4
        boxes = boxes.clone()
    keep = torch.empty((n,), dtype=torch.uint8, device=boxes.device)
    mask = torch.empty((mask_words(n),), dtype=torch.int64, device=boxes.device)
    lib = nms_lib()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nms_launch(boxes.data_ptr(), n, float(thresh), mask.data_ptr(), keep.data_ptr(), sweep_window(n),
                             stream)
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
        if boxes.shape[0] > MAX_BOXES:
            raise ValueError(f"nms_keep_sorted: at most {MAX_BOXES} boxes, got {boxes.shape[0]}")
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
