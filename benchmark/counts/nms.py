"""The NMS kernel's bound (`csrc/nms.cu`, the RPN's proposal layer): the IoU
tests a greedy sweep of the launch's own sorted boxes needs, each of
NMS_TEST_OPS float32 operations at the float32 peak, or the boxes read once
and the keep mask written once, whichever takes longer.

A greedy sweep reaches the boxes in score order; a box not removed when it
is reached is kept, and is tested against each later box that is still
there (`nms_sweep_tests`). Boxes a kept box removes need no test of their
own, so a kernel that tests fewer pairs than the whole upper triangle reads
against the same yardstick.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from benchmark.counts.peaks import PEAK_F32_FLOP_PER_S, bound_s

# f32 operations of one IoU test: the intersection's two widths (min, max,
# subtract, add 1, clamp at 0: 5 each), their product, the union (the two
# areas' sum less the intersection: 2), the division and the comparison
# with the threshold
NMS_TEST_OPS = 15


def nms_sweep_tests(over: np.ndarray) -> Tuple[np.ndarray, int]:
    """(keep mask, IoU tests) of a greedy sweep over the suppression matrix
    of sorted boxes: a box not removed when it is reached is kept, and is
    tested against each later box that is still there."""
    n = over.shape[0]
    removed = np.zeros(n, bool)
    tests = 0
    for i in range(n):
        if not removed[i]:
            tests += int(n - 1 - i - removed[i + 1:].sum())
            removed[i + 1:] |= over[i, i + 1:]
    return ~removed, tests


def suppression(boxes, thresh: float, chunk: int = 1024) -> np.ndarray:
    """(N, N) bool on the host: IoU(i, j) > thresh of float32 boxes (N, 4)
    with the "+1" areas, computed in chunks of rows on the boxes' device."""
    import torch

    b = boxes.float()
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    rows = []
    for r0 in range(0, b.shape[0], chunk):
        s = slice(r0, r0 + chunk)
        iw = (torch.minimum(x2[s, None], x2[None]) - torch.maximum(x1[s, None], x1[None]) + 1).clamp(min=0)
        ih = (torch.minimum(y2[s, None], y2[None]) - torch.maximum(y1[s, None], y1[None]) + 1).clamp(min=0)
        inter = iw * ih
        rows.append((inter / (area[s, None] + area[None] - inter) > thresh).cpu())
    return torch.cat(rows).numpy() if rows else np.zeros((0, 0), bool)


def nms_bytes(n: int) -> int:
    """Bytes one launch must move: n float32 boxes read, n keep bytes
    written."""
    return n * 16 + n


def nms_bound(n: int, tests: float):
    """(seconds, bound by) of one NMS launch over n boxes that needs
    `tests` IoU tests."""
    return bound_s(nms_bytes(n), tests * NMS_TEST_OPS, PEAK_F32_FLOP_PER_S)
