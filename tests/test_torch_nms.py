"""The NMS kernel's layout and its sweep's routes (`posecnn_torch/ops/nms.py`,
`csrc/nms.cu`), on the CPU.

The kernel runs only on a card (tests/test_torch_cuda.py and chip_smoke.py
hold it to the plain version there). Here the wrapper's helpers are held
against brute-force enumerations: the tiles of the upper triangle and where
each row block's tiles start, the shared memory the sweep asks for, the
window of tiles it stages and its route for N boxes. A NumPy model of the
kernel (the mask pass's words at their swizzled positions in the tile
layout, then the sweep's walker and helpers in the order their hand-offs
allow, with its staging protocol: the window read from the buffers and the
rest from the mask) is held to
`nms_keep_sorted_plain` on integer boxes, exact-threshold IoUs, NaN and
infinite coordinates, and on both routes (a smaller shared memory forces
the window route at small N). Keep masks exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from posecnn_torch.ops import nms as N

SIZES = [1, 63, 64, 65, 127, 128, 129, 4097, 6000, 9408, 9409, 12000, 20000]


@pytest.mark.parametrize("n", SIZES)
def test_nms_tile_layout_matches_enumeration(n):
    """Row block by row block, tiles c = r .. C-1: `row_tile` is each row
    block's first tile, `tile_count` all of them, 64 words a tile."""
    cb = N.col_blocks(n)
    assert (cb - 1) * 64 < n <= cb * 64
    tiles = [(r, c) for r in range(cb) for c in range(r, cb)]
    first = {}
    for i, (r, c) in enumerate(tiles):
        first.setdefault(r, i)
        assert N.row_tile(r, cb) + (c - r) == i
    assert all(N.row_tile(r, cb) == first[r] for r in range(cb))
    assert N.tile_count(n) == len(tiles) and N.mask_words(n) == 64 * len(tiles)


@pytest.mark.parametrize("n", SIZES + [N.MAX_BOXES])
def test_nms_sweep_window_and_route(n):
    """The window is the most tiles (up to C - 2, past the walker's two)
    whose SWEEP_STAGES buffers fit beside `removed` and the kept bits in
    SWEEP_SMEM; the route is "staged" exactly where it is C - 2."""
    cb = N.col_blocks(n)
    w = N.sweep_window(n)
    brute = max(k for k in range(max(cb - 2, 0) + 1) if N.sweep_smem_bytes(n, k) <= N.SWEEP_SMEM)
    assert w == brute and (w >= 1 or cb <= 2)
    assert N.sweep_smem_bytes(n, w) == 16 * (cb + cb % 2) + 1536 * w <= N.SWEEP_SMEM
    assert N.sweep_route(n) == ("staged" if w == max(cb - 2, 0) else "window")


def test_nms_staged_route_ends_at_9408_boxes():
    """The largest N on the staged route, found by trying every C: 147
    column blocks (the RPN's 6000 boxes are staged; the card tests' 12000
    and 20000 take the window route)."""
    staged = [cb for cb in range(1, N.MAX_BOXES // 64 + 1) if N.sweep_route(64 * cb) == "staged"]
    assert staged == list(range(1, 148))
    assert N.sweep_route(9408) == "staged" and N.sweep_route(9409) == "window"
    assert N.sweep_route(6000) == "staged" and N.sweep_route(12000) == N.sweep_route(20000) == "window"


def _mask_pass(over: np.ndarray) -> np.ndarray:
    """The words `nms_mask_kernel` writes: tile (r, c) at `row_tile(r) + c -
    r`, row t's word at position t ^ (c & 31), bit k for column 64 c + k
    after the row box that it overlaps; rows past N are 0."""
    n = over.shape[0]
    cb = N.col_blocks(n)
    mask = np.zeros(N.mask_words(n), np.uint64)
    j_after_i = np.triu(np.ones((n, n), bool), 1)
    for r in range(cb):
        for c in range(r, cb):
            rows, cols = slice(64 * r, min(64 * r + 64, n)), slice(64 * c, min(64 * c + 64, n))
            sub = over[rows, cols] & j_after_i[rows, cols]
            bits = np.bitwise_or.reduce(np.where(sub, np.uint64(1) << np.arange(sub.shape[1], dtype=np.uint64),
                                                 np.uint64(0)), axis=1)
            tile = N.row_tile(r, cb) + c - r
            for t, word in enumerate(bits):
                mask[64 * tile + (t ^ (c & 31))] = word
    return mask


def _sweep(mask: np.ndarray, n: int, window: int) -> np.ndarray:
    """`nms_sweep_kernel`, its walker's and helpers' steps in the order the
    hand-offs allow at the latest. The walker's ring of 4 buffers holds row
    block b's tiles (b, b) and (b, b+1) (b = 0 .. 3 at the start, b + 4
    after step b); the helpers' SWEEP_STAGES buffers hold its tiles (b,
    b+2) .. (b, b+1+staged) (b = 0, 1, 2 at the start, b + 3 once the
    helpers are done with b), the rest are read from the mask. The walker
    decides a row block in rounds, keeps the kept words of tile (b, b+1) in
    `carry` for step b+1 and reads `removed[b]` after the helpers
    have ORed row blocks up to b - 2 into the words past them + 1; the
    helpers of row block b run after the walker's step b + 1, just before
    its step b + 2 needs them."""
    cb = N.col_blocks(n)
    stages = N.SWEEP_STAGES
    removed = np.zeros(cb, np.uint64)
    keep = np.zeros(n, bool)
    bufs, ring = [None] * stages, [None] * 4
    kept = {}

    def staged(b):
        return max(0, min(cb - b - 2, window))

    def stage(b):
        start = 64 * (N.row_tile(b, cb) + 2)
        bufs[b % stages] = mask[start:start + 64 * staged(b)].copy()

    def stage_walker(b):
        start = 64 * N.row_tile(b, cb)
        ring[b % 4] = mask[start:start + 64 * min(2, cb - b)].copy()

    def word(b, w, k):
        if w - b < 2:
            src, at = ring[b % 4], w - b
        elif w - b - 2 < staged(b):
            src, at = bufs[b % stages], w - b - 2
        else:
            src, at = mask[64 * N.row_tile(b, cb):], w - b
        return int(src[64 * at + (k ^ (w & 31))])

    def helpers(b):
        for w in range(b + 2, cb):
            acc = 0
            for k in range(64):
                if kept[b] >> k & 1:
                    acc |= word(b, w, k)
            removed[w] |= np.uint64(acc)
        if staged(b + stages) > 0:
            stage(b + stages)

    for b in range(min(4, cb)):
        stage_walker(b)
    for b in range(stages):
        if staged(b) > 0:
            stage(b)
    carry = 0
    for b in range(cb):
        if b >= 2:
            helpers(b - 2)
        size = min(n - 64 * b, 64)
        # rounds: the undecided boxes that no undecided box before them
        # suppresses are kept, and what they suppress is removed
        rows = [word(b, b, k) for k in range(64)]
        undecided, kb = ((1 << size) - 1) & ~(int(removed[b]) | carry), 0
        while undecided:
            blocked = 0
            for k in range(64):
                if undecided >> k & 1:
                    blocked |= rows[k]
            safe = undecided & ~blocked
            gone = 0
            for k in range(64):
                if safe >> k & 1:
                    gone |= rows[k]
            kb |= safe
            undecided &= ~(safe | gone)
        keep[64 * b:64 * b + size] = [(kb >> t) & 1 for t in range(size)]
        carry = 0
        if b + 1 < cb:
            for k in range(64):
                if kb >> k & 1:
                    carry |= word(b, b + 1, k)
        kept[b] = kb
        if b + 4 < cb:
            stage_walker(b + 4)
    return keep


def _boxes(n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 200, (n, 2))
    boxes = np.concatenate([xy, xy + rng.randint(4, 80, (n, 2))], 1).astype(np.float32)
    if n >= 3:
        boxes[:3] = [[0, 0, 9, 9], [0, 0, 9, 6], [0, 0, 9, 2]]  # IoU 0.7 and 0.3 with the first
    if n >= 18:
        boxes[3, 0] = boxes[5, 1] = boxes[13, 2:] = np.nan
        boxes[8, 2] = boxes[17, :2] = np.inf
        boxes[11, 1] = -np.inf
    return boxes


# (n, threshold, shared memory): the default staged route, then the window
# route forced at small N by less shared memory (window 2, 1 and 0 tiles)
MODEL_CASES = [(1, 0.7, N.SWEEP_SMEM), (63, 0.7, N.SWEEP_SMEM), (64, 0.5, N.SWEEP_SMEM), (65, 0.3, N.SWEEP_SMEM),
               (129, 0.7, N.SWEEP_SMEM), (300, 0.3, N.SWEEP_SMEM), (300, 0.7, 16 * 6 + 3072),
               (300, 0.5, 16 * 6 + 1536), (200, 0.5, 64)]


@pytest.mark.parametrize("n,thresh,smem", MODEL_CASES)
def test_nms_kernel_model_matches_plain(n, thresh, smem):
    boxes = _boxes(n, n)
    over = N.suppression_matrix(torch.from_numpy(boxes), thresh)
    window = N.sweep_window(n, smem)
    assert (N.sweep_route(n, smem) == "staged") == (smem == N.SWEEP_SMEM)
    got = _sweep(_mask_pass(over), n, window)
    np.testing.assert_array_equal(got, N.nms_keep_sorted_plain(torch.from_numpy(boxes), thresh).numpy())
    assert 0 < got.sum() <= n
