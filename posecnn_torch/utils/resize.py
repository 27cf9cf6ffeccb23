"""`cv2.resize` in NumPy, for INTER_NEAREST and INTER_LINEAR.

The JAX package resizes with cv2: the synthetic frames' backgrounds
(`posecnn_tpu/data/minibatch.py:composite_background`), the TRAIN and
TEST.SCALES_BASE input rescale (`scale_frame`, `engine/test.py:309-315,
382-394`). The card's host has no cv2. `resize(src, dsize, fx, fy,
interpolation)` follows OpenCV's `cv::resize` (imgproc/src/resize.cpp):

- dsize: given, or (round(W * fx), round(H * fy)) with ties to even; the
  scale is W / dsize.width as a double (1 / fx when only fx is given).
  A dsize equal to the source's is a copy.
- INTER_NEAREST (`resizeNN`): source column min(floor(x * sx), W - 1) with
  sx = 1 / (dsize.width / W) in double, rows likewise. Exact.
- INTER_LINEAR: source coordinate (x + 0.5) * sx - 0.5 in double, cast to
  float32, then floor and fraction f; a column left of 0 is column 0 with
  f = 0, one at or past W - 1 is column W - 1 with f = 0; rows keep their
  f and read the edge row for a row outside the image; weights 1 - f and f
  in float32.
  uint8: the weights as int16 round(w * 2048) (ties to even); the
  horizontal pass sums int32 S[x0] * a0 + S[x1] * a1, the vertical pass
  combines two such rows as OpenCV's vector loop does: ((r0 >> 4) * b0 >>
  16) + ((r1 >> 4) * b1 >> 16), then (+ 2) >> 2, saturated. Equal to cv2
  on every value the tests compare.
  float32: both passes in float32 (S0 * a0 + S1 * a1, then r0 * b0 +
  r1 * b1): equal to cv2 for 2 or more than 4 channels. For 1, 3 and 4
  channels cv2 runs another loop, which takes f before the cast to
  float32; with that f the port's sums agree with it to about 1e-6 of the
  image's largest magnitude (the tests' limit), not bit for bit.
  A scale of exactly 2 in both axes is OpenCV's area path (`_area2`).

Images are (H,W) or (H,W,C), any C.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

INTER_NEAREST = 0
INTER_LINEAR = 1
COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def _dsize(shape, dsize: Optional[Tuple[int, int]], fx: float, fy: float) -> Tuple[int, int, float, float]:
    """(width, height, inverse scale x, inverse scale y) as cv::resize sets them."""
    h, w = shape[:2]
    if dsize is not None and dsize[0] > 0 and dsize[1] > 0:
        dw, dh = int(dsize[0]), int(dsize[1])
        return dw, dh, dw / w, dh / h
    if not (fx > 0 and fy > 0):
        raise ValueError(f"resize: dsize {dsize} and scales fx {fx}, fy {fy}: give a dsize or both scales")
    dw, dh = int(np.rint(w * fx)), int(np.rint(h * fy))
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize: {w}x{h} at fx {fx}, fy {fy} is empty")
    return dw, dh, fx, fy


def _nearest_index(n_dst: int, n_src: int, inv_scale: float) -> np.ndarray:
    s = 1.0 / inv_scale
    return np.minimum(np.floor(np.arange(n_dst, dtype=np.float64) * s).astype(np.int64), n_src - 1)


def _linear_taps(n_dst: int, n_src: int, inv_scale: float, clamp: bool,
                 exact_fraction: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first source index, second source index, fraction f as float32).
    The coordinate is cast to float32 before the fraction is taken, or with
    `exact_fraction` after. Columns (`clamp`) left of 0 or at or past
    n_src - 1 take the edge with f = 0; rows keep their f and read the edge
    row twice."""
    s = 1.0 / inv_scale
    pos = (np.arange(n_dst, dtype=np.float64) + 0.5) * s - 0.5
    if not exact_fraction:
        pos = pos.astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    f = (pos - i0).astype(np.float32)
    if clamp:
        low = i0 < 0
        f[low], i0[low] = 0, 0
        high = i0 >= n_src - 1
        f[high], i0[high] = 0, n_src - 1
    return np.clip(i0, 0, n_src - 1), np.clip(i0 + 1, 0, n_src - 1), f


def _weights_fixed(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    one = np.float32(1)
    w0 = np.rint((one - f) * np.float32(COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int64)
    return w0, w1


def _mul_hi(a: np.ndarray, b) -> np.ndarray:
    """The high 16 bits of a signed 16 x 16 product (v_mul_hi)."""
    return (a * b) >> 16


def resize(src: np.ndarray, dsize: Optional[Tuple[int, int]] = None, fx: float = 0.0, fy: float = 0.0,
           interpolation: int = INTER_LINEAR) -> np.ndarray:
    """`cv2.resize(src, dsize, None, fx, fy, interpolation)` for
    INTER_NEAREST (any dtype) and INTER_LINEAR (uint8 and float32); dsize is
    (width, height) as cv2 takes it."""
    a = np.asarray(src)
    if a.ndim not in (2, 3) or a.shape[0] == 0 or a.shape[1] == 0:
        raise ValueError(f"resize: an (H,W) or (H,W,C) image, got {a.shape}")
    dw, dh, isx, isy = _dsize(a.shape, dsize, fx, fy)
    h, w = a.shape[:2]
    if (dw, dh) == (w, h):
        return a.copy()
    if interpolation == INTER_NEAREST:
        return a[_nearest_index(dh, h, isy)][:, _nearest_index(dw, w, isx)]
    if interpolation != INTER_LINEAR:
        raise NotImplementedError(f"resize: interpolation {interpolation} (only INTER_NEAREST 0, INTER_LINEAR 1)")
    if a.dtype not in (np.uint8, np.float32):
        raise NotImplementedError(f"resize: INTER_LINEAR of {a.dtype} (only uint8 and float32)")
    if 1.0 / isx == 2.0 and 1.0 / isy == 2.0:
        return _area2(a, dw, dh)
    f32 = a.dtype == np.float32
    # cv2 runs float32 images of 1, 3 or 4 channels through another loop,
    # which takes the fraction before the cast
    exact = f32 and (a.ndim == 2 or a.shape[2] in (1, 3, 4))
    x0, x1, fxs = _linear_taps(dw, w, isx, True, exact)
    y0, y1, fys = _linear_taps(dh, h, isy, False, exact)
    col, row = ((1, -1), (-1, 1)) if a.ndim == 2 else ((1, -1, 1), (-1, 1, 1))
    if f32:
        one = np.float32(1)
        rows = a[:, x0] * (one - fxs).reshape(col) + a[:, x1] * fxs.reshape(col)
        return (rows[y0] * (one - fys).reshape(row) + rows[y1] * fys.reshape(row)).astype(np.float32)
    ia0, ia1 = _weights_fixed(fxs)
    ib0, ib1 = _weights_fixed(fys)
    s = a.astype(np.int64)
    rows = s[:, x0] * ia0.reshape(col) + s[:, x1] * ia1.reshape(col)
    acc = _mul_hi(rows[y0] >> 4, ib0.reshape(row)) + _mul_hi(rows[y1] >> 4, ib1.reshape(row))
    return np.clip((acc + 2) >> 2, 0, 255).astype(np.uint8)


def _area2(a: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """OpenCV's area path for a scale of exactly 2 (`resizeAreaFast_`): each
    output pixel from its 2x2 block. uint8 with 1, 3 or 4 channels: (sum +
    2) >> 2; other uint8: round(sum * 0.25); float32: sum * 0.25. A block
    cut by the image's edge: the mean of its pixels inside, round(sum /
    count) in float32 for uint8."""
    h, w = a.shape[:2]
    pad = ((0, max(0, 2 * dh - h)), (0, max(0, 2 * dw - w))) + ((0, 0),) * (a.ndim - 2)
    q = np.pad(a, pad)[:2 * dh, :2 * dw].astype(np.float32 if a.dtype == np.float32 else np.int64)
    tot = ((q[0::2, 0::2] + q[0::2, 1::2]) + q[1::2, 0::2]) + q[1::2, 1::2]
    inside = np.pad(np.ones((h, w), np.int64), pad[:2])[:2 * dh, :2 * dw]
    count = inside[0::2, 0::2] + inside[0::2, 1::2] + inside[1::2, 0::2] + inside[1::2, 1::2]
    count = count.reshape(count.shape + (1,) * (a.ndim - 2))
    if a.dtype == np.float32:
        return np.where(count == 4, tot * np.float32(0.25), tot / count.astype(np.float32)).astype(np.float32)
    if a.ndim == 2 or a.shape[2] in (1, 3, 4):
        full = (tot + 2) >> 2
    else:
        full = np.rint(tot.astype(np.float32) * np.float32(0.25))
    part = np.rint(tot.astype(np.float32) / np.maximum(count, 1).astype(np.float32))
    return np.clip(np.where(count == 4, full, part), 0, 255).astype(np.uint8)
