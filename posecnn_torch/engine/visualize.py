"""Prediction and minibatch overlays (TEST.VISUALIZE, TRAIN.VISUALIZE, --vis),
drawn in NumPy and written as PNGs.

Port of `posecnn_tpu/engine/visualize.py` without cv2, which the card's
machine does not have. Each cv2 call has a counterpart here:

  cv2.cvtColor(HSV2BGR), uint8   `hsv_to_bgr`: OpenCV's float arithmetic,
                                 equal to cv2 for every hue at full
                                 saturation and value (the palette's)
  cv2.resize(INTER_NEAREST)      `utils.resize.resize`
  cv2.rectangle, thickness 1     `draw_rectangle`: the four edges between
                                 the corners, clipped; equal to cv2's LINE_8
  cv2.drawMarker(MARKER_CROSS,   `draw_cross`: a horizontal and a vertical
  size 8, thickness 1)           stroke of 9 pixels; equal to cv2
  cv2.line(LINE_AA), thickness 1 `draw_line_aa`: Xiaolin Wu's line, two
                                 pixels across the major axis weighted by
                                 their distance to the ideal line, blended
                                 as cv2 blends (`p += ((c - p) * a + 127)
                                 >> 8`); cv2 spreads the line over three
                                 pixels with its own filter, so the two
                                 differ at the line's pixels only (and
                                 where a line leaves the image: cv2 draws
                                 the part outside along the border)
  cv2.putText(HERSHEY_SIMPLEX,   `draw_text`: a 5x7 bitmap font (`_GLYPHS`,
  0.4, thickness 1, LINE_AA)     descenders 2 rows below the baseline), one
                                 glyph centred in each character's cell,
                                 the cells as wide as Hershey simplex's
                                 advances at scale 0.4 (`_ADVANCE`), solid
                                 in the class colour: the text sits in
                                 cv2's text box, its look is not cv2's
  cv2.imwrite(PNG)               `utils.png.write_png`

`project_box_corners` is `engine.test.project_box_corners`.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from posecnn_torch.config import PIXEL_MEANS
from posecnn_torch.engine.test import project_box_corners
from posecnn_torch.utils.png import write_png
from posecnn_torch.utils.resize import INTER_NEAREST, resize

# 12 edges of a box as corner-index pairs (corners = sign choices over xyz)
BOX_EDGES = (
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
)
# Hershey simplex's advance of each character from ' ' to '~' in font
# units (cv2.getTextSize of the character at scale 1, less the thickness)
_ADVANCE = (7, 7, 10, 20, 17, 21, 20, 6, 17, 17, 12, 17, 7, 13, 7, 13, 17, 17, 17, 17, 17, 17, 17, 17, 17, 17, 7,
            7, 14, 16, 14, 15, 24, 19, 19, 19, 19, 17, 16, 19, 20, 7, 18, 17, 16, 22, 20, 19, 18, 19, 18, 17, 16, 20,
            18, 23, 18, 18, 17, 9, 13, 9, 12, 21, 9, 15, 17, 15, 17, 16, 11, 17, 17, 6, 7, 14, 7, 25, 17, 16, 17, 17,
            10, 14, 11, 17, 15, 23, 15, 15, 14, 10, 6, 10, 16)
TEXT_SCALE = 0.4
# 5x7 glyphs, one hex row each from the top (bit 4 = the left column); rows
# 7 and 8 lie below the baseline. Characters without a glyph draw `_BOX`.
_GLYPHS = {
    "0": "0e 11 13 15 19 11 0e", "1": "04 0c 04 04 04 04 0e", "2": "0e 11 01 02 04 08 1f",
    "3": "1f 02 04 02 01 11 0e", "4": "02 06 0a 12 1f 02 02", "5": "1f 10 1e 01 01 11 0e",
    "6": "06 08 10 1e 11 11 0e", "7": "1f 01 02 04 08 08 08", "8": "0e 11 11 0e 11 11 0e",
    "9": "0e 11 11 0f 01 02 0c",
    "A": "0e 11 11 11 1f 11 11", "B": "1e 11 11 1e 11 11 1e", "C": "0e 11 10 10 10 11 0e",
    "D": "1c 12 11 11 11 12 1c", "E": "1f 10 10 1e 10 10 1f", "F": "1f 10 10 1e 10 10 10",
    "G": "0e 11 10 17 11 11 0f", "H": "11 11 11 1f 11 11 11", "I": "0e 04 04 04 04 04 0e",
    "J": "07 02 02 02 02 12 0c", "K": "11 12 14 18 14 12 11", "L": "10 10 10 10 10 10 1f",
    "M": "11 1b 15 15 11 11 11", "N": "11 11 19 15 13 11 11", "O": "0e 11 11 11 11 11 0e",
    "P": "1e 11 11 1e 10 10 10", "Q": "0e 11 11 11 15 12 0d", "R": "1e 11 11 1e 14 12 11",
    "S": "0f 10 10 0e 01 01 1e", "T": "1f 04 04 04 04 04 04", "U": "11 11 11 11 11 11 0e",
    "V": "11 11 11 11 11 0a 04", "W": "11 11 11 15 15 15 0a", "X": "11 11 0a 04 0a 11 11",
    "Y": "11 11 11 0a 04 04 04", "Z": "1f 01 02 04 08 10 1f",
    "a": "00 00 0e 01 0f 11 0f", "b": "10 10 16 19 11 11 1e", "c": "00 00 0e 10 10 11 0e",
    "d": "01 01 0d 13 11 11 0f", "e": "00 00 0e 11 1f 10 0e", "f": "06 09 08 1c 08 08 08",
    "g": "00 00 0f 11 11 11 0f 01 0e", "h": "10 10 16 19 11 11 11", "i": "04 00 0c 04 04 04 0e",
    "j": "02 00 06 02 02 02 02 12 0c", "k": "10 10 12 14 18 14 12", "l": "0c 04 04 04 04 04 0e",
    "m": "00 00 1a 15 15 11 11", "n": "00 00 16 19 11 11 11", "o": "00 00 0e 11 11 11 0e",
    "p": "00 00 1e 11 11 11 1e 10 10", "q": "00 00 0f 11 11 11 0f 01 01", "r": "00 00 16 19 10 10 10",
    "s": "00 00 0e 10 0e 01 1e", "t": "08 08 1c 08 08 09 06", "u": "00 00 11 11 11 13 0d",
    "v": "00 00 11 11 11 0a 04", "w": "00 00 11 11 15 15 0a", "x": "00 00 11 0a 04 0a 11",
    "y": "00 00 11 11 11 11 0f 01 0e", "z": "00 00 1f 02 04 08 1f",
    "_": "00 00 00 00 00 00 00 1f", "-": "00 00 00 1f 00 00 00", ".": "00 00 00 00 00 0c 0c",
    " ": "00",
}
_BOX = "1f 11 11 11 11 11 1f"


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2BGR) of uint8 (..., 3) HSV (hue 0..179):
    OpenCV's float path (`HSV2RGB_f`): h * 6/180, s and v over 255, the
    sector table, then x * 255 rounded half to even. Equal to cv2 at
    s = v = 255 for every hue; elsewhere ~1 value in 10^4 rounds the other
    way (cv2's vector code orders its products otherwise)."""
    hsv = np.asarray(hsv, np.uint8)
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    h = np.where(h >= 6, h - 6, h)
    sector = np.floor(h).astype(np.int64)
    f = (h - sector.astype(np.float32)).astype(np.float32)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * f), v * (one - s * (one - f))], -1).astype(np.float32)
    order = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])[sector]  # (b, g, r)
    bgr = np.take_along_axis(tab, order, -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    return np.clip(np.rint(bgr * np.float32(255.0)), 0, 255).astype(np.uint8)


def class_colors(num_classes: int) -> np.ndarray:
    """Deterministic BGR palette: evenly spread hues (class 0 = black)."""
    hsv = np.zeros((num_classes, 1, 3), np.uint8)
    hsv[:, 0, 0] = (np.arange(num_classes) * 180 // max(num_classes, 1)).astype(np.uint8)
    hsv[:, 0, 1] = 255
    hsv[:, 0, 2] = 255
    bgr = hsv_to_bgr(hsv).reshape(num_classes, 3)
    bgr[0] = 0
    return bgr


def _hline(im: np.ndarray, y: int, x0: int, x1: int, color) -> None:
    H, W = im.shape[:2]
    x0, x1 = min(x0, x1), max(x0, x1)
    if 0 <= y < H and x1 >= 0 and x0 < W:
        im[y, max(x0, 0):min(x1, W - 1) + 1] = color


def _vline(im: np.ndarray, x: int, y0: int, y1: int, color) -> None:
    H, W = im.shape[:2]
    y0, y1 = min(y0, y1), max(y0, y1)
    if 0 <= x < W and y1 >= 0 and y0 < H:
        im[max(y0, 0):min(y1, H - 1) + 1, x] = color


def draw_rectangle(im: np.ndarray, p1, p2, color) -> None:
    """cv2.rectangle(im, p1, p2, color, 1): the edges between the corners'
    rows and columns, clipped to the image."""
    (x1, y1), (x2, y2) = (int(v) for v in p1), (int(v) for v in p2)
    _hline(im, y1, x1, x2, color)
    _hline(im, y2, x1, x2, color)
    _vline(im, x1, y1, y2, color)
    _vline(im, x2, y1, y2, color)


def draw_cross(im: np.ndarray, center, color, size: int = 8) -> None:
    """cv2.drawMarker(im, center, color, MARKER_CROSS, size, 1)."""
    x, y = (int(v) for v in center)
    _hline(im, y, x - size // 2, x + size // 2, color)
    _vline(im, x, y - size // 2, y + size // 2, color)


def _clip_segment(p0, p1, W: int, H: int):
    """The part of segment p0-p1 inside [0, W-1] x [0, H-1] (Liang-Barsky),
    or None."""
    x0, y0 = float(p0[0]), float(p0[1])
    dx, dy = float(p1[0]) - x0, float(p1[1]) - y0
    t0, t1 = 0.0, 1.0
    for p, q in ((-dx, x0), (dx, W - 1 - x0), (-dy, y0), (dy, H - 1 - y0)):
        if p == 0:
            if q < 0:
                return None
            continue
        r = q / p
        if p < 0:
            t0 = max(t0, r)
        else:
            t1 = min(t1, r)
        if t0 > t1:
            return None
    return (x0 + t0 * dx, y0 + t0 * dy), (x0 + t1 * dx, y0 + t1 * dy)


def draw_line_aa(im: np.ndarray, p0, p1, color) -> None:
    """An anti-aliased line of width 1 from p0 to p1 (x, y), clipped to the
    image: at each integer step of the major axis the two pixels across it
    that straddle the ideal line, weighted by 1 - their distance to it along
    the minor axis, blended as cv2 blends (a in 0..255:
    p += ((c - p) * a + 127) >> 8). A segment of no length draws nothing
    (cv2's leaves ~1% of the colour on two pixels). Where the segment
    leaves the image it is cut at the border; cv2 (5.0) instead draws the
    part beyond the border along the border's last rows or columns."""
    H, W = im.shape[:2]
    seg = _clip_segment(p0, p1, W, H)
    if seg is None or tuple(p0) == tuple(p1):
        return
    (x0, y0), (x1, y1) = seg
    steep = abs(y1 - y0) > abs(x1 - x0)
    if steep:
        x0, y0, x1, y1 = y0, x0, y1, x1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    xs = np.arange(int(np.ceil(x0 - 1e-9)), int(np.floor(x1 + 1e-9)) + 1)
    if xs.size == 0:
        return
    slope = (y1 - y0) / (x1 - x0) if x1 > x0 else 0.0
    ys = y0 + (xs - x0) * slope
    base = np.floor(ys).astype(np.int64)
    frac = ys - base
    color = np.asarray(color, np.int32)
    for dy, w in ((0, 1.0 - frac), (1, frac)):
        a = np.rint(w * 255).astype(np.int32)
        r, c = base + dy, xs
        if steep:
            r, c = c, r
        keep = (a > 0) & (r >= 0) & (r < H) & (c >= 0) & (c < W)
        r, c, a = r[keep], c[keep], a[keep]
        p = im[r, c].astype(np.int32)
        im[r, c] = (p + (((color - p) * a[:, None] + 127) >> 8)).astype(im.dtype)


def _glyph(ch: str) -> np.ndarray:
    rows = [int(v, 16) for v in _GLYPHS.get(ch, _BOX).split()]
    rows += [0] * (9 - len(rows))
    return (np.asarray(rows)[:, None] >> np.arange(4, -1, -1)[None, :]) & 1  # (9, 5)


def draw_text(im: np.ndarray, text: str, org, color) -> None:
    """`text` with its baseline's left end at org (x, y): each character's
    5x7 glyph centred in its cell (the cells Hershey simplex's advances at
    TEXT_SCALE), rows 0-6 ending on the row above the baseline, rows 7-8
    below it, clipped to its cell and to the image."""
    H, W = im.shape[:2]
    x, y = (int(v) for v in org)
    pen = 0.0
    for ch in text:
        adv = (_ADVANCE[ord(ch) - 32] if 32 <= ord(ch) < 127 else _ADVANCE[0]) * TEXT_SCALE
        c0, c1 = x + int(round(pen)), x + int(round(pen + adv))
        g0 = c0 + (c1 - c0 - 5) // 2
        rr, cc = np.nonzero(_glyph(ch))
        rr, cc = rr + y - 7, cc + g0
        keep = (cc >= c0) & (cc < c1) & (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
        im[rr[keep], cc[keep]] = color
        pen += adv


def blend_labels(im: np.ndarray, label: np.ndarray, colors: np.ndarray, alpha: float) -> None:
    """The label overlay: each pixel of a class > 0 moved `alpha` of the way
    to its class colour, in float64, truncated to uint8 (in place)."""
    overlay = colors[np.clip(label, 0, colors.shape[0] - 1)]
    mask = label > 0
    im[mask] = ((1 - alpha) * im[mask] + alpha * overlay[mask]).astype(np.uint8)


class MinibatchVisualizer:
    """TRAIN.VISUALIZE hook: renders assembled host minibatches as PNGs.

    Port of `engine/visualize.py:MinibatchVisualizer`: the input image
    (the pixel means added back when it is float), the label overlay, the
    GT poses' projected 3D boxes and the GT centres' crosses, written as
    <out_dir>/vis_minibatch/iter<it:06d>_im<i>.png for the first
    `max_batches` calls."""

    def __init__(self, out_dir: str, num_classes: int, extents: np.ndarray, pixel_means=None, alpha: float = 0.4,
                 max_batches: int = 8):
        self.out_dir = os.path.join(out_dir, "vis_minibatch")
        self.num_classes = num_classes
        self.extents = np.asarray(extents)
        self.pixel_means = np.asarray(PIXEL_MEANS if pixel_means is None else pixel_means).reshape(1, 1, 3)
        self.alpha = alpha
        self.max_batches = max_batches
        self.colors = class_colors(num_classes)
        self._seen = 0
        os.makedirs(self.out_dir, exist_ok=True)

    def __call__(self, iteration: int, batch) -> None:
        if self._seen >= self.max_batches:
            return
        self._seen += 1
        data = np.asarray(batch["data"])
        labels = np.asarray(batch["gt_label_2d"])
        metas = np.asarray(batch["meta_data"])
        poses = np.asarray(batch.get("poses", np.zeros((0, 13), np.float32)))
        centers = batch.get("gt_centers")
        centers = None if centers is None else np.asarray(centers)
        for i in range(data.shape[0]):
            im = data[i][..., :3]
            if im.dtype != np.uint8:  # mean-subtracted float data
                im = np.clip(im + self.pixel_means, 0, 255).astype(np.uint8)
            im = np.ascontiguousarray(im).copy()
            label = labels[i]
            if (label >= 0).any():
                blend_labels(im, label, self.colors, self.alpha)
            K = metas[i, :9].reshape(3, 3)
            for row in poses:
                if int(row[0]) != i or row[1] <= 0:
                    continue
                c = int(row[1])
                color = self.colors[min(c, self.num_classes - 1)]
                quat, trans = row[6:10], row[10:13]
                if trans[2] > 0 and c < self.extents.shape[0]:
                    uv = project_box_corners(self.extents[c], quat, trans, K).astype(int)
                    for a, b in BOX_EDGES:
                        draw_line_aa(im, uv[a], uv[b], color)
            if centers is not None:
                for c, cx, cy in centers[i, :, :3]:
                    if int(c) > 0:
                        draw_cross(im, (int(cx), int(cy)), self.colors[min(int(c), self.num_classes - 1)])
            write_png(os.path.join(self.out_dir, f"iter{iteration:06d}_im{i}.png"), im)


class PredictionVisualizer:
    """`engine.test.test_net`'s `visualizer` hook (TEST.VISUALIZE, --vis):
    writes <out_dir>/<index:06d>-vis.png with the label overlay, each
    detection's box and class name, and its pose's projected 3D box (port
    of `engine/visualize.py:PredictionVisualizer`)."""

    def __init__(self, out_dir: str, classes: Sequence[str], extents: np.ndarray, alpha: float = 0.4):
        self.out_dir = out_dir
        self.classes = list(classes)
        self.extents = np.asarray(extents)
        self.alpha = alpha
        self.colors = class_colors(len(self.classes))
        os.makedirs(out_dir, exist_ok=True)

    def render(self, frame, out, rois: np.ndarray, poses) -> np.ndarray:
        """The overlay of one frame, (H, W, 3) uint8 BGR."""
        im = np.ascontiguousarray(frame.color[..., :3]).copy()
        label = np.asarray(out["label_2d"][0])
        if label.shape != im.shape[:2]:
            label = resize(label.astype(np.int32), (im.shape[1], im.shape[0]), interpolation=INTER_NEAREST)
        blend_labels(im, label, self.colors, self.alpha)
        K = np.asarray(frame.intrinsic_matrix, np.float64)
        for k in range(rois.shape[0]):
            c = int(rois[k, 1])
            if c <= 0 or c >= len(self.classes):
                continue
            color = self.colors[c]
            x1, y1, x2, y2 = rois[k, 2:6].astype(int)
            draw_rectangle(im, (x1, y1), (x2, y2), color)
            draw_text(im, self.classes[c], (x1, max(y1 - 3, 10)), color)
            if poses is not None and k < poses.shape[0] and poses[k, 6] > 0:
                uv = project_box_corners(self.extents[c], poses[k, :4], poses[k, 4:7], K).astype(int)
                for a, b in BOX_EDGES:
                    draw_line_aa(im, uv[a], uv[b], color)
        return im

    def __call__(self, index: int, frame, out, rois: np.ndarray, poses) -> None:
        write_png(os.path.join(self.out_dir, f"{index:06d}-vis.png"), self.render(frame, out, rois, poses))
