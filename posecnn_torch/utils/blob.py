"""Host image augmentation without cv2: the HLS jitter and the noise.

The port's copy of `posecnn_tpu/utils/blob.py:chromatic_transform` and
`add_noise` (lines 60-124), which run on the colour image of a training
batch whose input is not COLOR (and on the depth image of DEPTH and RGBD
inputs), and its motion blur (`motion_blur`, a copy of cv2's `filter2D`
for the noise's box kernels). They take the JAX package's draws from `rng` in its order, so a
host batch stays bit-equal to the JAX package's.

The colour conversions are cv2's for uint8 images (`cv2.cvtColor`
COLOR_BGR2HLS and COLOR_HLS2BGR), written out in float32 NumPy:
`bgr_to_hls` and `hls_to_bgr`. Each is a pure function of one pixel, equal
to cv2 on every input (2^24 BGR colours, 180 x 256 x 256 HLS triples). The
HLS hue of cv2's vector code is one fused multiply-add, which `_fma` computes
exactly in float64. `chromatic_transform` reads both through tables of every
input, built at first use (48 and 35 MB).

Besides, the blob helpers of `blob.py:17-57` that no path of either
package calls: `im_list_to_blob`, `prep_im_for_blob` (cv2's float32
INTER_LINEAR resize through `utils/resize.py`; a float32 image has the
means subtracted in place, as `astype(copy=False)` does there: ROADMAP
Queue 3 item 56) and `unpad_im`.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

_F32 = np.float32
_EPS = _F32(np.finfo(np.float32).eps)


BLUR_SIZES = (3, 5, 7, 9, 11, 15)


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 a * b + c with one rounding: the product of two float32 is
    exact in float64."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def bgr_to_hls(im: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 BGR -> uint8 HLS as `cv2.cvtColor(im, COLOR_BGR2HLS)`:
    H in [0, 180], L and S in [0, 255]."""
    f = im.astype(np.float32) * _F32(1.0 / 255.0)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = vmax - vmin
    total = vmax + vmin
    light = total * _F32(0.5)
    with np.errstate(divide="ignore", invalid="ignore"):
        sat = diff / np.where(light < _F32(0.5), total, _F32(2.0) - total)
        rmax, gmax = vmax == r, vmax == g
        num = np.where(rmax, g - b, np.where(gmax, b - r, r - g))
        base = np.where(rmax, np.where(g < b, _F32(360.0), _F32(0.0)), np.where(gmax, _F32(120.0), _F32(240.0)))
        hue = _fma(num, _F32(60.0) / diff, base) * _F32(0.5)
    chroma = diff > _EPS
    out = np.stack([np.where(chroma, hue, _F32(0.0)), light * _F32(255.0),
                    np.where(chroma, sat, _F32(0.0)) * _F32(255.0)], axis=-1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def hls_to_bgr(hls: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 HLS (H < 180) -> uint8 BGR as
    `cv2.cvtColor(hls, COLOR_HLS2BGR)`."""
    h = hls[..., 0].astype(np.float32)
    light = hls[..., 1].astype(np.float32) * _F32(1.0 / 255.0)
    sat = hls[..., 2].astype(np.float32) * _F32(1.0 / 255.0)
    ls = light * sat
    e0 = np.where(light <= _F32(0.5), ls, sat - ls)
    raw = h * _F32(6.0 / 180.0)
    whole = np.trunc(raw).astype(np.float32)
    frac = raw - whole
    sector = whole - _F32(6.0) * np.trunc(raw * _F32(1.0 / 6.0)).astype(np.float32)
    e1 = frac + frac
    tab0, tab1 = light + e0, light - e0
    tab2 = light + e0 - e0 * e1
    tab3 = light - e0 + e0 * e1
    b = np.where(sector < 2, tab1, np.where(sector <= 2, tab3, np.where(sector <= 4, tab0, tab2)))
    g = np.where(sector < 1, tab3, np.where(sector <= 2, tab0, np.where(sector < 4, tab2, tab1)))
    r = np.where(sector < 1, tab0, np.where(sector < 2, tab2, np.where(sector < 4, tab1,
                                                                       np.where(sector <= 4, tab3, tab0))))
    out = np.stack([b, g, r], axis=-1) * _F32(255.0)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def hls_tables():
    """(BGR -> HLS of every 24-bit colour, (2^24, 3); HLS -> BGR of every
    H < 180, L, S, (180 * 2^16, 3)), indexed by b<<16 | g<<8 | r and
    h<<16 | l<<8 | s."""
    to_hls = np.empty((1 << 24, 3), np.uint8)
    to_bgr = np.empty((180 << 16, 3), np.uint8)
    for start in range(0, 1 << 24, 1 << 20):  # in slices: the float32 temporaries stay small
        code = np.arange(start, start + (1 << 20), dtype=np.uint32)
        planes = np.stack([code >> 16, (code >> 8) & 255, code & 255], axis=-1).astype(np.uint8)
        to_hls[start:start + (1 << 20)] = bgr_to_hls(planes)
        if start < len(to_bgr):
            stop = min(start + (1 << 20), len(to_bgr))
            to_bgr[start:stop] = hls_to_bgr(planes[: stop - start])
    return to_hls, to_bgr


def _code(im: np.ndarray) -> np.ndarray:
    im = im.astype(np.uint32)
    return (im[..., 0] << 16) | (im[..., 1] << 8) | im[..., 2]


def chromatic_transform(
    im: np.ndarray,
    label: Optional[np.ndarray] = None,
    rng: Optional[np.random.RandomState] = None,
    d_h=None,
    d_s=None,
    d_l=None,
) -> np.ndarray:
    """Jitter hue, lightness and saturation in HLS space (BGR in and out,
    uint8 out): H + d_h modulo 180, L + d_l and S + d_s clipped to [0, 255]
    and truncated, each through a 256-entry table. The draws, in order:
    d_h, d_l, d_s, each `rng.rand(1)`. A float image is rounded and clipped
    to uint8 first. With `label`, pixels of label > 0 keep their colour."""
    rng = rng or np.random
    if d_h is None:
        d_h = (rng.rand(1) - 0.5) * 0.02 * 180
    if d_l is None:
        d_l = (rng.rand(1) - 0.5) * 0.2 * 256
    if d_s is None:
        d_s = (rng.rand(1) - 0.5) * 0.2 * 256
    if im.dtype != np.uint8:
        im = np.clip(np.round(im), 0, 255).astype(np.uint8)
    to_hls, to_bgr = hls_tables()
    hls = to_hls[_code(im)]
    base = np.arange(256, dtype=np.float64)
    lut_h = ((base + float(d_h)) % 180).astype(np.uint8)
    lut_l = np.clip(base + float(d_l), 0, 255).astype(np.uint8)
    lut_s = np.clip(base + float(d_s), 0, 255).astype(np.uint8)
    jittered = np.stack([lut_h[hls[..., 0]], lut_l[hls[..., 1]], lut_s[hls[..., 2]]], axis=-1)
    new_im = to_bgr[_code(jittered)]
    if label is not None:
        ys, xs = np.where(label > 0)
        new_im[ys, xs, :] = im[ys, xs, :]
    return new_im


def motion_blur(im: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """The motion-blur branch of `add_noise`: a kernel size drawn from
    BLUR_SIZES, then the axis (rand < 0.5: along x, else along y), and a box
    average of that size along the axis: `cv2.filter2D(im, -1, kernel /
    size)` with its default border (BORDER_REFLECT_101). The sum runs in
    float32 over the taps in order, each tap added by a fused multiply-add
    with the float32 weight 1 / size, as cv2's direct filter does. A uint8
    image is rounded to the nearest level (ties to even): for odd sizes an
    average of integers never lies within 1/(2 size) of a tie, so the sum's
    rounding cannot move a level. A float32 image keeps the sums: equal to
    cv2's for sizes 3-11; for 15 cv2 takes its DFT path, and the two differ
    in the last bits (5e-5 on values up to 255)."""
    size = BLUR_SIZES[int(rng.randint(len(BLUR_SIZES)))]
    axis = 1 if rng.rand(1) < 0.5 else 0
    r = (size - 1) // 2
    pad = [(0, 0)] * im.ndim
    pad[axis] = (r, r)
    src = np.pad(im, pad, mode="reflect").astype(np.float32)  # reflect: edge not repeated
    w = np.float32(1.0 / size)
    n = im.shape[axis]
    acc = np.zeros(im.shape, np.float32)
    for k in range(size):
        acc = _fma(np.take(src, np.arange(k, k + n), axis=axis), w, acc)
    if im.dtype == np.uint8:
        return np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return acc


def add_noise(image: np.ndarray, rng: Optional[np.random.RandomState] = None,
              force_blur: bool = False) -> np.ndarray:
    """90%: Gaussian noise, one float32 (H,W) field broadcast over the
    channels and the sum clipped to [0, 255] (float32 out); 10%: a motion
    blur (`motion_blur`, the image's dtype out). The draws:
    the gate `rng.rand(1)` (skipped with `force_blur`), then the variance's
    `rng.rand(1)` and `rng.randint(1 << 31)`, the seed of the field's
    `np.random.default_rng`, or the blur's size and axis."""
    rng = rng or np.random
    r = 1.0 if force_blur else rng.rand(1)
    if r < 0.9:
        row, col, _ = image.shape
        var = rng.rand(1) * 0.3 * 256
        sigma = float(var ** 0.5)
        gen = np.random.default_rng(int(rng.randint(1 << 31)))
        gauss = gen.standard_normal((row, col), dtype=np.float32) * np.float32(sigma)
        return np.clip(image.astype(np.float32) + gauss[:, :, None], 0, 255)
    return motion_blur(image, rng)


def im_list_to_blob(ims, num_channels: int) -> np.ndarray:
    """Prepared images (means subtracted, BGR) stacked into an NHWC float32
    blob at the largest height and width, zero-padded after."""
    max_shape = np.array([im.shape for im in ims]).max(axis=0)
    blob = np.zeros((len(ims), max_shape[0], max_shape[1], num_channels), dtype=np.float32)
    for i, im in enumerate(ims):
        blob[i, : im.shape[0], : im.shape[1], :] = im[:, :, np.newaxis] if num_channels == 1 else im
    return blob


def prep_im_for_blob(im: np.ndarray, pixel_means, target_size, max_size):
    """Subtract the means, then scale so the short side is `target_size`
    (the long one at most `max_size`), bilinear. Returns (image, scale). A
    float32 `im` is itself mean-subtracted (ROADMAP Queue 3 item 56)."""
    from posecnn_torch.utils.resize import INTER_LINEAR, resize

    im = im.astype(np.float32, copy=False)
    im -= pixel_means
    im_size_min = np.min(im.shape[0:2])
    im_size_max = np.max(im.shape[0:2])
    im_scale = float(target_size) / float(im_size_min)
    if np.round(im_scale * im_size_max) > max_size:
        im_scale = float(max_size) / float(im_size_max)
    return resize(im, None, fx=im_scale, fy=im_scale, interpolation=INTER_LINEAR), im_scale


def unpad_im(im: np.ndarray, factor: int) -> np.ndarray:
    """The image before `pad_im` padded it to a multiple of `factor`: the
    padding a side of its size would get is cut off."""
    height, width = im.shape[0], im.shape[1]
    pad_height = int(np.ceil(height / float(factor)) * factor - height)
    pad_width = int(np.ceil(width / float(factor)) * factor - width)
    return im[0:height - pad_height, 0:width - pad_width]
