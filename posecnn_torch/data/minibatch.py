"""Host-side training data, in numpy: frames and the host minibatch.

The port's own copies of `posecnn_tpu/data/minibatch.py`: `Frame`,
`MinibatchConfig`, `flip_poses`, `flip_frame`, `pose_rows` (:308),
`rescale_points` (:319) and `get_minibatch` (:335-528), and of
`posecnn_tpu/utils/blob.py:pad_im`; `load_frozen_frame` reads one frozen
frame (`data/lov_syn_val_v4/*.npz`, with its depth where the file has one).

`get_minibatch` builds the batch with device targets (`TPU.DEVICE_TARGETS`):
uint8 frames padded to a multiple of 16, the int32 labels, the (B, MAX_GT,
4) table of GT centres [cls, cx, cy, z], the (MAX_GT, 13) GT pose rows and
K in meta_data. For the COLOR input, with CHROMATIC three HLS deltas an
image, drawn from `rng` in the JAX package's order, which the train step
applies on the device; with ADD_NOISE, per image a gate, then either the
sigma of the Gaussian noise the train step adds on the device (90%) or a
motion blur applied here (10%, `utils.blob.motion_blur`). For the DEPTH,
RGBD and NORMAL inputs the jitter and the noise run here
(`utils.blob.chromatic_transform`, `add_noise`), and the input image is
the depth image (`depth_input_image`), the colour image with the depth
image as `data_p` (RGBD), or the normal image (`normals_np`,
`normal_input_image`). With VERTEX_REG_3D each image carries the scaled
object coordinates of its pixels' classes (`vertex_targets_3d`, from the
frame's `vertmap`) instead of the centre table. With TRAIN.GAN the jitter
and the noise run here for the COLOR input too, and the batch carries the
jittered image scaled to [-1, 1] (`data_gan`) and the generator's noise
(`gan_z`). An adaptation frame (`is_adaptation`, the domain stream of
`data.layer`) has the label -1 everywhere, no centre rows and no pose
rows. A synthetic frame (`is_synthetic`) is pasted over a background drawn
from `backgrounds` (`composite_background`, after the padding), where there
are any; TRAIN.SCALES_BASE rescales each frame first (`scale_frame`). The
resizes are cv2's (`utils.resize`), and a background given as a path is
read by `utils.png.imread`: a JPEG raises NotImplementedError naming it
(the JAX package skips a background that cv2 cannot read).

Dense host targets (TPU.DEVICE_TARGETS False, `minibatch.py:108-181`,
:356-360, :439-447, :517-528): the images are float32 with the pixel means
subtracted here, after the jitter and the noise, which then run here for
every input; each image carries its (H,W,3C) vertex targets and weights
(`generate_vertex_targets`: the 2D unit direction to the instance's
projected centre and log z, each pixel routed by the instance mask where a
class has several instances, else to the class's first instance); the
batch carries the ADD loss's rescaled points, the symmetry and the
extents.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

import math

import numpy as np

from posecnn_torch.native import bilateral_filter
from posecnn_torch.utils.blob import BLUR_SIZES, add_noise, chromatic_transform, motion_blur  # noqa: F401
from posecnn_torch.utils.meta import build_meta_data
from posecnn_torch.utils.png import IMREAD_COLOR, imread
from posecnn_torch.utils.quaternion_np import mat2quat
from posecnn_torch.utils.resize import INTER_LINEAR, INTER_NEAREST, resize


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
    is_synthetic: bool = False    # composite over a random background
    is_adaptation: bool = False   # an unlabelled frame of the domain stream
    flipped: bool = False         # mirror horizontally when batched
    # instance mask: pixel value j + 1 for poses[:, :, j] (multi-instance
    # frames), and the per-pixel object coordinates (H,W,3) in the model
    # frame that VERTEX_REG_3D trains on
    mask: Optional[np.ndarray] = None
    vertmap: Optional[np.ndarray] = None


@dataclass
class MinibatchConfig:
    """`posecnn_tpu/data/minibatch.py:MinibatchConfig`, field for field."""

    num_classes: int = 22
    pixel_means: np.ndarray = field(default_factory=lambda: np.array([[[102.9801, 115.9465, 122.7717]]]))
    chromatic: bool = True
    add_noise: bool = False
    vertex_reg: bool = True
    vertex_reg_3d: bool = False
    vertex_w_inside: float = 10.0
    max_gt: int = 24
    scale: float = 1.0
    is_symmetric: bool = True
    input_format: str = "COLOR"
    gan: bool = False
    device_targets: bool = False


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


def rescale_points(points: np.ndarray, extents: np.ndarray, symmetry: np.ndarray,
                   is_symmetric: bool = True) -> np.ndarray:
    """The ADD loss's model points, scaled per class by max(10, 2/extent)
    and 4x more for a symmetric class when `is_symmetric` (reference
    minibatch.py:49-63)."""
    out = points.copy()
    for i in range(1, points.shape[0]):
        ext_max = np.amax(extents[i, :])
        weight = 2.0 / ext_max if ext_max > 0 else 10.0
        if weight < 10:
            weight = 10
        if symmetry[i] > 0 and is_symmetric:
            out[i] = 4 * weight * points[i]
        else:
            out[i] = weight * points[i]
    return out


def flip_poses(poses: np.ndarray, K: np.ndarray, width: int) -> np.ndarray:
    """Mirror object poses for a horizontally flipped image: with K1 = K
    after fx -> -fx, cx -> width - cx, the flipped pose is K^-1 K1 [R|t]."""
    K = np.asarray(K, np.float64)
    K1 = K.copy()
    K1[0, 0] = -K1[0, 0]
    K1[0, 2] = width - K1[0, 2]
    A = np.linalg.inv(K) @ K1
    out = poses.copy()
    for j in range(poses.shape[2]):
        out[:, :, j] = A @ poses[:, :, j]
    return out


def flip_frame(fr: Frame) -> Frame:
    """The frame mirrored horizontally: colour, label, depth, mask and
    vertmap flipped, centres x -> width - x, poses through `flip_poses`;
    `flipped` cleared."""
    width = fr.color.shape[1]
    center = fr.center.copy()
    center[:, 0] = width - center[:, 0]
    return replace(
        fr,
        color=np.ascontiguousarray(fr.color[:, ::-1]),
        label=np.ascontiguousarray(fr.label[:, ::-1]),
        depth=np.ascontiguousarray(fr.depth[:, ::-1]) if fr.depth is not None else None,
        mask=np.ascontiguousarray(fr.mask[:, ::-1]) if fr.mask is not None else None,
        vertmap=np.ascontiguousarray(fr.vertmap[:, ::-1]) if fr.vertmap is not None else None,
        center=center,
        poses=flip_poses(fr.poses, fr.intrinsic_matrix, width),
        flipped=False,  # consumed
    )


def scale_frame(fr: Frame, s: float) -> Frame:
    """The frame rescaled by `s` (TRAIN/TEST.SCALES_BASE,
    `posecnn_tpu/data/minibatch.py:scale_frame`): colour bilinear; label
    (as int32), depth, mask and vertmap nearest; centres times s. K is
    scaled by `build_meta_data`; the 3D poses do not change."""
    def rs(a, interp):
        return resize(a, None, s, s, interp)

    return replace(
        fr,
        color=rs(fr.color, INTER_LINEAR),
        label=rs(fr.label.astype(np.int32), INTER_NEAREST),
        depth=rs(fr.depth, INTER_NEAREST) if fr.depth is not None else None,
        mask=rs(fr.mask, INTER_NEAREST) if fr.mask is not None else None,
        vertmap=rs(fr.vertmap, INTER_NEAREST) if fr.vertmap is not None else None,
        center=fr.center * s,
    )


def composite_background(color: np.ndarray, label: np.ndarray, background: np.ndarray) -> np.ndarray:
    """The background resized bilinearly to the image, with the image's
    labelled pixels (label > 0) pasted over it
    (`posecnn_tpu/data/minibatch.py:composite_background`)."""
    out = resize(background, (color.shape[1], color.shape[0]), interpolation=INTER_LINEAR)
    I = np.where(label > 0)
    out[I[0], I[1], :] = color[I[0], I[1], :3]
    return out


def scale_vertmap(vertmap: np.ndarray, index, extents: np.ndarray) -> np.ndarray:
    """Object coordinates at the pixels `index` = (ys, xs), normalized to
    [0,1] per axis by the class extent (`minibatch.py:scale_vertmap` :84,
    the reference's `_scale_vertmap`); an axis of zero extent gives 0."""
    out = np.zeros((len(index[0]), 3), dtype=np.float32)
    for i in range(3):
        vmin, vmax = -extents[i] / 2.0, extents[i] / 2.0
        if vmax - vmin > 0:
            a = 1.0 / (vmax - vmin)
            b = -vmin / (vmax - vmin)
        else:
            a = b = 0.0
        out[:, i] = a * vertmap[index[0], index[1], i] + b
    return out


def unscale_vertmap(scaled: np.ndarray, cls_index: int, extents: np.ndarray) -> np.ndarray:
    """The inverse of `scale_vertmap` for one class (`minibatch.py:99`):
    [0,1]^3 -> model coordinates."""
    out = np.zeros_like(scaled, dtype=np.float32)
    for i in range(3):
        vmin, vmax = -extents[cls_index, i] / 2.0, extents[cls_index, i] / 2.0
        out[..., i] = scaled[..., i] * (vmax - vmin) + vmin
    return out


def _write_targets_2d(targets, weights, y, x, cx, cy, z, cls, w_inside):
    """The 2D targets of the pixels (y, x) of one instance of class `cls`
    (`minibatch.py:108-117`): the unit vector from the pixel to the centre
    (cx, cy), then log z, on the class's 3 channels, weight `w_inside`."""
    c = np.array([[cx], [cy]], dtype=np.float32)
    R = np.tile(c, (1, len(x))) - np.vstack((x, y))
    N = np.linalg.norm(R, axis=0) + 1e-10
    R = R / np.tile(N, (2, 1))
    targets[y, x, 3 * cls + 0] = R[0, :]
    targets[y, x, 3 * cls + 1] = R[1, :]
    targets[y, x, 3 * cls + 2] = math.log(z)
    weights[y, x, 3 * cls:3 * cls + 3] = w_inside


def generate_vertex_targets(im_label: np.ndarray, cls_indexes: np.ndarray, centers: np.ndarray, poses: np.ndarray,
                            num_classes: int, vertex_weights_value: float = 10.0, mask: Optional[np.ndarray] = None,
                            vertmap: Optional[np.ndarray] = None, extents: Optional[np.ndarray] = None,
                            vertex_reg_3d: bool = False):
    """Per-pixel vertex targets and weights, (H,W,3C) float32 each
    (`minibatch.py:generate_vertex_targets` :120-181). 2D: the unit
    direction to the instance's projected centre and log of its z
    (`_write_targets_2d`); 3D: the object coordinates scaled by the class's
    extent (`scale_vertmap`). Several instances of one class with a `mask`
    (pixel value = instance slot + 1): each pixel by its own instance;
    otherwise per class, by the first instance of it the frame has (the
    device path's rule, the nearest centre, differs)."""
    height, width = im_label.shape
    targets = np.zeros((height, width, 3 * num_classes), dtype=np.float32)
    weights = np.zeros((height, width, 3 * num_classes), dtype=np.float32)

    def write(y, x, cls, j):
        if vertex_reg_3d:
            targets[y, x, 3 * cls:3 * cls + 3] = scale_vertmap(vertmap, (y, x), extents[cls, :])
            weights[y, x, 3 * cls:3 * cls + 3] = vertex_weights_value
        else:
            _write_targets_2d(targets, weights, y, x, centers[j, 0], centers[j, 1], poses[2, 3, j], cls,
                              vertex_weights_value)

    if mask is not None and len(np.unique(cls_indexes)) < len(cls_indexes):
        for j in range(len(cls_indexes)):
            cls = int(cls_indexes[j])
            if cls <= 0 or cls >= num_classes:
                continue
            y, x = np.where((mask == j + 1) & (im_label == cls))
            if len(x) > 0:
                write(y, x, cls, j)
    else:
        for i in range(1, num_classes):
            y, x = np.where(im_label == i)
            ind = np.where(cls_indexes == i)[0]
            if len(x) > 0 and len(ind) > 0:
                write(y, x, i, ind[0])
    return targets, weights


def vertex_targets_3d(im_label: np.ndarray, cls_indexes: np.ndarray, num_classes: int, weight: float,
                      vertmap: np.ndarray, extents: np.ndarray, mask: Optional[np.ndarray] = None):
    """The 3D branches of `generate_vertex_targets`: each labelled pixel's
    scaled object coordinates and `weight` on its class's 3 channels."""
    return generate_vertex_targets(im_label, cls_indexes, None, None, num_classes, weight, mask=mask,
                                   vertmap=vertmap, extents=extents, vertex_reg_3d=True)


def depth_input_image(depth: np.ndarray) -> np.ndarray:
    """Depth -> the DEPTH input image: depth / max * 255 in float32, tiled
    over 3 channels (`posecnn_tpu/data/minibatch.py:243-250`)."""
    d = depth.astype(np.float32)
    m = float(d.max())
    if m > 0:
        d = d / m * 255.0
    return np.tile(d[:, :, None], (1, 1, 3))


def normals_np(depth_m: np.ndarray, K: np.ndarray, depth_cutoff: float = 20.0) -> np.ndarray:
    """(H,W,3) float32 unit normals of a depth map in metres
    (`posecnn_tpu/data/minibatch.py:253-271`): central differences of the
    back-projected points, their cross product, turned towards the camera,
    zero where the depth is 0 or past `depth_cutoff`."""
    h, w = depth_m.shape
    fx, fy, px, py = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = np.arange(w, dtype=np.float32)[None, :]
    y = np.arange(h, dtype=np.float32)[:, None]
    pts = np.stack([(x - px) / fx * depth_m, (y - py) / fy * depth_m, depth_m], axis=-1)
    dx = np.gradient(pts, axis=1)
    dy = np.gradient(pts, axis=0)
    n = np.cross(dy, dx)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-8)
    flip = np.sum(n * pts, axis=-1, keepdims=True) > 0
    n = np.where(flip, -n, n)
    valid = (depth_m > 0) & (depth_m < depth_cutoff)
    return np.where(valid[..., None], n, 0.0).astype(np.float32)


def normal_input_image(depth: np.ndarray, factor_depth: float, K: np.ndarray) -> np.ndarray:
    """Depth -> the NORMAL input image (`posecnn_tpu/data/minibatch.py:
    274-282`): normals mapped to 127.5 n + 127.5 and truncated to uint8, in
    BGR order, smoothed by the bilateral filter (d 9, sigma 75 and 75:
    `native.bilateral_filter`, cv2's `bilateralFilter`); float32 out."""
    nmap = normals_np(depth.astype(np.float32) / float(factor_depth), K)
    im = (127.5 * nmap + 127.5).astype(np.uint8)
    im = im[:, :, (2, 1, 0)]
    im = bilateral_filter(im, 9, 75, 75)
    return im.astype(np.float32)


def get_minibatch(frames: List[Frame], mcfg: MinibatchConfig, rng: np.random.RandomState,
                  extents: Optional[np.ndarray] = None, backgrounds: Sequence = (),
                  points: Optional[np.ndarray] = None, symmetry: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """The host batch of `frames` with fixed shapes
    (`posecnn_tpu/data/minibatch.py:get_minibatch`). With device targets:

      data         (B,H,W,3)      uint8   BGR, padded to a multiple of 16; the
                                          depth or normal image for DEPTH and
                                          NORMAL
      data_p       (B,H,W,3)      uint8   the depth image (RGBD)
      gt_label_2d  (B,H,W)        int32
      meta_data    (B,48)         float32
      poses        (max_gt,13)    float32 GT pose rows, column 0 the image
      gt_centers   (B,max_gt,4)   float32 [cls, cx, cy, z] (vertex_reg)
      vertex_targets3 (B,H,W,3)   float32 scaled object coordinates of each
                                          pixel's class (vertex_reg_3d, in
                                          place of gt_centers; needs
                                          `extents` (C,3) and frames with a
                                          vertmap)
      vertex_weights3 (B,H,W)     float32 their weights
      chroma_dhls  (B,3)          float32 HLS deltas (chromatic, COLOR)
      noise_sigma  (B,)           float32 Gaussian noise sigma, 0 for a
                                          blurred image (add_noise, COLOR)
      data_gan     (B,H,W,3)      float32 the jittered image / 127.5 - 1
                                          (gan)
      gan_z        (B,100)        float32 U(-1, 1) (gan)

    A frame marked `flipped` is mirrored first (`flip_frame`). The draws of
    `rng`, an image at a time. COLOR: the three chroma deltas (`rng.rand(1)`
    each), which the train step applies, then the noise gate (`rng.rand(1)`
    < 0.9: noise) and either the sigma's `rng.rand(1)` or `motion_blur`'s
    size and axis. GAN and the other inputs: the jitter and the noise run
    here on the colour image (`utils.blob.chromatic_transform`,
    `add_noise`), whose draws are taken even where the image is then
    replaced: DEPTH and RGBD build the depth image (`depth_input_image`,
    from zeros for a frame without depth) and draw its own `add_noise`;
    NORMAL builds the normal image (`normal_input_image`). With `gan`,
    `gan_z`'s draw comes after every image's (`minibatch.py:500-506`).
    An adaptation frame's label is -1 everywhere; it adds no centre rows
    (zero targets with VERTEX_REG_3D) and no pose rows. Before all of
    these, a frame is rescaled by `mcfg.scale` when it is not 1
    (`scale_frame`), and a synthetic frame, where `backgrounds` (arrays or
    paths) has any, is pasted over `backgrounds[rng.randint(len)]`
    (`composite_background`) after the padding: the draw comes before the
    frame's jitter draws.

    Dense host targets (`mcfg.device_targets` False): `data` and `data_p`
    are float32 with the pixel means subtracted, the jitter and the noise
    run here for every input (COLOR too: no chroma_dhls, no noise_sigma),
    and the batch carries, in place of gt_centers or the compact 3D blobs:

      vertex_targets (B,H,W,3C)  float32 `generate_vertex_targets`, zeros for
                                         an adaptation frame (vertex_reg)
      vertex_weights (B,H,W,3C)  float32
      points         (C,P,3)     float32 `rescale_points(points, extents,
                                         symmetry, is_symmetric)`
      symmetry       (C,)                 zeros unless is_symmetric
      extents        (C,3)"""
    dense = not mcfg.device_targets
    if dense and (points is None or symmetry is None or extents is None):
        raise ValueError("dense host targets (device_targets False) carry the points, symmetry and extents: "
                         "pass all three")
    host_aug = mcfg.input_format != "COLOR" or mcfg.gan or dense

    def finish(im):
        return _mean_subtracted(im, mcfg.pixel_means) if dense else _to_u8(im)

    want_depth_input = mcfg.input_format in ("DEPTH", "RGBD")
    want_normal_input = mcfg.input_format == "NORMAL"
    ims, ims_p, labels, metas, center_rows, chroma_rows, noise_sigmas = [], [], [], [], [], [], []
    vt3, vw3, gan_ims, vtargets, vweights = [], [], [], [], []
    C = mcfg.num_classes
    pose_blob = np.zeros((0, 13), dtype=np.float32)
    for i, fr in enumerate(frames):
        if fr.flipped:
            fr = flip_frame(fr)
        if mcfg.scale != 1.0:
            fr = scale_frame(fr, mcfg.scale)
        im = pad_im(fr.color, 16)
        label = pad_im(fr.label.astype(np.int32), 16)
        if fr.is_synthetic and len(backgrounds):
            bg = backgrounds[rng.randint(len(backgrounds))]
            if isinstance(bg, str):  # a path of the bank: read as cv2.imread(bg, IMREAD_COLOR)
                bg = imread(bg, IMREAD_COLOR)
            im = composite_background(im, label, bg)
        if mcfg.chromatic:
            if host_aug:
                im = chromatic_transform(im, rng=rng)
            else:
                chroma_rows.append([
                    float((rng.rand(1)[0] - 0.5) * 0.02 * 180),
                    float((rng.rand(1)[0] - 0.5) * 0.2 * 256),
                    float((rng.rand(1)[0] - 0.5) * 0.2 * 256),
                ])
        if mcfg.add_noise:
            if host_aug:
                im = add_noise(im, rng=rng)
            elif rng.rand(1)[0] < 0.9:
                noise_sigmas.append(float(rng.rand(1)[0] * 0.3 * 256) ** 0.5)
            else:
                im = motion_blur(im, rng)
                noise_sigmas.append(0.0)
        if want_depth_input or want_normal_input:
            depth_raw = pad_im(fr.depth, 16) if fr.depth is not None else np.zeros(im.shape[:2], np.float32)
            if want_depth_input:
                im_d = depth_input_image(depth_raw)
                if mcfg.add_noise:
                    im_d = add_noise(im_d, rng=rng)
                if mcfg.input_format == "DEPTH":
                    im = im_d
                else:
                    ims_p.append(finish(im_d))
            else:
                im = normal_input_image(depth_raw, fr.factor_depth, fr.intrinsic_matrix)
        if mcfg.gan:
            gan_ims.append(im[..., :3].astype(np.float32) / 127.5 - 1.0)
        ims.append(finish(im))
        metas.append(build_meta_data(fr.intrinsic_matrix, mcfg.scale))
        if fr.is_adaptation:
            # no labels: the domain head alone reads the frame (minibatch.py:436-445)
            labels.append(-1 * np.ones_like(label))
            center_rows.append(np.zeros((0, 4), np.float32))
            if dense:
                vtargets.append(np.zeros(label.shape + (3 * C,), dtype=np.float32))
                vweights.append(np.zeros(label.shape + (3 * C,), dtype=np.float32))
            elif mcfg.vertex_reg_3d:
                vt3.append(np.zeros(label.shape + (3,), dtype=np.float32))
                vw3.append(np.zeros(label.shape, dtype=np.float32))
            continue
        labels.append(label)
        if mcfg.vertex_reg and mcfg.vertex_reg_3d and fr.vertmap is None:
            raise ValueError("VERTEX_REG_3D training needs Frame.vertmap (per-pixel object coordinates), "
                             "and a frame of the batch has none")
        if mcfg.vertex_reg and dense:
            mask = pad_im(fr.mask, 16) if fr.mask is not None else None
            vertmap = pad_im(fr.vertmap, 16) if fr.vertmap is not None else None
            t, w = generate_vertex_targets(label, fr.cls_indexes, fr.center, fr.poses, C, mcfg.vertex_w_inside,
                                           mask=mask, vertmap=vertmap, extents=extents,
                                           vertex_reg_3d=mcfg.vertex_reg_3d)
            vtargets.append(t)
            vweights.append(w)
        elif mcfg.vertex_reg and mcfg.vertex_reg_3d:
            mask = pad_im(fr.mask, 16) if fr.mask is not None else None
            t, w = vertex_targets_3d(label, fr.cls_indexes, C, mcfg.vertex_w_inside, pad_im(fr.vertmap, 16),
                                     np.asarray(extents), mask)
            # the 3 channels of each pixel's class (minibatch.py:460-470)
            lab_safe = np.clip(label, 0, C - 1)
            idx = (3 * lab_safe[..., None] + np.arange(3)).reshape(*label.shape, 3)
            vt3.append(np.take_along_axis(t, idx, axis=2))
            vw3.append(np.take_along_axis(w, idx[..., :1], axis=2)[..., 0])
        elif mcfg.vertex_reg:
            n_inst = fr.poses.shape[2]
            rows = np.zeros((n_inst, 4), np.float32)
            rows[:, 0] = fr.cls_indexes[:n_inst]
            rows[:, 1:3] = fr.center[:n_inst]
            rows[:, 3] = fr.poses[2, 3, :n_inst]
            center_rows.append(rows)
        pose_blob = np.concatenate([pose_blob, pose_rows(i, fr)], axis=0)

    gt = np.zeros((mcfg.max_gt, 13), dtype=np.float32)
    n = min(len(pose_blob), mcfg.max_gt)
    gt[:n] = pose_blob[:n]
    batch = {
        "data": np.stack(ims),
        "gt_label_2d": np.stack(labels).astype(np.int32),
        "meta_data": np.stack(metas).astype(np.float32),
        "poses": gt,
    }
    if noise_sigmas:
        batch["noise_sigma"] = np.asarray(noise_sigmas, np.float32)
    if chroma_rows:
        batch["chroma_dhls"] = np.asarray(chroma_rows, np.float32)
    if ims_p:
        batch["data_p"] = np.stack(ims_p)
    if gan_ims:
        batch["data_gan"] = np.stack(gan_ims)
        batch["gan_z"] = rng.uniform(-1, 1, (len(gan_ims), 100)).astype(np.float32)
    if mcfg.vertex_reg and dense:
        batch["vertex_targets"] = np.stack(vtargets)
        batch["vertex_weights"] = np.stack(vweights)
    elif mcfg.vertex_reg and mcfg.vertex_reg_3d:
        batch["vertex_targets3"] = np.stack(vt3)
        batch["vertex_weights3"] = np.stack(vw3)
    elif mcfg.vertex_reg:
        gc = np.zeros((len(frames), mcfg.max_gt, 4), np.float32)
        for i, rows in enumerate(center_rows):
            k = min(len(rows), mcfg.max_gt)
            gc[i, :k] = rows[:k]
        batch["gt_centers"] = gc
    if dense:
        # the static blobs ride in every dense batch (minibatch.py:524-528)
        batch["points"] = rescale_points(points, extents, symmetry, mcfg.is_symmetric)
        batch["symmetry"] = symmetry if mcfg.is_symmetric else np.zeros_like(symmetry)
        batch["extents"] = extents
    return batch


def _to_u8(im: np.ndarray) -> np.ndarray:
    """An image of the batch on the device-targets path: rounded and clipped
    to uint8, its first 3 channels."""
    return np.ascontiguousarray(np.clip(np.round(im[..., :3]), 0, 255)).astype(np.uint8)


def _mean_subtracted(im: np.ndarray, pixel_means: np.ndarray) -> np.ndarray:
    """An image of a dense-targets batch: its first 3 channels as float32
    less the pixel means, in the means' precision, then float32
    (`minibatch.py:356-360`, :508)."""
    return (im[..., :3].astype(np.float32) - pixel_means).astype(np.float32)
