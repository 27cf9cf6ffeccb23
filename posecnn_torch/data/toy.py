"""Synthetic toy dataset: procedurally rendered cuboids with exact 6-DoF
ground truth.

The port's own copy of `posecnn_tpu/data/toy.py`. The frames are bit-equal
to the JAX package's: the same `RandomState` draws in the same order. Its
cuboids are the object models the frames are rendered from (512 surface
points a class; the last class symmetric), so an ADD(-S) score on `toy` is
scored on the right models.

`load_frame(i)` seeds its draws from (seed, i) alone and bounds no index:
an index past `num_images` (a flipped roidb entry, `imdb.append_flipped_images`)
renders a new scene.
"""

from __future__ import annotations

import numpy as np

from posecnn_torch.data.imdb import imdb
from posecnn_torch.data.minibatch import Frame
from posecnn_torch.utils.quaternion_np import quat2mat


def _box_points(extent: np.ndarray, n: int = 512, rng=None) -> np.ndarray:
    """Sample points on the surface of a box with the given extent."""
    rng = rng or np.random.RandomState(0)
    pts = rng.rand(n, 3) - 0.5
    # push points to the surface of the unit box face by face
    face = rng.randint(0, 3, n)
    sign = rng.randint(0, 2, n) * 2 - 1
    for i in range(n):
        pts[i, face[i]] = 0.5 * sign[i]
    return (pts * extent).astype(np.float32)


class toy(imdb):
    """Procedural dataset with `num_classes-1` cuboid object classes."""

    def __init__(
        self,
        image_set: str = "train",
        num_classes: int = 4,
        num_images: int = 64,
        height: int = 96,
        width: int = 128,
        max_objects: int = 2,
        seed: int = 0,
    ):
        super().__init__(f"toy_{image_set}")
        self._classes = tuple(["__background__"] + [f"box_{i:02d}" for i in range(1, num_classes)])
        self._image_index = [f"{i:06d}" for i in range(num_images)]
        self.height, self.width = height, width
        self.max_objects = max_objects
        self.seed = seed
        rng = np.random.RandomState(seed)
        self._extents = np.zeros((num_classes, 3), dtype=np.float32)
        self._extents[1:] = 0.08 + 0.12 * rng.rand(num_classes - 1, 3)
        self._symmetry = np.zeros((num_classes,), dtype=np.float32)
        if num_classes > 2:
            self._symmetry[-1] = 1.0
        self._points_all = np.zeros((num_classes, 512, 3), dtype=np.float32)
        for c in range(1, num_classes):
            self._points_all[c] = _box_points(self._extents[c], 512, rng)
        self._points = [self._points_all[c] for c in range(num_classes)]
        self._colors = (rng.rand(num_classes, 3) * 200 + 55).astype(np.uint8)
        self.K = np.array(
            [[width * 0.9, 0, width / 2.0], [0, width * 0.9, height / 2.0], [0, 0, 1]],
            dtype=np.float64,
        )

    def gt_roidb(self):
        return [{"index": i, "flipped": False} for i in range(self.num_images)]

    def load_frame(self, i: int) -> Frame:
        rng = np.random.RandomState(self.seed * 100003 + i)
        H, W = self.height, self.width
        n_cls = self.num_classes
        n_obj = rng.randint(1, self.max_objects + 1)
        classes = rng.choice(np.arange(1, n_cls), size=min(n_obj, n_cls - 1), replace=False)

        color = np.full((H, W, 3), 30, dtype=np.uint8)
        label = np.zeros((H, W), dtype=np.int32)
        depth_m = np.full((H, W), np.inf, dtype=np.float32)
        poses = np.zeros((3, 4, len(classes)), dtype=np.float32)
        centers = np.zeros((len(classes), 2), dtype=np.float32)

        for j, cls in enumerate(classes):
            # random pose: depth 0.6..1.4, center within the inner image
            q = rng.randn(4)
            q /= np.linalg.norm(q)
            R = quat2mat(q)
            z = 0.6 + 0.8 * rng.rand()
            cx = W * (0.3 + 0.4 * rng.rand())
            cy = H * (0.3 + 0.4 * rng.rand())
            t = np.array(
                [
                    (cx - self.K[0, 2]) / self.K[0, 0] * z,
                    (cy - self.K[1, 2]) / self.K[1, 1] * z,
                    z,
                ]
            )
            poses[:, :3, j] = R
            poses[:, 3, j] = t
            centers[j] = [cx, cy]

            # splat the transformed surface points with a z-buffer
            pts = self._points_all[cls] @ R.T + t
            pix = (self.K @ pts.T).T
            px = np.round(pix[:, 0] / pix[:, 2]).astype(int)
            py = np.round(pix[:, 1] / pix[:, 2]).astype(int)
            ok = (px >= 0) & (px < W) & (py >= 0) & (py < H)
            for x, y, zc in zip(px[ok], py[ok], pts[ok, 2]):
                # 3x3 splat for contiguous coverage
                y0, y1 = max(0, y - 1), min(H, y + 2)
                x0, x1 = max(0, x - 1), min(W, x + 2)
                closer = depth_m[y0:y1, x0:x1] > zc
                depth_m[y0:y1, x0:x1] = np.where(closer, zc, depth_m[y0:y1, x0:x1])
                label[y0:y1, x0:x1] = np.where(closer, cls, label[y0:y1, x0:x1])
                color[y0:y1, x0:x1] = np.where(
                    closer[..., None], self._colors[cls][None, None, :], color[y0:y1, x0:x1]
                )

        depth_raw = np.where(np.isfinite(depth_m), depth_m * 1000.0, 0.0).astype(np.uint16)
        return Frame(
            color=color,
            label=label,
            depth=depth_raw,
            cls_indexes=np.asarray(classes, dtype=np.float32),
            poses=poses,
            center=centers,
            intrinsic_matrix=self.K,
            factor_depth=1000.0,
        )
