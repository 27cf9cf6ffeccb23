"""The YCB-Video dataset ("lov" in the reference, lib/datasets/lov.py).

The port's copy of `posecnn_tpu/data/lov.py`. It reads the reference's
layout under <root>/LOV:

  data/<seq>/<frame>-color.png, -depth.png, -label.png, -meta.mat
  models/<class>/points.xyz, extents.txt, <image_set>.txt (train.txt,
  val.txt, keyframe.txt, ...)

`load_frame(i)` reads the PNG files through `utils.png.imread` with
cv2's flags (colour BGR; label and depth unchanged) and the `-meta.mat`
through `scipy.io.loadmat` (cls_indexes, poses (3,4,N), a single pose's
(3,4) made (3,4,1), center, intrinsic_matrix, factor_depth). The model
points are `points.xyz` of each class, all cut to the smallest count
(`_points_all`); a missing file raises FileNotFoundError.

The root is `$POSECNN_DATA/LOV`, else the repository's `data/LOV`. The JAX
package also falls back to a reference checkout at a fixed path outside
the repository when `classes.txt` is missing (`posecnn_tpu/data/lov.py:
64-74`); that path is on no machine of this project, so the port leaves the
fallback out: a decided difference.

`YCB_CLASSES`, `YCB_CLASS_COLORS` and `YCB_SYMMETRY` live here, as in the
JAX package; the rest of the port imports them from this module.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from posecnn_torch import config as _config
from posecnn_torch.data.imdb import imdb

YCB_CLASSES = (
    "__background__",
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser", "024_bowl",
    "025_mug", "035_power_drill", "036_wood_block", "037_scissors",
    "040_large_marker", "051_large_clamp", "052_extra_large_clamp",
    "061_foam_brick",
)

# lib/datasets/lov.py:37: the ADD-S weighting of the training loss
YCB_SYMMETRY = np.array(_config.YCB_SYMMETRY, dtype=np.float32)

# the classes' label colours (the synthesizer's base colours)
YCB_CLASS_COLORS = [
    (255, 255, 255), (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
    (255, 0, 255), (0, 255, 255), (128, 0, 0), (0, 128, 0), (0, 0, 128),
    (128, 128, 0), (128, 0, 128), (0, 128, 128), (64, 0, 0), (0, 64, 0),
    (0, 0, 64), (64, 64, 0), (64, 0, 64), (0, 64, 64), (192, 0, 0),
    (0, 192, 0), (0, 0, 192),
]


def data_root() -> str:
    """$POSECNN_DATA, else the repository's data/ (the JAX loaders' root)."""
    return os.environ.get("POSECNN_DATA", os.path.join(os.path.dirname(__file__), "..", "..", "data"))


def read_meta(path: str) -> dict:
    """A `-meta.mat` file's annotations: cls_indexes (N,), poses (3,4,N),
    center, intrinsic_matrix and factor_depth (a float)."""
    import scipy.io

    meta = scipy.io.loadmat(path)
    poses = meta["poses"]
    if poses.ndim == 2:
        poses = poses.reshape(3, 4, 1)
    return {"cls_indexes": meta["cls_indexes"].flatten(), "poses": poses, "center": meta["center"],
            "intrinsic_matrix": meta["intrinsic_matrix"],
            "factor_depth": float(np.asarray(meta["factor_depth"]).flatten()[0])}


def read_frame(color: str, label: str, depth: str, meta: str, **kw):
    """The `Frame` of one frame's three PNG files and its `-meta.mat`
    (colour as cv2's IMREAD_COLOR, label and depth IMREAD_UNCHANGED)."""
    from posecnn_torch.data.minibatch import Frame
    from posecnn_torch.utils.png import IMREAD_COLOR, IMREAD_UNCHANGED, imread

    return Frame(color=imread(color, IMREAD_COLOR), label=imread(label, IMREAD_UNCHANGED),
                 depth=imread(depth, IMREAD_UNCHANGED), **read_meta(meta), **kw)


class lov(imdb):
    """YCB-Video: 21 objects and the background (`posecnn_tpu/data/lov.py:49`)."""

    def __init__(self, image_set: str, lov_path: Optional[str] = None):
        super().__init__("lov_" + image_set)
        self._image_set = image_set
        self._lov_path = lov_path or self._get_default_path()
        self._data_path = os.path.join(self._lov_path, "data")
        self._classes = YCB_CLASSES
        self._class_colors = YCB_CLASS_COLORS
        self._symmetry = YCB_SYMMETRY.copy()
        self._points, self._points_all = self._load_object_points()
        self._extents = self._load_object_extents()
        self._image_ext = ".png"
        self._image_index = self._load_image_set_index()

    def _get_default_path(self) -> str:
        return os.path.join(data_root(), "LOV")

    def _load_image_set_index(self) -> List[str]:
        image_set_file = os.path.join(self._lov_path, self._image_set + ".txt")
        if not os.path.exists(image_set_file):
            return []
        with open(image_set_file) as f:
            return [x.rstrip("\n") for x in f.readlines()]

    def _load_object_points(self):
        """points.xyz per class, all cut to the smallest count (lov.py:141-158)."""
        points = [np.zeros((0, 3))] * self.num_classes
        num = np.inf
        for i in range(1, self.num_classes):
            point_file = os.path.join(self._lov_path, "models", self._classes[i], "points.xyz")
            if not os.path.exists(point_file):
                raise FileNotFoundError(f"missing {point_file}")
            points[i] = np.loadtxt(point_file)
            num = min(num, points[i].shape[0])
        points_all = np.zeros((self.num_classes, int(num), 3), dtype=np.float32)
        for i in range(1, self.num_classes):
            points_all[i, :, :] = points[i][: int(num), :]
        return points, points_all

    def _load_object_extents(self) -> np.ndarray:
        extent_file = os.path.join(self._lov_path, "extents.txt")
        if not os.path.exists(extent_file):
            raise FileNotFoundError(f"missing {extent_file}")
        extents = np.zeros((self.num_classes, 3), dtype=np.float32)
        extents[1:, :] = np.loadtxt(extent_file)
        return extents

    def image_path_at(self, i: int) -> str:
        return os.path.join(self._data_path, self._image_index[i] + "-color" + self._image_ext)

    def depth_path_at(self, i: int) -> str:
        return os.path.join(self._data_path, self._image_index[i] + "-depth" + self._image_ext)

    def label_path_at(self, i: int) -> str:
        return os.path.join(self._data_path, self._image_index[i] + "-label" + self._image_ext)

    def metadata_path_at(self, i: int) -> str:
        return os.path.join(self._data_path, self._image_index[i] + "-meta.mat")

    def gt_roidb(self) -> List[Dict]:
        return [
            {
                "image": self.image_path_at(i),
                "depth": self.depth_path_at(i),
                "label": self.label_path_at(i),
                "meta_data": self.metadata_path_at(i),
                "flipped": False,
            }
            for i in range(self.num_images)
        ]

    def load_frame(self, i: int):
        """Frame i (its roidb entry's files), read on the host."""
        return read_frame(self.image_path_at(i), self.label_path_at(i), self.depth_path_at(i),
                          self.metadata_path_at(i))
