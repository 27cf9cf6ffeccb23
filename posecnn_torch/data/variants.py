"""The other datasets of the reference's registry, over the YCB-style loader.

The port's copy of `posecnn_tpu/data/variants.py`: each reference dataset
(lib/datasets/{ycb,ycb_single,lov_single,rgbd_scene,shapenet_scene,
shapenet_single,gmu_scene,yumi,sym}.py) differs from `data.lov.lov` in its
class list, symmetry flags, data root and index files; the frame files and
their reading are `lov`'s (-color/-depth/-label PNG and -meta.mat).

  ycb               the YCB objects with 024_bowl also symmetric, under
                    <root>/YCB, else <root>/LOV
  lov_single,       one YCB class against the background: labels, poses and
  ycb_single        centres remapped to it (`_SingleClassMixin`)
  rgbd_scene, shapenet_scene, shapenet_single, gmu_scene, yumi, sym
                    scenes with their own class lists (`_GenericScene`):
                    no model files, 0.1 m extents and one zero point a
                    class; sym's cube is symmetric
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from posecnn_torch.data.imdb import imdb
from posecnn_torch.data.lov import YCB_SYMMETRY, data_root, lov


class ycb(lov):
    """The YCB objects with the detection-era symmetry flags
    (lib/datasets/ycb.py:22-33: 024_bowl symmetric too)."""

    def __init__(self, image_set: str, path: Optional[str] = None):
        super().__init__(image_set, path)
        self._name = "ycb_" + image_set
        self._symmetry = np.array(
            [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1],
            dtype=np.float32,
        )

    def _get_default_path(self) -> str:
        p = os.path.join(data_root(), "YCB")
        return p if os.path.exists(p) else os.path.join(data_root(), "LOV")


class _SingleClassMixin:
    """The 2-class (background, object) remapping of the *_single datasets
    (lib/datasets/{lov_single,ycb_single}.py, gt_single_data_layer)."""

    def select_class(self, cls_name: str):
        self._single_cls = self._classes.index(cls_name)
        self._classes = ("__background__", cls_name)
        sym = np.zeros(2, dtype=np.float32)
        sym[1] = self._symmetry_all[self._single_cls]
        self._symmetry_all_classes = self._symmetry
        self._symmetry = sym
        pts = self._points_all
        self._points_all = np.zeros((2,) + pts.shape[1:], pts.dtype)
        self._points_all[1] = pts[self._single_cls]
        ext = self._extents
        self._extents = np.zeros((2, 3), ext.dtype)
        self._extents[1] = ext[self._single_cls]

    def remap_frame(self, frame):
        sel = np.where(frame.cls_indexes == self._single_cls)[0]
        frame.label = (frame.label == self._single_cls).astype(np.int32)
        frame.cls_indexes = np.ones(len(sel), dtype=np.float32)
        frame.poses = frame.poses[:, :, sel]
        frame.center = frame.center[sel]
        return frame


class lov_single(_SingleClassMixin, lov):
    """One YCB class against the background (lib/datasets/lov_single.py)."""

    def __init__(self, cls_name: str, image_set: str, path: Optional[str] = None):
        lov.__init__(self, image_set, path)
        self._symmetry_all = YCB_SYMMETRY
        self.select_class(cls_name)
        self._name = f"lov_single_{cls_name}_{image_set}"

    def load_frame(self, i: int):
        return self.remap_frame(super().load_frame(i))


class ycb_single(_SingleClassMixin, ycb):
    """One YCB class against the background (lib/datasets/ycb_single.py)."""

    def __init__(self, cls_name: str, image_set: str, path: Optional[str] = None):
        ycb.__init__(self, image_set, path)
        self._symmetry_all = self._symmetry
        self.select_class(cls_name)
        self._name = f"ycb_single_{cls_name}_{image_set}"

    def load_frame(self, i: int):
        return self.remap_frame(super().load_frame(i))


class _GenericScene(lov):
    """The scene datasets with class lists of their own: `lov`'s frames,
    none of its YCB models."""

    CLASSES = ("__background__",)
    DIRNAME = "SCENE"

    def __init__(self, image_set: str, path: Optional[str] = None):
        imdb.__init__(self, f"{self.DIRNAME.lower()}_{image_set}")
        self._image_set = image_set
        self._lov_path = path or self._get_default_path()
        self._data_path = os.path.join(self._lov_path, "data")
        self._classes = self.CLASSES
        self._class_colors = [(255, 255, 255)] + [
            (37 * i % 256, 91 * i % 256, 151 * i % 256) for i in range(1, len(self.CLASSES))
        ]
        self._symmetry = np.zeros(len(self.CLASSES), dtype=np.float32)
        C = len(self.CLASSES)
        self._points_all = np.zeros((C, 1, 3), dtype=np.float32)
        self._points = [self._points_all[c] for c in range(C)]
        self._extents = np.ones((C, 3), dtype=np.float32) * 0.1
        self._extents[0] = 0
        self._image_ext = ".png"
        self._image_index = self._load_image_set_index()

    def _get_default_path(self) -> str:
        return os.path.join(data_root(), self.DIRNAME)


class rgbd_scene(_GenericScene):
    """RGBD-Scenes v2 (lib/datasets/rgbd_scene.py:18)."""

    CLASSES = (
        "__background__", "bowl", "cap", "cereal_box", "coffee_mug",
        "coffee_table", "office_chair", "soda_can", "sofa", "table",
    )
    DIRNAME = "RGBDScene"


class shapenet_scene(_GenericScene):
    """ShapeNet rendered scenes (lib/datasets/shapenet_scene.py:18)."""

    CLASSES = ("__background__", "table", "tvmonitor", "bottle", "mug", "can", "keyboard", "cap")
    DIRNAME = "ShapeNetScene"


class shapenet_single(_GenericScene):
    CLASSES = ("__background__", "object")
    DIRNAME = "ShapeNetSingle"


class gmu_scene(_GenericScene):
    """GMU kitchen scenes (lib/datasets/gmu_scene.py:18)."""

    CLASSES = (
        "__background__", "coca_cola_glass_bottle", "coffee_mate_french_vanilla",
        "honey_bunches_of_oats_honey_roasted", "hunt_s_sauce", "mahatma_rice",
        "nature_valley_soft_baked_oatmeal_squares", "nutrigrain_apple_cinnamon",
        "palmolive_orange", "pop_secret_light_butter", "pringles_bbq", "red_bull",
    )
    DIRNAME = "GMU"


class yumi(_GenericScene):
    """The YuMi tabletop set (lib/datasets/yumi.py:27)."""

    CLASSES = ("__background__", "xmas_cup")
    DIRNAME = "YUMI"


class sym(_GenericScene):
    """The symmetry toy dataset (lib/datasets/sym.py:28)."""

    CLASSES = ("__background__", "cube")
    DIRNAME = "SYM"

    def __init__(self, image_set: str, path: Optional[str] = None):
        super().__init__(image_set, path)
        self._symmetry[1] = 1.0
