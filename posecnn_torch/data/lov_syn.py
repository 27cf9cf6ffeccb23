"""Frozen synthetic YCB frames (`data/lov_syn_val_v4/`, `data/lov_syn_val_v3/`)
as a dataset.

The counterpart of `posecnn_tpu/data/synthetic.py:FrozenSyntheticDataset`:
`load_frame(i)` reads frame i (color, label, depth in `factor_depth`
units, poses, centres, K), marked synthetic as JAX marks it, and checks it
against the committed manifest's hash. The object models (points,
extents, symmetry, class colours) are those of `base` when one is given:
the factory passes `lov("train")` where a YCB-Video tree with its models
is under the data root, as the JAX factory always does. Without one they
are stand-ins (`object_models`): 0.1 m extents and 1024 points a class
drawn uniformly inside them from a fixed seed, the raw points of the
training entry's ADD loss. ADD-S numbers scored on the stand-ins are not
comparable with the paper's or with the JAX package's history, which used
the real models.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from dataclasses import replace

from posecnn_torch.config import ADD_NUM_POINTS, YCB_SYMMETRY
from posecnn_torch.data.lov import YCB_CLASS_COLORS, YCB_CLASSES
from posecnn_torch.data.minibatch import Frame, load_frozen_frame

# the intrinsics of the frozen frames, and build_ycb_synthesizer's default
YCB_K = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]])

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data")
FRAMES_DIR = os.path.join(DATA_DIR, "lov_syn_val_v4")


def object_models(num_classes: int, seed: int = 0):
    """(points (C,P,3), symmetry (C,), extents (C,3)), numpy float32: 0.1 m
    extents and P = ADD_NUM_POINTS points a class drawn uniformly inside
    the box from numpy seed `seed` (class 0, the background, has none)."""
    extents = np.full((num_classes, 3), 0.1, np.float32)
    symmetry = np.asarray(YCB_SYMMETRY[:num_classes], np.float32)
    points = np.random.RandomState(seed).uniform(-0.05, 0.05, (num_classes, ADD_NUM_POINTS, 3)).astype(np.float32)
    points[0] = 0.0
    return points, symmetry, extents


def frame_digest(f: Frame) -> str:
    """`synthetic.py:_frame_digest`: sha256 over the frame's arrays."""
    h = hashlib.sha256()
    for a in (f.color, f.label, f.depth, f.cls_indexes, f.poses, f.center, np.asarray(f.intrinsic_matrix)):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class LovSynVal:
    """The frozen frames of `frames_dir` (by default `lov_syn_val_v4`'s 256),
    under the dataset name `name`, with the 22 YCB classes, the object
    models (`_extents`, `_points_all`, `_points`, `_symmetry`, named as in
    the JAX package's datasets) and class colours (`_class_colors`) of
    `base`, or the stand-ins and `YCB_CLASS_COLORS` without one, and the
    intrinsics `K`: what `data.synthetic.build_ycb_synthesizer` reads. The
    manifest's `render_params` are the frames' render settings, which the
    bank refresh renders with (`data.bank_refresh.refresh_synthesizer`)."""

    def __init__(self, frames_dir: str = FRAMES_DIR, name: str = "lov_syn_val_v4", base=None):
        self.frames_dir = frames_dir
        self.name = name
        with open(os.path.join(frames_dir, "manifest.json")) as fh:
            self.manifest = json.load(fh)
        self.num_images = self.manifest["num_images"]
        self.classes = YCB_CLASSES
        self.num_classes = len(YCB_CLASSES)
        if base is None:
            self._points_all, self._symmetry, self._extents = object_models(self.num_classes)
            self._points = list(self._points_all)
            self._class_colors = YCB_CLASS_COLORS
        else:
            self.base = base
            self._points_all, self._points = base._points_all, base._points
            self._symmetry, self._extents = base._symmetry, base._extents
            self._class_colors = base._class_colors
        self.K = YCB_K.copy()
        self._cache = {}

    def load_frame(self, i: int) -> Frame:
        if i in self._cache:
            return self._cache[i]
        frame = replace(load_frozen_frame(os.path.join(self.frames_dir, f"{i:06d}.npz")), is_synthetic=True)
        if frame_digest(frame) != self.manifest["frames"][i]:
            raise RuntimeError(f"{self.name} frame {i}: its hash differs from the committed manifest's")
        self._cache[i] = frame
        return frame
