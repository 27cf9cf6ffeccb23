"""The LINEMOD dataset: one object against the background, with its pose.

The port's copy of `posecnn_tpu/data/linemod.py` (lib/datasets/linemod.py):
each instance is one of the 15 LINEMOD objects as a 2-class problem, with
the symmetry flag of eggbox, the objects' diameters (the ADD threshold is
0.1 x the diameter, linemod.py:411-413), and the frame's label remapped to
the object (1) and the background (0).

The root is `$POSECNN_DATA/LINEMOD`, else the repository's `data/LINEMOD`:

  data/<frame>-color.png, -depth.png, -label.png, -meta.mat
  indexes/<cls>_<image_set>.txt, or <cls>/<image_set>.txt
  models/<cls>.xyz, else models/<cls>.ply (ASCII or binary little-endian)
  extents.txt (one row a class, in LINEMOD_CLASSES order; optional)

Frames are read as `data.lov.read_frame` reads them (`utils.png.imread`,
`scipy.io.loadmat`).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from posecnn_torch.data.imdb import imdb
from posecnn_torch.data.lov import data_root, read_meta

LINEMOD_CLASSES = (
    "__background__", "ape", "benchvise", "bowl", "camera", "can",
    "cat", "cup", "driller", "duck", "eggbox",
    "glue", "holepuncher", "iron", "lamp", "phone",
)

LINEMOD_SYMMETRY_ALL = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0], dtype=np.float32)

# the objects' diameters in metres (linemod.py:58-61)
LINEMOD_DIAMETERS = (
    np.array(
        [
            102.09865663, 247.50624233, 167.35486092, 172.49224865, 201.40358597,
            154.54551808, 124.26430816, 261.47178102, 108.99920102, 164.62758848,
            175.88933422, 145.54287471, 278.07811733, 282.60129399, 212.35825148,
        ]
    )
    / 1000.0
)


class linemod(imdb):
    LINEMOD_CLASSES = LINEMOD_CLASSES

    def __init__(self, cls: str, image_set: str, linemod_path: Optional[str] = None):
        super().__init__(f"linemod_{cls}_{image_set}")
        self._cls = cls
        self._image_set = image_set
        self._linemod_path = linemod_path or self._get_default_path()
        self._data_path = os.path.join(self._linemod_path, "data")
        self._classes = ("__background__", cls)
        self._cls_index = LINEMOD_CLASSES.index(cls)
        self._symmetry = np.array([0, LINEMOD_SYMMETRY_ALL[self._cls_index]], dtype=np.float32)
        self._diameter = LINEMOD_DIAMETERS[self._cls_index - 1]
        self._extents = self._load_object_extents()
        self._points, self._points_all = self._load_object_points()
        self._image_ext = ".png"
        self._image_index = self._load_image_set_index()

    def _get_default_path(self) -> str:
        return os.path.join(data_root(), "LINEMOD")

    def _load_image_set_index(self) -> List[str]:
        f = os.path.join(self._linemod_path, "indexes", f"{self._cls}_{self._image_set}.txt")
        if not os.path.exists(f):
            f = os.path.join(self._linemod_path, self._cls, f"{self._image_set}.txt")
        if not os.path.exists(f):
            return []
        with open(f) as fh:
            return [x.strip() for x in fh]

    def _load_object_extents(self) -> np.ndarray:
        extent_file = os.path.join(self._linemod_path, "extents.txt")
        extents = np.zeros((2, 3), dtype=np.float32)
        if os.path.exists(extent_file):
            all_extents = np.loadtxt(extent_file)
            extents[1, :] = all_extents[self._cls_index - 1]
        return extents

    def _load_object_points(self):
        points = [np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)]
        xyz = os.path.join(self._linemod_path, "models", self._cls + ".xyz")
        ply = os.path.join(self._linemod_path, "models", self._cls + ".ply")
        if os.path.exists(xyz):
            points[1] = np.loadtxt(xyz).astype(np.float32)
        elif os.path.exists(ply):
            points[1] = read_ply_vertices(ply)
        n = max(points[1].shape[0], 1)
        points_all = np.zeros((2, n, 3), dtype=np.float32)
        if points[1].shape[0]:
            points_all[1] = points[1]
        return points, points_all

    def add_threshold(self) -> float:
        """The ADD threshold: 0.1 x the object's diameter (linemod.py:411)."""
        return 0.1 * self._diameter

    @property
    def diameters(self) -> np.ndarray:
        """Diameters by class index, for the evaluator's 0.1 x diameter
        thresholds (linemod.py:411-413)."""
        return np.array([0.0, self._diameter], dtype=np.float64)

    def image_path_at(self, i):
        return os.path.join(self._data_path, self._image_index[i] + "-color" + self._image_ext)

    def gt_roidb(self):
        return [
            {
                "image": self.image_path_at(i),
                "depth": self.image_path_at(i).replace("-color", "-depth"),
                "label": self.image_path_at(i).replace("-color", "-label"),
                "meta_data": self.image_path_at(i).replace("-color" + self._image_ext, "-meta.mat"),
                "flipped": False,
                "cls_index": self._cls_index,
            }
            for i in range(self.num_images)
        ]

    def load_frame(self, i: int):
        """Frame i with the label remapped to the object (1) and the
        background (0), and only the object's poses and centres
        (minibatch.py:357-369)."""
        from posecnn_torch.data.minibatch import Frame
        from posecnn_torch.utils.png import IMREAD_COLOR, IMREAD_UNCHANGED, imread

        entry = self.roidb[i]
        meta = read_meta(entry["meta_data"])
        label = imread(entry["label"], IMREAD_UNCHANGED)
        sel = np.where(meta["cls_indexes"] == self._cls_index)[0]
        return Frame(
            color=imread(entry["image"], IMREAD_COLOR),
            label=(label == self._cls_index).astype(np.int32),
            depth=imread(entry["depth"], IMREAD_UNCHANGED),
            cls_indexes=np.ones(len(sel), dtype=np.float32),
            poses=meta["poses"][:, :, sel],
            center=meta["center"][sel, :],
            intrinsic_matrix=meta["intrinsic_matrix"],
            factor_depth=meta["factor_depth"],
        )


def read_ply_vertices(path: str) -> np.ndarray:
    """The (N,3) float32 vertex coordinates of a PLY file, ASCII or binary
    little-endian (`posecnn_tpu/data/linemod.py:_read_ply_vertices`)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header line")
            line = line.decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n = 0
        fmt = "ascii"
        props = []
        in_vertex = False
        for line in header:
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element"):
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                props.append(line.split()[1])
        if fmt == "ascii":
            pts = []
            for _ in range(n):
                vals = f.readline().split()
                pts.append([float(vals[0]), float(vals[1]), float(vals[2])])
            return np.asarray(pts, dtype=np.float32)
        sizes = {"float": 4, "float32": 4, "double": 8, "uchar": 1, "uint8": 1, "int": 4, "uint": 4}
        row = sum(sizes.get(p, 4) for p in props)
        raw = f.read(n * row)
        arr = np.frombuffer(raw, dtype=np.uint8).reshape(n, row)
        xyz = arr[:, :12].copy().view("<f4").reshape(n, 3)
        return xyz.astype(np.float32)
