"""Synthetic scenes rendered on the host: meshes, the scene sampler, and a
dataset of rendered frames.

The port's copy of `posecnn_tpu/data/synthetic.py`, draw for draw, so the
same seed renders the same frame in both packages:
  * `Synthesizer.render_scene` samples 5-8 distinct objects (fewer where the
    dataset has fewer) with random poses (translation z in [t_near, t_far],
    the centre inside the middle half of the image, rotation uniform over
    SO(3), or a banked pose +/- noise when a pose bank is given), a random
    Lambert light and per-object base colours, in that order of draws: the
    light, then pose and colour per object;
  * renders colour, depth and label with the host rasterizer
    (`posecnn_torch.native`, C++);
  * retries a frame where any object has fewer than `min_visible` visible
    pixels, and after `max_tries` drops the under-visible objects and
    renders the kept ones again;
  * meshes: .obj/.ply models under `<_lov_path>/models/<class>/` when
    present, else convex hulls of the class's points (scipy), with a
    procedural surface pattern (`procedural_vertex_colors`).

`SyntheticDataset` renders frame i from seed `seed0 + i`.
`OfflineSynReader` reads the frames of a `data_syn` directory (TRAIN.SYNROOT,
TRAIN.SYN_ONLINE False) as `data.lov` reads YCB-Video's.
`freeze_dataset` writes every frame of a synthetic dataset to disk with a
manifest of their digests, byte for byte the JAX package's manifest
(`data.lov_syn.LovSynVal` reads such a directory back).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from posecnn_torch.data.minibatch import Frame
from posecnn_torch.native import SceneBuffers, rasterize_mesh
from posecnn_torch.utils.quaternion_np import quat2mat


def _random_rotation(rng: np.random.RandomState) -> np.ndarray:
    q = rng.randn(4)
    return quat2mat(q / np.linalg.norm(q))


def procedural_vertex_colors(
    vertices: np.ndarray, cls_id: int, base_color: np.ndarray
) -> np.ndarray:
    """Deterministic position-based surface pattern for untextured meshes.

    The reference trains on textured YCB meshes (synthesize.cpp:148-178);
    where only `points.xyz` clouds are at hand, hull proxy meshes would
    otherwise render one flat color per object. A flat-colored convex
    object is nearly rotation-invariant in image space — the quaternion head
    then has almost no supervisory signal. This stamps a smooth multi-band
    pattern onto the surface (sin products along 3 random object-frame
    directions + per-vertex jitter), deterministic in `cls_id` so train and
    val render identically across processes.
    """
    rng = np.random.RandomState(777 + int(cls_id))
    v = vertices - vertices.mean(axis=0, keepdims=True)
    scale = max(float(np.abs(v).max()), 1e-6)
    v = v / scale  # roughly [-1, 1]
    base = np.asarray(base_color, np.float32).reshape(1, 3)
    # secondary color: complementary-ish, away from base
    second = np.clip(1.0 - base + 0.3 * rng.rand(1, 3).astype(np.float32), 0.05, 1.0)
    freqs = rng.uniform(2.0, 5.0, size=(3,)).astype(np.float32)
    dirs = rng.randn(3, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    phase = rng.uniform(0, 2 * np.pi, size=(3,)).astype(np.float32)
    t = 0.5 + 0.5 * np.sin(freqs[0] * (v @ dirs[0]) + phase[0]) * np.sin(
        freqs[1] * (v @ dirs[1]) + phase[1]
    )
    t2 = 0.5 + 0.5 * np.sin(freqs[2] * (v @ dirs[2]) + phase[2])
    mix = np.clip(0.25 + 0.5 * t + 0.25 * t2, 0.0, 1.0)[:, None].astype(np.float32)
    jitter = 0.06 * rng.randn(len(vertices), 3).astype(np.float32)
    return np.clip(mix * base + (1.0 - mix) * second + jitter, 0.02, 1.0)


class Mesh:
    def __init__(self, vertices: np.ndarray, faces: np.ndarray, colors: Optional[np.ndarray] = None):
        self.vertices = vertices.astype(np.float32)
        self.faces = faces.astype(np.int32)
        self.colors = colors

    @classmethod
    def from_points(cls, points: np.ndarray) -> "Mesh":
        """Convex-hull proxy mesh from a point cloud."""
        from scipy.spatial import ConvexHull

        hull = ConvexHull(points)
        return cls(points.astype(np.float32), hull.simplices.astype(np.int32))

    @classmethod
    def from_obj(cls, path: str) -> "Mesh":
        """Minimal Wavefront OBJ loader: v/f records, fan-triangulated
        polygons, 1-based (or negative) indices; vt/vn/materials ignored
        (the rasterizer shades per class color)."""
        verts: List[List[float]] = []
        faces: List[List[int]] = []
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "v" and len(parts) >= 4:
                    verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
                elif parts[0] == "f" and len(parts) >= 4:
                    idx = []
                    for tok in parts[1:]:
                        i = int(tok.split("/")[0])
                        idx.append(i - 1 if i > 0 else len(verts) + i)
                    for k in range(1, len(idx) - 1):  # fan triangulation
                        faces.append([idx[0], idx[k], idx[k + 1]])
        return cls(np.asarray(verts, np.float32), np.asarray(faces, np.int32))

    # PLY scalar type -> numpy dtype (little-endian where sized)
    _PLY_DTYPES = {
        "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
        "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
        "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
        "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    }

    @classmethod
    def from_ply(cls, path: str) -> "Mesh":
        """PLY loader: xyz vertices, polygon faces, and per-vertex
        red/green/blue colors when present (the YCB `textured.ply` models
        carry them — the reference renders textured meshes,
        lib/synthesize/synthesize.cpp:148-178 loadTexturedMesh). Supports
        `format ascii` and `format binary_little_endian`."""
        with open(path, "rb") as fh:
            header = []
            while True:
                line = fh.readline().decode("ascii", "ignore").strip()
                header.append(line)
                if line == "end_header":
                    break
            is_ascii = any(h.startswith("format ascii") for h in header)
            is_binary = any(h.startswith("format binary_little_endian") for h in header)
            if not (is_ascii or is_binary):
                raise ValueError(f"{path}: unsupported PLY format (ascii/binary_le only)")
            n_vert = n_face = 0
            vert_props: List[Tuple[str, str]] = []  # (name, type)
            face_list_types: Tuple[str, str] = ("uchar", "int")
            cur = None
            for h in header:
                t = h.split()
                if not t:
                    continue
                if t[0] == "element":
                    cur = t[1]
                    if cur == "vertex":
                        n_vert = int(t[2])
                    elif cur == "face":
                        n_face = int(t[2])
                elif t[0] == "property" and cur == "vertex" and len(t) >= 3:
                    if t[1] == "list":
                        raise ValueError(f"{path}: list property on vertex unsupported")
                    vert_props.append((t[-1], t[1]))
                elif t[0] == "property" and cur == "face" and len(t) >= 5 and t[1] == "list":
                    face_list_types = (t[2], t[3])

            names = [n for n, _ in vert_props]
            ix = [names.index(a) for a in ("x", "y", "z")]
            has_rgb = all(c in names for c in ("red", "green", "blue"))
            ic = [names.index(a) for a in ("red", "green", "blue")] if has_rgb else None

            if is_ascii:
                rows = np.empty((n_vert, len(vert_props)), np.float64)
                for i in range(n_vert):
                    rows[i] = [float(v) for v in fh.readline().split()[: len(vert_props)]]
                faces: List[List[int]] = []
                for _ in range(n_face):
                    vals = fh.readline().split()
                    k = int(vals[0])
                    idx = [int(v) for v in vals[1 : 1 + k]]
                    for j in range(1, k - 1):
                        faces.append([idx[0], idx[j], idx[j + 1]])
                faces_arr = np.asarray(faces, np.int32).reshape(-1, 3)
                color_scale = 255.0  # ascii rgb conventionally uchar-valued
            else:
                vdt = np.dtype([(f"p{i}", cls._PLY_DTYPES[t]) for i, (_, t) in enumerate(vert_props)])
                raw = np.frombuffer(fh.read(n_vert * vdt.itemsize), dtype=vdt, count=n_vert)
                rows = np.stack([raw[f"p{i}"].astype(np.float64) for i in range(len(vert_props))], axis=1)
                cnt_dt = np.dtype(cls._PLY_DTYPES[face_list_types[0]])
                idx_dt = np.dtype(cls._PLY_DTYPES[face_list_types[1]])
                faces = []
                for _ in range(n_face):
                    k = int(np.frombuffer(fh.read(cnt_dt.itemsize), cnt_dt)[0])
                    idx = np.frombuffer(fh.read(k * idx_dt.itemsize), idx_dt).astype(np.int64)
                    for j in range(1, k - 1):
                        faces.append([idx[0], idx[j], idx[j + 1]])
                faces_arr = np.asarray(faces, np.int32).reshape(-1, 3)
                # uchar-typed rgb is 0..255; float-typed is already 0..1
                color_scale = 255.0 if (has_rgb and vert_props[ic[0]][1] in ("uchar", "uint8")) else 1.0

            verts = rows[:, ix].astype(np.float32)
            colors = None
            if has_rgb:
                colors = (rows[:, ic] / color_scale).astype(np.float32)
        return cls(verts, faces_arr, colors=colors)

    @classmethod
    def load(cls, path: str) -> "Mesh":
        ext = os.path.splitext(path)[1].lower()
        if ext == ".obj":
            return cls.from_obj(path)
        if ext == ".ply":
            return cls.from_ply(path)
        raise ValueError(f"unsupported mesh format: {path}")


class Synthesizer:
    """Scene sampler + renderer. API shape mirrors libsynthesizer.Synthesizer
    (lib/synthesize/synthesizer.pyx:14-95) minus the GL context."""

    def __init__(
        self,
        meshes: Sequence[Optional[Mesh]],   # index = class id; None for background
        extents: np.ndarray,
        intrinsic_matrix: np.ndarray,
        width: int = 640,
        height: int = 480,
        class_colors: Optional[Sequence[Tuple[int, int, int]]] = None,
        t_near: float = 0.5,
        t_far: float = 2.0,
        min_objects: int = 5,
        max_objects: int = 8,
        min_visible: int = 800,
        pose_bank: Optional[np.ndarray] = None,  # (N,4) quaternion bank
        pose_noise_deg: float = 15.0,
    ):
        self.meshes = list(meshes)
        self.extents = extents
        self.K = np.asarray(intrinsic_matrix, np.float64)
        self.width, self.height = width, height
        self.class_colors = class_colors
        self.t_near, self.t_far = t_near, t_far
        # clamp: a caller lowering max_objects below the default min (e.g.
        # SyntheticDataset(max_objects=3)) must narrow the range, not crash
        # randint(low >= high) in render_scene
        self.min_objects, self.max_objects = min(min_objects, max_objects), max_objects
        self.min_visible = min_visible
        self.pose_bank = pose_bank
        self.pose_noise_deg = pose_noise_deg
        self.num_classes = len(self.meshes)

    def _sample_pose(self, rng) -> Tuple[np.ndarray, np.ndarray]:
        if self.pose_bank is not None and len(self.pose_bank):
            q = self.pose_bank[rng.randint(len(self.pose_bank))]
            R = quat2mat(q / np.linalg.norm(q))
            # perturb around the banked pose
            ang = np.deg2rad(self.pose_noise_deg) * rng.randn(3)
            Rn, _ = np.linalg.qr(np.eye(3) + np.cross(np.eye(3), ang))
            R = Rn @ R
        else:
            R = _random_rotation(rng)
        z = self.t_near + (self.t_far - self.t_near) * rng.rand()
        cx = self.width * (0.25 + 0.5 * rng.rand())
        cy = self.height * (0.25 + 0.5 * rng.rand())
        t = np.array(
            [
                (cx - self.K[0, 2]) / self.K[0, 0] * z,
                (cy - self.K[1, 2]) / self.K[1, 1] * z,
                z,
            ]
        )
        return R, t

    def _sample_light(self, rng) -> Tuple[float, float, float, float, float]:
        """Random camera-frame Lambert light per scene: direction anywhere on
        the sphere (|n.l| shading is sign-agnostic), ambient/diffuse jittered
        around the old fixed headlight split so mean brightness is stable."""
        d = rng.randn(3)
        d /= max(np.linalg.norm(d), 1e-9)
        ambient = 0.3 + 0.2 * rng.rand()
        diffuse = 1.0 - ambient + 0.1 * (rng.rand() - 0.5)
        return (float(d[0]), float(d[1]), float(d[2]), float(ambient), float(diffuse))

    def _base_color(self, cls, rng):
        if self.class_colors:
            return np.asarray(self.class_colors[cls], np.float32) / 255.0
        return np.array([0.3 + 0.7 * rng.rand() for _ in range(3)], np.float32)

    def _render_objects(self, classes, poses64, bases, light):
        """Rasterize the given objects into fresh scene buffers.

        `poses64` holds the float64 (3,4) poses exactly as sampled (the
        rasterizer must see full precision) and `bases` the per-object base
        colors, both pre-drawn by the caller so the rng consumption order —
        pose then color per object — matches the frozen frames' and a
        fall-through re-render reuses the first pass's colors.
        """
        buf = SceneBuffers(self.height, self.width)
        for j, cls in enumerate(classes):
            mesh = self.meshes[cls]
            rasterize_mesh(
                buf, mesh.vertices, mesh.faces,
                poses64[j], self.K, int(cls),
                vertex_colors=mesh.colors, base_color=tuple(bases[j]),
                light=light,
            )
        return buf

    def _frame_from(self, buf, classes, poses, centers) -> Frame:
        return Frame(
            color=buf.color[:, :, ::-1].copy(),  # RGB->BGR
            label=buf.label.copy(),
            depth=(buf.depth * 1000.0).astype(np.uint16),
            cls_indexes=np.asarray(classes, np.float32),
            poses=poses,
            center=centers,
            intrinsic_matrix=self.K,
            factor_depth=1000.0,
            is_synthetic=True,
        )

    def render_scene(self, rng: np.random.RandomState, max_tries: int = 5) -> Frame:
        classes_avail = [c for c in range(1, self.num_classes) if self.meshes[c] is not None]
        for _ in range(max_tries):
            n = rng.randint(self.min_objects, self.max_objects + 1)
            n = min(n, len(classes_avail))
            classes = rng.choice(classes_avail, size=n, replace=False)
            poses = np.zeros((3, 4, n), np.float32)
            poses64, bases = [], []
            centers = np.zeros((n, 2), np.float32)
            light = self._sample_light(rng)
            for j in range(n):
                R, t = self._sample_pose(rng)
                poses[:, :3, j] = R
                poses[:, 3, j] = t
                poses64.append(np.hstack([R, t[:, None]]))
                bases.append(self._base_color(int(classes[j]), rng))
                centers[j] = [
                    self.K[0, 0] * t[0] / t[2] + self.K[0, 2],
                    self.K[1, 1] * t[1] / t[2] + self.K[1, 2],
                ]
            buf = self._render_objects(classes, poses64, bases, light)
            visible = np.array([(buf.label == c).sum() for c in classes])
            if (visible >= self.min_visible).all():
                return self._frame_from(buf, classes, poses, centers)
        # fall through after max_tries: the reference resamples until every
        # object passes the visibility gate (synthesize.cpp:448-452); with a
        # bounded retry budget the equivalent guarantee is to drop the
        # under-visible objects and re-render the scene from only the kept
        # set, so color, label and GT rows stay mutually consistent — a
        # dropped object's appearance must not remain in the image with its
        # pixels labeled background (that would train the segmentation head
        # to call visible object pixels background)
        keep = visible >= self.min_visible
        classes, poses, centers = classes[keep], poses[:, :, keep], centers[keep]
        poses64 = [p for p, k in zip(poses64, keep) if k]
        bases = [b for b, k in zip(bases, keep) if k]
        buf = self._render_objects(classes, poses64, bases, light)
        return self._frame_from(buf, classes, poses, centers)


def build_ycb_synthesizer(dataset, width=640, height=480, **kwargs) -> Synthesizer:
    """Synthesizer over a YCB-style dataset: real .obj/.ply meshes from
    models/<class>/ when present (the reference loads textured models,
    synthesize.cpp loadModels), else convex hulls of the points.xyz clouds."""
    meshes: List[Optional[Mesh]] = [None]
    model_root = os.path.join(getattr(dataset, "_lov_path", ""), "models")
    for c in range(1, dataset.num_classes):
        mesh = None
        cls_name = dataset.classes[c]
        for fname in ("textured.obj", "textured.ply", "mesh.obj", f"{cls_name}.obj", f"{cls_name}.ply"):
            p = os.path.join(model_root, cls_name, fname)
            if os.path.exists(p):
                try:
                    mesh = Mesh.load(p)
                    break
                except (ValueError, OSError):
                    mesh = None
        if mesh is None:
            pts = dataset._points_all[c]
            mesh = Mesh.from_points(pts) if pts.shape[0] >= 4 else None
        meshes.append(mesh)
    K = getattr(dataset, "K", np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]]))
    colors = getattr(dataset, "_class_colors", None)
    # untextured meshes (the points.xyz hull proxies here) get a procedural
    # surface pattern: flat-shaded objects carry almost no rotation signal
    for c in range(1, dataset.num_classes):
        mesh = meshes[c]
        if mesh is not None and mesh.colors is None:
            base = (
                np.asarray(colors[c], np.float32) / 255.0
                if colors is not None
                else np.array([0.6, 0.6, 0.6], np.float32)
            )
            mesh.colors = procedural_vertex_colors(mesh.vertices, c, base)
    return Synthesizer(meshes, dataset._extents, K, width, height, class_colors=colors, **kwargs)


class SyntheticDataset:
    """On-the-fly synthetic dataset over a real metadata-bearing imdb.

    The reference's SYN_ONLINE path renders synthetic training frames live
    from the YCB models (tools/train_net.py:155-258 render thread); here the
    dataset itself is synthetic: frame i is rendered deterministically from
    seed `seed0 + i` using the base imdb's model point clouds, extents and
    intrinsics — usable anywhere a real imdb is (training and evaluation).
    """

    def __init__(self, base, split: str = "train", num_images: int = 2000,
                 width: int = 640, height: int = 480, max_objects: int = 5,
                 cache: bool = True):
        self.base = base
        self.name = f"{base.name}_syn_{split}" if hasattr(base, "name") else f"syn_{split}"
        self.num_images = num_images
        self._seed0 = {"train": 0, "val": 10_000_000, "keyframe": 10_000_000}.get(split, 20_000_000)
        self.image_index = [f"syn/{i:06d}" for i in range(num_images)]
        self.synth = build_ycb_synthesizer(base, width, height, max_objects=max_objects)
        # frames are deterministic in i, so they render once and replay from
        # RAM on later epochs (~2 MB/frame; augmentation stays per-iteration
        # random in the minibatch builder)
        self._cache: dict = {} if cache else None
        # metadata proxies
        self.classes = base.classes
        self.num_classes = base.num_classes
        self._extents = base._extents
        self._points = base._points
        self._points_all = base._points_all
        self._symmetry = base._symmetry

    def load_frame(self, i: int) -> Frame:
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        rng = np.random.RandomState(self._seed0 + i)
        frame = self.synth.render_scene(rng)
        if self._cache is not None:
            self._cache[i] = frame
        return frame


class OfflineSynReader:
    """The frames of a `data_syn` directory: {root}/NNNNNN-{color,depth,
    label}.png and -meta.mat, `num` of them
    (`posecnn_tpu/data/synthetic.py:OfflineSynReader`, the reference's
    SYN_ONLINE False path), read through `data.lov.read_frame` and marked
    synthetic."""

    def __init__(self, root: str, num: int = 80000):
        self.root = root
        self.num = num

    def load_frame(self, index: int) -> Frame:
        from posecnn_torch.data.lov import read_frame

        base = os.path.join(self.root, f"{index:06d}")
        return read_frame(base + "-color.png", base + "-label.png", base + "-depth.png", base + "-meta.mat",
                          is_synthetic=True)


def freeze_dataset(imdb, out_dir: str) -> dict:
    """Write every frame of a synthetic imdb to `out_dir` as <i:06d>.npz
    (compressed: colour, label, depth, classes, poses, centres, intrinsics,
    depth factor) and `manifest.json`: the name, the frame count, the
    renderer's settings (`render_params`, where the imdb has a synthesizer)
    and each frame's digest (`lov_syn.frame_digest`, JAX's `_frame_digest`),
    in the JAX package's layout and bytes (`synthetic.py:freeze_dataset`).
    Returns the manifest."""
    import json

    from posecnn_torch.data.lov_syn import frame_digest

    os.makedirs(out_dir, exist_ok=True)
    manifest = {"name": imdb.name, "num_images": imdb.num_images, "frames": []}
    synth = getattr(imdb, "synth", None)
    if synth is not None:
        manifest["render_params"] = {
            "width": synth.width, "height": synth.height,
            "min_objects": synth.min_objects, "max_objects": synth.max_objects,
            "min_visible": synth.min_visible,
            "t_near": synth.t_near, "t_far": synth.t_far,
        }
    for i in range(imdb.num_images):
        f = imdb.load_frame(i)
        np.savez_compressed(
            os.path.join(out_dir, f"{i:06d}.npz"),
            color=f.color, label=f.label, depth=f.depth,
            cls_indexes=f.cls_indexes, poses=f.poses, center=f.center,
            intrinsic_matrix=np.asarray(f.intrinsic_matrix),
            factor_depth=np.float64(f.factor_depth),
        )
        manifest["frames"].append(frame_digest(f))
    with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
    return manifest
