"""ctypes bindings of the host rasterizer (`csrc/rasterizer.cc`), the
host bilateral filter (`csrc/bilateral.cc`) and the PNG row filters
(`csrc/png.cc`).

The port's copy of `posecnn_tpu/native/__init__.py`: `SceneBuffers`,
`DEFAULT_LIGHT`, `rasterize_mesh` and `rasterize_depth`. The library is
built with g++ at first use (`_build.build_library`), and a failed build
raises: nothing falls back to NumPy. `_rasterize_numpy` is the plain
version of `rasterize_mesh`, which only the tests call. `bilateral_filter`
is cv2's `bilateralFilter` for uint8 BGR images; ctypes releases the GIL
for the call, so the data thread filters while the trainer runs.
`png_unfilter` undoes a PNG image's row filters (`utils/png.py` reads the
rest of the file).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from posecnn_torch._build import bilateral_lib, png_lib, rasterizer_lib


class SceneBuffers:
    """Mutable render targets composed across rasterize calls."""

    def __init__(self, height: int, width: int):
        self.color = np.zeros((height, width, 3), np.uint8)
        self.depth = np.zeros((height, width), np.float32)
        self.label = np.zeros((height, width), np.int32)
        self.vertmap = np.zeros((height, width, 3), np.float32)


DEFAULT_LIGHT = (0.0, 0.0, -1.0, 0.35, 0.65)  # a headlight


def rasterize_mesh(
    buffers: SceneBuffers,
    vertices: np.ndarray,
    faces: np.ndarray,
    pose: np.ndarray,
    K: np.ndarray,
    cls_id: int,
    vertex_colors: Optional[np.ndarray] = None,
    base_color: Tuple[float, float, float] = (0.7, 0.7, 0.7),
    light: Tuple[float, float, float, float, float] = DEFAULT_LIGHT,
) -> None:
    """Rasterize one object instance into the scene buffers (z-tested).

    `light` = (lx, ly, lz, ambient, diffuse): camera-frame Lambert light,
    drawn per scene by the synthesizer so shading encodes rotation.
    """
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    pose = np.ascontiguousarray(pose, np.float32).reshape(3, 4)
    K33 = np.ascontiguousarray(K, np.float32).reshape(3, 3)
    base = np.ascontiguousarray(base_color, np.float32)
    lt = np.ascontiguousarray(light, np.float32)
    h, w = buffers.depth.shape
    vc = None if vertex_colors is None else np.ascontiguousarray(vertex_colors, np.float32)
    if vc is not None and vc.shape != vertices.shape:
        raise ValueError(f"vertex_colors {vc.shape} != vertices {vertices.shape}")
    _check_mesh(vertices, faces)
    rasterizer_lib().rasterize_mesh(
        vertices, len(vertices), faces, len(faces),
        vc.ctypes.data if vc is not None else None,
        base, pose.reshape(-1), K33.reshape(-1), lt,
        h, w, int(cls_id),
        buffers.color, buffers.depth.reshape(-1), buffers.label.reshape(-1),
        buffers.vertmap.reshape(h * w * 3),
    )


def rasterize_depth(
    depth: np.ndarray,
    label: np.ndarray,
    vertices: np.ndarray,
    faces: np.ndarray,
    pose: np.ndarray,
    K: np.ndarray,
    cls_id: int,
) -> None:
    """Rasterize one object instance into a depth and a label map only."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    pose = np.ascontiguousarray(pose, np.float32).reshape(3, 4)
    K33 = np.ascontiguousarray(K, np.float32).reshape(3, 3)
    h, w = depth.shape
    if label.shape != (h, w) or depth.dtype != np.float32 or label.dtype != np.int32:
        raise ValueError("rasterize_depth: depth (H,W) float32 and label (H,W) int32")
    _check_mesh(vertices, faces)
    rasterizer_lib().rasterize_depth(
        vertices, len(vertices), faces, len(faces),
        pose.reshape(-1), K33.reshape(-1), h, w, int(cls_id),
        depth.reshape(-1), label.reshape(-1),
    )


def bilateral_filter(im: np.ndarray, d: int, sigma_color: float, sigma_space: float) -> np.ndarray:
    """`cv2.bilateralFilter(im, d, sigma_color, sigma_space)` of an (H,W,3)
    uint8 image with the default border (csrc/bilateral.cc says how)."""
    if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(f"bilateral_filter: an (H,W,3) uint8 image, got {im.shape} {im.dtype}")
    src = np.ascontiguousarray(im)
    out = np.empty_like(src)
    rc = bilateral_lib().bilateral_filter_u8c3(src, out, src.shape[0], src.shape[1], int(d), float(sigma_color),
                                               float(sigma_space))
    if rc != 0:
        raise ValueError(f"bilateral_filter: empty image {im.shape}")
    return out


def png_unfilter(data: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The (height, rowbytes) uint8 bytes of `height` filtered PNG rows in
    `data` (each a filter-type byte and `rowbytes` bytes; `bpp` the bytes
    of a pixel, at least 1). A filter-type byte outside 0-4 raises
    ValueError naming its row."""
    src = np.ascontiguousarray(data, np.uint8).reshape(-1)
    if src.size != height * (rowbytes + 1) or bpp < 1:
        raise ValueError(f"png_unfilter: {src.size} bytes for {height} rows of 1 + {rowbytes} (bpp {bpp})")
    out = np.empty((height, rowbytes), np.uint8)
    bad = png_lib().png_unfilter(src, out, int(height), int(rowbytes), int(bpp))
    if bad:
        raise ValueError(f"png_unfilter: row {bad - 1} has filter type {src[(bad - 1) * (rowbytes + 1)]}")
    return out


def _check_mesh(vertices: np.ndarray, faces: np.ndarray) -> None:
    """The shapes and indices the C++ reads without checking."""
    if vertices.ndim != 2 or vertices.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"vertices and faces must be (V,3) and (F,3), got {vertices.shape} and {faces.shape}")
    if faces.size and (faces.min() < 0 or faces.max() >= len(vertices)):
        raise ValueError(f"face indices outside [0, {len(vertices)})")


def _rasterize_numpy(buffers, vertices, faces, pose, K, cls_id, vertex_colors, base, light):
    """The plain version of `rasterize_mesh`, face by face in NumPy (the JAX
    package's fallback): some sums in float64, so it agrees with the C++ to
    rounding, not bit for bit."""
    cam = vertices @ pose[:, :3].T + pose[:, 3]
    z = np.maximum(cam[:, 2], 1e-6)
    sx = K[0, 0] * cam[:, 0] / z + K[0, 2]
    sy = K[1, 1] * cam[:, 1] / z + K[1, 2]
    h, w = buffers.depth.shape
    ldir = np.asarray(light[:3], np.float64)
    ldir = ldir / max(np.linalg.norm(ldir), 1e-12)
    ambient, diffuse = float(light[3]), float(light[4])
    for f in faces:
        p = np.stack([sx[f], sy[f]], axis=1)
        zf = cam[f, 2]
        if (zf <= 1e-6).any():
            continue
        area = (p[1, 0] - p[0, 0]) * (p[2, 1] - p[0, 1]) - (p[2, 0] - p[0, 0]) * (p[1, 1] - p[0, 1])
        if abs(area) < 1e-9:
            continue
        x0, x1 = int(max(0, np.floor(p[:, 0].min()))), int(min(w - 1, np.ceil(p[:, 0].max())))
        y0, y1 = int(max(0, np.floor(p[:, 1].min()))), int(min(h - 1, np.ceil(p[:, 1].max())))
        if x0 > x1 or y0 > y1:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1) + 0.5, np.arange(y0, y1 + 1) + 0.5)
        w0 = ((p[1, 0] - xs) * (p[2, 1] - ys) - (p[2, 0] - xs) * (p[1, 1] - ys)) / area
        w1 = ((p[2, 0] - xs) * (p[0, 1] - ys) - (p[0, 0] - xs) * (p[2, 1] - ys)) / area
        w2 = 1 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        iz = w0 / zf[0] + w1 / zf[1] + w2 / zf[2]
        zp = np.where(iz > 0, 1.0 / np.maximum(iz, 1e-12), np.inf)
        sub_d = buffers.depth[y0 : y1 + 1, x0 : x1 + 1]
        closer = inside & ((sub_d == 0) | (zp < sub_d))
        sub_d[closer] = zp[closer]
        buffers.label[y0 : y1 + 1, x0 : x1 + 1][closer] = cls_id
        a = np.stack([w0 / zf[0], w1 / zf[1], w2 / zf[2]], axis=-1) * zp[..., None]
        vm = a @ vertices[f]
        buffers.vertmap[y0 : y1 + 1, x0 : x1 + 1][closer] = vm[closer]
        n = np.cross(cam[f[1]] - cam[f[0]], cam[f[2]] - cam[f[0]])
        nl = np.linalg.norm(n)
        shade = ambient + diffuse * (abs(float(n @ ldir)) / nl if nl > 1e-12 else 1.0)
        col = (a @ (vertex_colors[f] if vertex_colors is not None else np.tile(base, (3, 1)))) * shade * 255.0
        buffers.color[y0 : y1 + 1, x0 : x1 + 1][closer] = np.clip(col[closer], 0, 255).astype(np.uint8)
