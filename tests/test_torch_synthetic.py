"""The port's host renderer and synthetic scenes against the JAX package:
`native.rasterize_mesh` and `rasterize_depth` against
`posecnn_tpu.native`'s, the mesh loaders, `Synthesizer.render_scene` and
`SyntheticDataset` frame for frame, on the toy base at 96x128 and on the
`lov_syn_val_v4` stand-in models at 640x480.

Both packages compile the same C++ arithmetic with g++ on this machine, and
their NumPy draws run in the same order, so everything is held bit for bit.
The port's plain NumPy rasterizer (`native._rasterize_numpy`, some sums in
float64) is held to its C++ within a bound: labels agree on >= 0.999 of the
pixels, and where they agree depth within 1e-5 relative, object coordinates
within 1e-5 m and colour within 2 levels. A failed build raises. The
render golden (`tools/make_torch_goldens.py`) is current and rendered
bit for bit by the port here.
"""

from __future__ import annotations

import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest

import posecnn_tpu.data.synthetic as JS
import posecnn_tpu.native as JN
from posecnn_tpu.data.toy import toy as JaxToy
from posecnn_torch import _build
from posecnn_torch import native as N
from posecnn_torch.data import synthetic as S
from posecnn_torch.data.lov_syn import LovSynVal
from posecnn_torch.data.toy import toy as Toy
from tests.torch_parity import check_render_golden, goldens, load_npz, port_renders

K = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]])
FRAME_KEYS = ("color", "label", "depth", "cls_indexes", "poses", "center", "intrinsic_matrix")
# seeds of the refresh stream (REFRESH_SEED0 + i); 50_000_000 retries five
# times and falls through to dropping objects on the stand-ins
LOV_SEEDS = (50_000_000, 50_000_001, 50_000_005)


def _hull():
    pts = np.random.RandomState(0).uniform(-0.05, 0.05, (256, 3)).astype(np.float32)
    return S.Mesh.from_points(pts)


def _pose(seed: int, z=None):
    r = np.random.RandomState(seed)
    R = S._random_rotation(r)
    t = np.array([r.uniform(-0.1, 0.1), r.uniform(-0.1, 0.1), r.uniform(0.5, 2.0) if z is None else z])
    return np.hstack([R, t[:, None]])


def _same_buffers(a, b):
    for k in ("color", "depth", "label", "vertmap"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


# (objects as (pose seed, class, with vertex colours), z of the first pose)
RENDER_CASES = {
    "vertex_colors": ([(1, 3, True)], None),
    "base_color": ([(2, 5, False)], None),
    "two_objects": ([(3, 2, True), (4, 7, False)], None),
    "behind_camera": ([(5, 4, True)], 0.02),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_rasterize_mesh_bit_equal_to_jax(case):
    """Colour, depth, label and object coordinates, over one or two
    objects (composed by the z-test), with vertex colours or a base colour,
    and with faces behind the camera (skipped)."""
    objs, z0 = RENDER_CASES[case]
    mesh = _hull()
    vc = S.procedural_vertex_colors(mesh.vertices, 3, np.array([0.8, 0.2, 0.3], np.float32))
    a, b = JN.SceneBuffers(480, 640), N.SceneBuffers(480, 640)
    for j, (seed, cls, colors) in enumerate(objs):
        pose = _pose(seed, z0 if j == 0 else None)
        kw = dict(vertex_colors=vc if colors else None, base_color=(0.2, 0.6, 0.9), light=(0.3, -0.5, -0.8, 0.4, 0.6))
        JN.rasterize_mesh(a, mesh.vertices, mesh.faces, pose, K, cls, **kw)
        N.rasterize_mesh(b, mesh.vertices, mesh.faces, pose, K, cls, **kw)
    _same_buffers(a, b)
    drawn = {c for _, c, _ in objs} & set(np.unique(b.label).tolist())
    assert drawn == {c for _, c, _ in objs}
    if case == "behind_camera":  # some vertex behind the camera, some face still drawn
        cam_z = mesh.vertices @ _pose(5, 0.02)[:, :3].T[:, 2] + 0.02
        assert (cam_z <= 1e-6).any() and (b.label == 4).sum() > 0


@pytest.mark.parametrize("z", [0.7, 0.02])
def test_rasterize_depth_bit_equal_to_jax(z):
    mesh = _hull()
    bufs = []
    for mod in (JN, N):
        depth, label = np.zeros((480, 640), np.float32), np.zeros((480, 640), np.int32)
        for j, seed in enumerate((6, 7)):
            mod.rasterize_depth(depth, label, mesh.vertices, mesh.faces, _pose(seed, z if j == 0 else None), K, j + 1)
        bufs.append((depth, label))
    assert np.array_equal(bufs[0][0], bufs[1][0]) and np.array_equal(bufs[0][1], bufs[1][1])
    assert (bufs[1][1] > 0).sum() > 0


@pytest.mark.parametrize("colors", [True, False])
def test_plain_rasterizer_agrees_with_the_cpp(colors):
    """`_rasterize_numpy` (the plain version) against the C++ over 6 poses
    of a hull at 640x480, within the module docstring's bound."""
    mesh = _hull()
    vc = S.procedural_vertex_colors(mesh.vertices, 3, np.array([0.8, 0.2, 0.3], np.float32)) if colors else None
    light = np.asarray((0.3, -0.5, -0.8, 0.4, 0.6), np.float32)
    base = np.asarray((0.2, 0.6, 0.9), np.float32)
    for seed in range(6):
        pose = _pose(seed)
        a, b = N.SceneBuffers(480, 640), N.SceneBuffers(480, 640)
        N.rasterize_mesh(a, mesh.vertices, mesh.faces, pose, K, 3, vertex_colors=vc, base_color=tuple(base),
                         light=tuple(light))
        with np.errstate(invalid="ignore", divide="ignore"):
            N._rasterize_numpy(b, mesh.vertices, mesh.faces, np.asarray(pose, np.float32), np.asarray(K, np.float32),
                               3, vc, base, light)
        assert (a.label == 3).sum() > 1000
        assert (a.label == b.label).mean() >= 0.999, seed
        both = (a.label > 0) & (a.label == b.label)
        assert (np.abs(a.depth - b.depth) / a.depth.clip(1e-9))[both].max() <= 1e-5, seed
        assert np.abs(a.vertmap - b.vertmap)[both].max() <= 1e-5, seed
        assert np.abs(a.color.astype(int) - b.color.astype(int))[both].max() <= 2, seed


def test_failed_build_raises(tmp_path, monkeypatch):
    """A rasterizer that does not compile raises from the render call; no
    NumPy fallback."""
    (tmp_path / "rasterizer.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    _build.rasterizer_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            N.rasterize_mesh(N.SceneBuffers(8, 8), _hull().vertices, _hull().faces, _pose(0), K, 1)
    finally:
        _build.rasterizer_lib.cache_clear()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_rasterize_refuses_bad_faces():
    mesh = _hull()
    with pytest.raises(ValueError, match="outside"):
        N.rasterize_mesh(N.SceneBuffers(8, 8), mesh.vertices, mesh.faces + len(mesh.vertices), _pose(0), K, 1)


def _write_mesh_files(d):
    """Meshes in every format the loaders read: OBJ (quads, slashes,
    negative indices), PLY ascii and binary_le, with and without rgb."""
    rng = np.random.RandomState(1)
    v = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    rgb = rng.randint(0, 256, (6, 3))
    quads = [[0, 1, 2, 3], [2, 3, 4], [1, 4, 5, 0, 2]]
    obj = ["# a comment", "o thing"] + [f"v {a} {b} {c}" for a, b, c in v] + ["vt 0 0", "vn 0 0 1"]
    obj += ["f 1/1/1 2/1/1 3 4", "f -4 -3 -2", "f 2//1 5 6 1 3", ""]
    (d / "m.obj").write_text("\n".join(obj))
    files = {"obj": d / "m.obj"}
    for with_rgb in (True, False):
        props = ["property float x", "property float y", "property float z"]
        if with_rgb:
            props += ["property uchar red", "property uchar green", "property uchar blue"]
        head = ["ply", "format ascii 1.0", f"element vertex {len(v)}", *props, f"element face {len(quads)}",
                "property list uchar int vertex_indices", "end_header"]
        rows = [" ".join([*(f"{x:.6f}" for x in v[i]), *((str(c) for c in rgb[i]) if with_rgb else ())])
                for i in range(len(v))]
        rows += [" ".join(map(str, [len(q), *q])) for q in quads]
        files[f"ply_ascii_rgb{int(with_rgb)}"] = p = d / f"a{int(with_rgb)}.ply"
        p.write_text("\n".join(head + rows) + "\n")
    for rgb_type in ("uchar", "float", None):
        props = ["property float x", "property float y", "property float z", "property double quality"]
        if rgb_type:
            props += [f"property {rgb_type} {c}" for c in ("red", "green", "blue")]
        head = ["ply", "format binary_little_endian 1.0", f"element vertex {len(v)}", *props,
                f"element face {len(quads)}", "property list uchar uint vertex_indices", "end_header"]
        body = b""
        for i in range(len(v)):
            body += struct.pack("<3fd", *v[i], 0.5)
            if rgb_type == "uchar":
                body += struct.pack("<3B", *rgb[i])
            elif rgb_type == "float":
                body += struct.pack("<3f", *(rgb[i] / 255.0))
        for q in quads:
            body += struct.pack(f"<B{len(q)}I", len(q), *q)
        files[f"ply_binary_{rgb_type}"] = p = d / f"b_{rgb_type}.ply"
        p.write_bytes(("\n".join(head) + "\n").encode() + body)
    return files


MESH_FORMATS = ["obj", "ply_ascii_rgb0", "ply_ascii_rgb1", "ply_binary_None", "ply_binary_float", "ply_binary_uchar"]


@pytest.mark.parametrize("fmt", MESH_FORMATS)
def test_mesh_loaders_match_jax(fmt, tmp_path):
    path = str(_write_mesh_files(tmp_path)[fmt])
    a, b = JS.Mesh.load(path), S.Mesh.load(path)
    for k in ("vertices", "faces", "colors"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert len(b.faces) == 6 and (b.colors is not None) == (fmt in ("ply_ascii_rgb1", "ply_binary_float",
                                                                       "ply_binary_uchar"))
    with pytest.raises(ValueError):
        S.Mesh.load(str(tmp_path / "m.stl"))


def test_mesh_from_points_and_vertex_colors_match_jax():
    pts = LovSynVal()._points_all[7]
    a, b = JS.Mesh.from_points(pts), S.Mesh.from_points(pts)
    assert np.array_equal(a.vertices, b.vertices) and np.array_equal(a.faces, b.faces)
    base = np.array([0.5, 0.25, 1.0], np.float32)
    assert np.array_equal(JS.procedural_vertex_colors(a.vertices, 7, base),
                          S.procedural_vertex_colors(b.vertices, 7, base))


def _same_frame(fa, fb, where):
    for k in FRAME_KEYS:
        x, y = np.asarray(getattr(fa, k)), np.asarray(getattr(fb, k))
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), (where, k)
    assert fa.factor_depth == fb.factor_depth and fa.is_synthetic and fb.is_synthetic


def test_synthetic_dataset_toy_frames_bit_equal():
    """SyntheticDataset over the toy base at 96x128 (3 objects at most, the
    class colours drawn): frames 0-7 of the train split and 0-1 of val."""
    for split, n in (("train", 8), ("val", 2)):
        ja = JS.SyntheticDataset(JaxToy("train", num_classes=4, num_images=4), split=split, num_images=n,
                                 width=128, height=96, max_objects=3)
        pb = S.SyntheticDataset(Toy("train", num_classes=4, num_images=4), split=split, num_images=n,
                                width=128, height=96, max_objects=3)
        assert pb.name == ja.name and pb.image_index == ja.image_index
        for i in range(n):
            _same_frame(ja.load_frame(i), pb.load_frame(i), (split, i))
        assert pb.load_frame(0) is pb.load_frame(0)  # cached


def _lov_synthesizers():
    lv = LovSynVal()
    base = SimpleNamespace(classes=lv.classes, num_classes=lv.num_classes, _points_all=lv._points_all,
                           _extents=lv._extents, _class_colors=lv._class_colors, K=lv.K)
    params = lv.manifest["render_params"]
    return JS.build_ycb_synthesizer(base, **params), S.build_ycb_synthesizer(lv, **params)


@pytest.mark.parametrize("seed", LOV_SEEDS)
def test_render_scene_on_the_stand_ins_bit_equal(seed, monkeypatch):
    """The refresh's renderer of lov_syn_val_v4 (640x480, 5 objects, the
    800-pixel gate) over the stand-in hulls, and JAX's over the same arrays;
    seed 50_000_000 reaches the fall-through."""
    js, ps = _lov_synthesizers()
    renders = []
    orig = S.Synthesizer._render_objects
    monkeypatch.setattr(S.Synthesizer, "_render_objects",
                        lambda self, *a: renders.append(len(a[0])) or orig(self, *a))
    fa = js.render_scene(np.random.RandomState(seed))
    fb = ps.render_scene(np.random.RandomState(seed))
    _same_frame(fa, fb, seed)
    assert fb.color.shape == (480, 640, 3) and fb.depth.dtype == np.uint16
    if seed == LOV_SEEDS[0]:
        assert len(renders) == 6 and len(fb.cls_indexes) < 5  # five tries, then the kept objects
    for c in fb.cls_indexes:
        assert (fb.label == c).sum() > 0


def test_synthesizer_options_match_jax():
    """A pose bank (banked rotations +/- noise) and no class colours (base
    colours drawn), and min_objects above max_objects."""
    jb, pb = JaxToy("train", num_classes=5, num_images=1), Toy("train", num_classes=5, num_images=1)
    bank = np.random.RandomState(3).randn(10, 4)
    js = JS.build_ycb_synthesizer(jb, 128, 96, pose_bank=bank, min_objects=6, max_objects=2, min_visible=50)
    ps = S.build_ycb_synthesizer(pb, 128, 96, pose_bank=bank, min_objects=6, max_objects=2, min_visible=50)
    assert ps.min_objects == 2 and ps.class_colors is None
    for seed in range(4):
        _same_frame(js.render_scene(np.random.RandomState(seed)), ps.render_scene(np.random.RandomState(seed)), seed)


def test_render_golden_is_current_and_the_port_renders_it():
    """The committed render golden equals JAX's renders now, and the port's
    renders of its scenes equal it bit for bit here (on the card's machine
    `chip_smoke.py` holds them to `check_render_golden`'s bound)."""
    G = goldens()
    ref = load_npz(G.RENDER_GOLDEN)
    g, got = G.render_golden(), port_renders()
    assert sorted(g) == sorted(ref) == sorted(got)
    for k in ref:
        assert g[k].dtype == ref[k].dtype and np.array_equal(g[k], ref[k]), k
        assert np.array_equal(got[k], ref[k]), k
    assert all(v == (1.0, 0.0, 0) for v in check_render_golden(got, ref).values())
    assert len(ref["lov/cls_indexes"]) < 5 and os.path.getsize(G.RENDER_GOLDEN) < 500_000
