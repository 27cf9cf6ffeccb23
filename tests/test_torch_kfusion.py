"""KinectFusion of the port (`posecnn_torch/engine/kfusion.py`) against the
JAX package's (`posecnn_tpu/engine/kfusion.py`): each function on a depth
map of an analytic scene, the stateful wrapper's pose track under a known
camera motion (`tools/make_torch_goldens.py:kfusion_scene`),
`test_net_video(kfusion=True)` on two toy frames, and the
`test_kinect_fusion` tool on depth PNGs it reads.

Tolerances: the bilateral filter and the raycast within 1e-6 m (exp and
the ray normalisation round in another order); the volume, the surface and
the mesh exactly (after a tracked run, the mesh within 1e-4 m); the pose
track within 1e-5; test_net_video's labels and surfaces equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.engine import kfusion as JK
from posecnn_torch.engine import kfusion as PK
from posecnn_torch.engine.test import set_float32_precision
from tests.torch_parity import goldens

torch.set_num_threads(1)
H, W = 48, 64
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
IDENT = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)


@pytest.fixture(autouse=True)
def _f32_precision():
    set_float32_precision()


def _scene():
    depths, truth = goldens().kfusion_scene(hw=(H, W), K=K, frames=3)
    return depths, truth


def _vol_equal(jv, pv):
    for k in ("sdf", "weight", "class_prob"):
        a, b = getattr(jv, k), getattr(pv, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy()), k


def test_bilateral_filter_matches_jax_and_wraps():
    """Noise, a depth edge, holes, and the window's wrap around the image's
    edges (`jnp.roll`): a column of depth at the left edge changes the
    right edge's filtered value."""
    d = _scene()[0][0].copy()
    d += np.random.RandomState(0).randn(H, W).astype(np.float32) * 0.005
    d[10:14, 20:30] = 0.0
    ref, got = np.asarray(JK.bilateral_filter(jnp.asarray(d))), PK.bilateral_filter(torch.tensor(d)).numpy()
    assert float(np.abs(ref - got).max()) <= 1e-6 and np.array_equal(ref == d, got == d)
    e = d.copy()
    e[:, 0] += 0.01
    assert PK.bilateral_filter(torch.tensor(e)).numpy()[5, W - 1] != got[5, W - 1]


def test_fuse_raycast_surface_mesh_match_jax():
    """Three frames fused with class probabilities, from a camera that
    moves; then the raycast, the surface voxels and the mesh."""
    depths, truth = _scene()
    rng = np.random.RandomState(1)
    jv = JK.create_volume(32, (-0.8, -0.6, 0.5), 0.05, num_classes=3)
    pv = PK.create_volume(32, (-0.8, -0.6, 0.5), 0.05, num_classes=3, device="cpu")
    for d, w2c in zip(depths, truth):
        prob = rng.dirichlet(np.ones(3), (H, W)).astype(np.float32)
        jv = JK.fuse_depth(jv, jnp.asarray(d), jnp.asarray(K), jnp.asarray(w2c), label_prob=jnp.asarray(prob))
        pv = PK.fuse_depth(pv, torch.tensor(d), torch.tensor(K), torch.tensor(w2c), label_prob=torch.tensor(prob))
        _vol_equal(jv, pv)
    c2w = np.hstack([truth[-1][:, :3].T, (-truth[-1][:, :3].T @ truth[-1][:, 3])[:, None]]).astype(np.float32)
    rd, rh = JK.raycast(jv, jnp.asarray(K), jnp.asarray(c2w), H, W)
    gd, gh = PK.raycast(pv, torch.tensor(K), torch.tensor(c2w), H, W)
    assert np.array_equal(np.asarray(rh), gh.numpy()) and np.asarray(rh).mean() > 0.9
    assert float(np.abs(np.asarray(rd) - gd.numpy()).max()) <= 1e-6
    for n in (64, 4096):  # cut to the first n in flat order, and whole
        for a, b in zip(JK.extract_surface(jv, max_points=n), PK.extract_surface(pv, max_points=n)):
            assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(JK.marching_tetrahedra(jv, max_cells=512), PK.marching_tetrahedra(pv, max_cells=512)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_marching_tetrahedra_sphere_matches_jax():
    """The analytic sphere SDF of tests/test_kfusion.py: the whole mesh
    equal, its vertices on the sphere."""
    G, vs = 24, 0.06
    gi = np.stack(np.meshgrid(*[np.arange(G)] * 3, indexing="ij"), -1)
    sdf = np.clip((np.linalg.norm(-0.7 + gi * vs, axis=-1) - 0.5) / (5 * vs), -1, 1).astype(np.float32)
    sdf[0, 0, 0] = 0.0  # a value exactly on the level set: nudged outside
    jv = JK.create_volume(G, (-0.7,) * 3, vs)
    pv = PK.create_volume(G, (-0.7,) * 3, vs, device="cpu")
    jv = jv.__class__(jnp.asarray(sdf), jnp.ones((G,) * 3), jv.origin, vs, jv.truncation, None)
    pv = PK.TSDFVolume(torch.tensor(sdf), torch.ones((G,) * 3), pv.origin, vs, pv.truncation, None)
    ref, got = JK.marching_tetrahedra(jv, max_cells=4096), PK.marching_tetrahedra(pv, max_cells=4096)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    v = got[0].numpy()[got[1].numpy()]
    assert v.shape[0] > 500 and np.abs(np.linalg.norm(v.reshape(-1, 3), axis=-1) - 0.5).max() < vs


def test_kinect_fusion_track_matches_jax():
    """The wrapper over the golden's scene (4 frames, the camera moving
    (1, 0.5, 0) cm a frame): the track, the surface, the raycast and the
    back-projection of the filtered depth against JAX's; the tracked
    translation moves the right way along x and y."""
    G = goldens()
    depths, truth = G.kfusion_scene()
    a = JK.KinectFusion(grid_size=G.KF_GRID, origin=G.KF_ORIGIN, voxel_size=G.KF_VOXEL, num_classes=2)
    b = PK.KinectFusion(grid_size=G.KF_GRID, origin=G.KF_ORIGIN, voxel_size=G.KF_VOXEL, num_classes=2, device="cpu")
    prob = np.zeros(depths[0].shape + (2,), np.float32)
    prob[..., 1] = 1.0
    for j, d in enumerate(depths):
        for kf in (a, b):
            kf.feed_data(d, G.KF_K)
            kf.feed_label(prob)
            pose = kf.solve_pose() if j > 0 else None
            kf.fuse_depth()
        if pose is not None:
            np.testing.assert_allclose(b.world2cam.numpy(), np.asarray(a.world2cam), atol=1e-5)
    t = b.world2cam.numpy()[:, 3]
    assert t[0] < -0.002 and t[1] < -0.002  # the camera moved +x, +y: the world moves -x, -y
    for x, y in zip(a.extract_surface(), b.extract_surface()):
        assert np.array_equal(x, y)
    assert (b.extract_surface()[1] == 1).all()
    (ta, la), (tb, lb) = a.extract_mesh(max_cells=1024), b.extract_mesh(max_cells=1024)
    # the tracked poses part in the last bits, and so the fused sdf's, which an
    # edge's interpolation sa / (sa - sb) divides by a small difference
    assert np.array_equal(la, lb) and float(np.abs(ta - tb).max()) <= 1e-4
    for x, y in zip(a.render(*G.KF_HW), b.render(*G.KF_HW)):
        assert float(np.abs(x.astype(np.float64) - y).max()) <= 1e-5
    np.testing.assert_allclose(b.back_project(), np.asarray(a.back_project()), rtol=1e-6, atol=1e-7)


class _Rec:
    """An evaluator that keeps each frame's label map."""

    def __init__(self):
        self.labels = []

    def add_frame(self, pred, gt):
        self.labels.append(np.asarray(pred))

    def summary(self):
        return {"frames": len(self.labels)}


def test_test_net_video_with_kfusion_matches_jax():
    """test_net_video(kfusion=True) on two toy frames as one video (as
    tests/test_kfusion.py:78 runs JAX's): the labels and the surfaces
    equal; timings when asked. The two frames are toy frame 1 twice, a
    still camera: toy frames 1 and 2 are unrelated scenes, on which the
    ICP is ill-posed (the two packages' poses then part by ~1e-3 and the
    surfaces by a few voxels)."""
    import jax

    from posecnn_tpu.data.factory import get_imdb as jax_imdb
    from posecnn_tpu.engine.test import test_net_video as jax_test_net_video
    from posecnn_tpu.models.video import VideoConfig as JCfg
    from posecnn_tpu.models.video import init_video_params
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.engine import test as PT
    from posecnn_torch.models.video import VideoConfig, make_video_model

    class TwoFrames:
        num_images = 2
        image_index = ["vid/000001", "vid/000002"]

        def __init__(self, imdb):
            self.imdb = imdb

        def load_frame(self, i):
            return self.imdb.load_frame(1)

    imdb = get_imdb("toy_val")
    means = [102.98, 115.95, 122.77]
    params = jax.tree_util.tree_map(np.asarray, init_video_params(jax.random.PRNGKey(0),
                                                                  JCfg(num_classes=4, num_units=8)))
    ref = _Rec()
    jax_test_net_video(params, JCfg(num_classes=4, num_units=8, compute_dtype=jnp.float32), TwoFrames(jax_imdb("toy_val")),
                       means, evaluator=ref, kfusion=True, kfusion_grid=96, log=None)
    cfg = VideoConfig(num_classes=4, num_units=8, compute_dtype=torch.float32)
    got, timings = _Rec(), {}
    PT.test_net_video(make_video_model(cfg, params, "cpu"), cfg, TwoFrames(imdb), means, evaluator=got,
                      kfusion=True, kfusion_grid=96, log=None, timings=timings)
    assert len(got.labels) == 2 and all(np.array_equal(x, y) for x, y in zip(ref.labels, got.labels))
    assert len(got.surfaces) == 1 and got.surfaces[0][0].shape[0] > 100
    for x, y in zip(ref.surfaces[0], got.surfaces[0]):
        assert np.array_equal(x, y)
    assert len(timings["load"]) == len(timings["video_step"]) == len(timings["kfusion"]) == 2


def test_kinect_fusion_tool_on_pngs(tmp_path):
    """`python -m posecnn_torch.tools.test_kinect_fusion --images DIR
    --device cpu` on uint16 depth PNGs of the analytic scene (factor
    10000): the surface and the raycast PNG written, exit 0; --images is
    required; a directory without frames exits 1."""
    from posecnn_torch.tools import test_kinect_fusion as tool
    from posecnn_torch.utils.png import IMREAD_UNCHANGED, imread, write_png

    G = goldens()
    depths, _ = G.kfusion_scene(hw=(120, 160), K=np.array([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]]), frames=2)
    for j, d in enumerate(depths):
        write_png(str(tmp_path / f"{j:06d}-depth.png"), np.round(d * 10000).astype(np.uint16))
    out = tmp_path / "out"
    assert tool.main(["--images", str(tmp_path), "--grid", "48", "--output", str(out), "--device", "cpu"]) == 0
    pts = np.load(out / "surface.npy")
    ray = imread(str(out / "raycast.png"), IMREAD_UNCHANGED)
    assert pts.ndim == 2 and pts.shape[1] == 3 and pts.shape[0] > 0 and ray.shape == (120, 160) and ray.max() > 0
    with pytest.raises(SystemExit):
        tool.main([])
    (tmp_path / "empty").mkdir()
    assert tool.main(["--images", str(tmp_path / "empty"), "--device", "cpu"]) == 1
