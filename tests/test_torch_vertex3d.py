"""3D vertex regression (VERTEX_REG_3D) of the port against the JAX package.

Held exactly: `scale_vertmap`/`unscale_vertmap`, the 3D vertex targets
(single and multi-instance with a mask), `get_minibatch`'s 3D batch on
frozen frames given a seeded vertmap (flipped entries, chroma and noise
draws included; the rng left in the same state), and `decode_poses_3d`'s
rois with JAX's hypothesis indices replayed. Within limits: the 3D loss
and its gradient (1e-6 of the largest magnitude), `kabsch` (1e-5),
`ransac_pose` with replayed indices on a well-posed scene (the ICP's
limits, 2e-4 m and 5e-3 in the quaternion), the 3D head's forward (1e-5 of
the largest magnitude, float32, the trunk at 1/8 width) and one 3D
training step's losses (1e-5 relative) and vertex head gradient (2e-5).

A frame without a vertmap: JAX's get_minibatch raises TypeError, the
port ValueError naming `Frame.vertmap` (and, from the data layer, the
dataset). train_net --cfg lov_color_3d.yml stops there on
lov_syn_val_v4; test_net --cfg lov_color_3d.yml runs on the CPU at narrow
widths.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.data import minibatch as JM
from posecnn_tpu.engine import ransac as JRS
from posecnn_tpu.engine import test as JT
from posecnn_tpu.engine.refine import sample_object_cloud as jax_cloud
from posecnn_tpu.models.posecnn import PoseCNNConfig as JaxCfg
from posecnn_tpu.models.posecnn import posecnn_forward as jax_forward
from posecnn_tpu.ops.vertex_targets import smooth_l1_loss_vertex_sparse3d as jax_loss3d
from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import init_params_numpy, make_model, params_from_numpy
from posecnn_torch.data import minibatch as M
from posecnn_torch.data.factory import get_imdb
from posecnn_torch.data.layer import GtSynthesizeLayer
from posecnn_torch.engine import ransac as RS
from posecnn_torch.engine import test as PT
from posecnn_torch.engine import train as T
from posecnn_torch.models.posecnn import posecnn_forward
from posecnn_torch.ops.vertex_targets import smooth_l1_loss_vertex_sparse3d
from posecnn_torch.utils.quaternion_np import quat2mat
from tests.torch_parity import ransac_scene, rendered_3d_frames

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG_3D = os.path.join(ROOT, "experiments", "cfgs", "lov_color_3d.yml")

torch.set_num_threads(2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _frames(n=2, mask=False, vertmap=True, rendered=False):
    """Frozen frames (port Frame, JAX Frame) with a seeded vertmap (and an
    instance mask of the label's pixels), or rendered scenes with the
    rasterizer's vertmap."""
    ds = get_imdb("lov_syn_val_v4")
    rng = np.random.RandomState(5)
    port, jax_ = [], []
    scenes = rendered_3d_frames(n) if rendered else None
    for i in range(n):
        f = scenes[i] if rendered else ds.load_frame(i)
        vm = f.vertmap if rendered else (rng.rand(*f.label.shape, 3).astype(np.float32) - 0.5) * 0.2
        vm = vm if vertmap else None
        mk = None
        if mask:
            mk = np.zeros(f.label.shape, np.int32)
            for j, c in enumerate(f.cls_indexes):
                mk[f.label == c] = j + 1
        port.append(dataclasses.replace(f, vertmap=vm, mask=mk))
        jax_.append(JM.Frame(color=f.color, label=f.label, cls_indexes=f.cls_indexes, poses=f.poses, center=f.center,
                             intrinsic_matrix=f.intrinsic_matrix, depth=f.depth, factor_depth=f.factor_depth,
                             mask=mk, vertmap=vm))
    return ds, port, jax_


def test_scale_and_unscale_vertmap_match_jax():
    rng = np.random.RandomState(0)
    vm = rng.randn(20, 30, 3).astype(np.float32) * 0.1
    idx = np.nonzero(rng.rand(20, 30) > 0.4)
    extents = np.array([[0, 0, 0], [0.12, 0.08, 0.0], [0.2, 0.1, 0.05]], np.float32)
    for c in (1, 2):
        s = M.scale_vertmap(vm, idx, extents[c])
        np.testing.assert_array_equal(s, JM.scale_vertmap(vm, idx, extents[c]))
        np.testing.assert_array_equal(M.unscale_vertmap(s, c, extents), JM.unscale_vertmap(s, c, extents))


@pytest.mark.parametrize("multi", [False, True])
def test_vertex_targets_3d_match_jax(multi):
    """The 3D branches of generate_vertex_targets, by class or (two
    instances of one class with a mask) by instance."""
    rng = np.random.RandomState(1)
    label = np.zeros((24, 32), np.int32)
    label[2:10, 3:12] = 2
    label[12:20, 14:30] = 2 if multi else 3
    label[15:22, 0:6] = 1
    mask = np.zeros_like(label)
    mask[2:10, 3:12], mask[12:20, 14:30], mask[15:22, 0:6] = 1, 2, 3
    cls = np.array([2, 2 if multi else 3, 1])
    vm = rng.randn(24, 32, 3).astype(np.float32) * 0.05
    ext = np.abs(rng.randn(4, 3)).astype(np.float32) * 0.1
    ref = JM.generate_vertex_targets(label, cls, np.zeros((3, 2)), np.zeros((3, 4, 3)), 4, 10.0,
                                     mask=mask if multi else None, vertmap=vm, extents=ext, vertex_reg_3d=True)
    got = M.vertex_targets_3d(label, cls, 4, 10.0, vm, ext, mask if multi else None)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("mask,rendered", [(False, False), (True, False), (False, True)])
def test_get_minibatch_3d_matches_jax(mask, rendered):
    """Bit-equal batches (vertex_targets3, vertex_weights3 and the rest) on
    frames given a seeded vertmap or rendered with the rasterizer's, one
    flipped, with chroma and noise draws."""
    ds, port, jax_ = _frames(3, mask=mask, rendered=rendered)
    port[1] = dataclasses.replace(port[1], flipped=True)
    jax_[1].flipped = True
    kw = dict(num_classes=22, chromatic=True, add_noise=True, vertex_reg=True, vertex_reg_3d=True,
              device_targets=True, max_gt=8)
    r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
    got = M.get_minibatch(port, M.MinibatchConfig(**kw), r1, extents=ds._extents)
    ref = JM.get_minibatch(jax_, JM.MinibatchConfig(**kw), ds._extents, ds._points_all, ds._symmetry, rng=r2)
    assert set(got) == set(ref) and "vertex_targets3" in got and "gt_centers" not in got
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["vertex_weights3"].max() == 10.0 and np.abs(got["vertex_targets3"]).max() > 0
    assert r1.rand() == r2.rand()


def test_frame_without_vertmap_raises():
    """JAX stops at scale_vertmap(None, ...) with TypeError; the port says
    what is missing, and from the data layer which dataset lacks it."""
    ds, port, jax_ = _frames(1, vertmap=False)
    kw = dict(num_classes=22, vertex_reg=True, vertex_reg_3d=True, device_targets=True)
    with pytest.raises(TypeError):
        JM.get_minibatch(jax_, JM.MinibatchConfig(**kw), ds._extents, ds._points_all, ds._symmetry,
                         rng=np.random.RandomState(0))
    with pytest.raises(ValueError, match="Frame.vertmap"):
        M.get_minibatch(port, M.MinibatchConfig(**kw), np.random.RandomState(0), extents=ds._extents)
    layer = GtSynthesizeLayer(ds, M.MinibatchConfig(**kw), ims_per_batch=2)
    with pytest.raises(ValueError, match="Frame.vertmap.*lov_syn_val_v4"):
        layer.forward()


def test_vertex_loss_3d_matches_jax():
    rng = np.random.RandomState(2)
    B, H, W, Cn = 2, 12, 16, 5
    pred = rng.randn(B, H, W, 3 * Cn).astype(np.float32)
    label = rng.randint(-1, Cn, (B, H, W)).astype(np.int32)
    t3 = rng.rand(B, H, W, 3).astype(np.float32)
    w3 = (rng.rand(B, H, W) > 0.3).astype(np.float32) * 10
    ref_l, ref_g = jax.value_and_grad(
        lambda p: jax_loss3d(p, jnp.asarray(label), jnp.asarray(t3), jnp.asarray(w3), Cn))(jnp.asarray(pred))
    p = _t(pred).requires_grad_(True)
    loss = smooth_l1_loss_vertex_sparse3d(p, _t(label), _t(t3), _t(w3), Cn)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_l)) <= 1e-6 * abs(float(ref_l))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g), rtol=0, atol=1e-6 * np.abs(ref_g).max())


def _rotation(rng):
    q = rng.randn(4)
    return quat2mat(q / np.linalg.norm(q))


def test_kabsch_matches_jax():
    """Weighted and unweighted, batched as one call; a zero covariance keeps
    a proper rotation (the det-sign clamp)."""
    rng = np.random.RandomState(3)
    srcs, dsts, ws = [], [], []
    for _ in range(4):
        src = rng.randn(40, 3).astype(np.float32) * 0.05
        dst = (src @ _rotation(rng).T + rng.randn(3) * 0.1 + rng.randn(40, 3) * 1e-3).astype(np.float32)
        srcs.append(src), dsts.append(dst), ws.append((rng.rand(40) > 0.3).astype(np.float32))
    R, t = RS.kabsch(_t(np.stack(srcs)), _t(np.stack(dsts)), _t(np.stack(ws)))
    R0, t0 = RS.kabsch(_t(srcs[0]), _t(dsts[0]))
    for i in range(4):
        Rj, tj = JRS.kabsch(jnp.asarray(srcs[i]), jnp.asarray(dsts[i]), jnp.asarray(ws[i]))
        np.testing.assert_allclose(R[i].numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(t[i].numpy(), np.asarray(tj), rtol=0, atol=1e-5)
    Rj, tj = JRS.kabsch(jnp.asarray(srcs[0]), jnp.asarray(dsts[0]))
    np.testing.assert_allclose(R0.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
    Rz, _ = RS.kabsch(torch.zeros(5, 3), torch.zeros(5, 3))
    np.testing.assert_allclose(Rz.numpy(), np.asarray(JRS.kabsch(jnp.zeros((5, 3)), jnp.zeros((5, 3)))[0]), atol=1e-6)
    assert abs(float(torch.linalg.det(Rz)) - 1) < 1e-5


def _correspondences(seed=4, n=512, outliers=0.3):
    """A well-posed scene: object coordinates in a box, their camera
    points under a known pose with 1 mm noise, a share replaced by outliers,
    the last 40 slots invalid."""
    rng = np.random.RandomState(seed)
    R_gt, t_gt = _rotation(rng), np.array([0.05, -0.03, 0.9])
    oc = (rng.rand(n, 3) - 0.5) * np.array([0.12, 0.08, 0.06])
    cam = oc @ R_gt.T + t_gt + rng.randn(n, 3) * 1e-3
    bad = rng.rand(n) < outliers
    cam[bad] += rng.randn(int(bad.sum()), 3) * 0.05
    valid = np.arange(n) < n - 40
    return oc.astype(np.float32), cam.astype(np.float32), valid, R_gt, t_gt


def _quat_gap(q1, q2) -> float:
    return float(1 - abs(np.dot(q1, q2)))


def test_ransac_pose_matches_jax_with_replayed_indices():
    """JAX's triplets (jax.random.choice with the valid points'
    probabilities) through the port's ransac_pose: the same inlier count,
    the pose within 2e-4 m and 5e-3 in the quaternion, both near the truth."""
    oc, cam, valid, R_gt, t_gt = _correspondences()
    key = jax.random.PRNGKey(9)
    qj, tj, nj = JRS.ransac_pose(key, jnp.asarray(oc), jnp.asarray(cam), jnp.asarray(valid))
    p = valid / valid.sum()
    idx = np.asarray(jax.random.choice(key, oc.shape[0], shape=(256, 3), p=jnp.asarray(p, jnp.float32)))
    draws = T.Draws(replay={"ransac": _t(idx[None])})
    hyp = RS.hypothesis_index(draws, _t(valid[None]))
    q, t, n = RS.ransac_pose(_t(oc[None]), _t(cam[None]), _t(valid[None]), hyp)
    assert int(n[0]) == int(nj) and int(nj) > 300
    assert np.abs(t[0].numpy() - np.asarray(tj)).max() <= 2e-4
    assert _quat_gap(q[0].numpy(), np.asarray(qj)) <= 5e-3
    assert np.abs(t[0].numpy() - t_gt).max() < 3e-3


def test_hypothesis_index_draws_valid_points():
    """The port's own draws (jax.random.choice's formula): only valid
    points, and a recorded draw replays."""
    valid = torch.zeros(2, 100, dtype=torch.bool)
    valid[0, :30] = True
    valid[1, 50:] = True
    rec = T.Draws(torch.Generator().manual_seed(0), record=True)
    idx = RS.hypothesis_index(rec, valid, 64)
    assert idx.shape == (2, 64, 3) and bool(valid[0][idx[0]].all()) and bool(valid[1][idx[1]].all())
    assert torch.equal(RS.hypothesis_index(T.Draws(replay=rec.recorded), valid, 64), idx)


C3 = 4


def _jax_decode_indices(label, depth, extents, meta, seed, classes):
    """The triplet indices of JAX's decode_poses_3d: PRNGKey(seed) split
    once per decoded class, each sub-key's jax.random.choice over the
    class's sampled points."""
    key = jax.random.PRNGKey(seed)
    out = []
    for c in classes:
        key, sub = jax.random.split(key)
        _, valid, _ = jax_cloud(jnp.asarray(depth), jnp.asarray(label), jnp.asarray(c), float(meta[0]),
                                float(meta[4]), float(meta[2]), float(meta[5]), 512, return_index=True)
        p = valid.astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        out.append(np.asarray(jax.random.choice(sub, 512, shape=(256, 3), p=p)))
    return np.stack(out)


def test_decode_poses_3d_matches_jax():
    """Rois exact (classes, boxes and inlier counts; class 2 under the
    500-pixel threshold skipped), poses within the ICP's limits and near
    the truth's ADD, with JAX's indices replayed."""
    label, depth, vp, extents, meta = ransac_scene()
    ref_rois, ref_poses = JT.decode_poses_3d({"label_2d": label[None], "vertex_pred": vp[None]}, depth, meta,
                                             extents, C3, label_threshold=500, seed=3)
    idx = _jax_decode_indices(label, depth, extents, meta, 3, [1, 3])
    rois, poses = PT.decode_poses_3d({"label_2d": label[None], "vertex_pred": _t(vp[None])}, depth, meta, extents,
                                     C3, label_threshold=500, draws=T.Draws(replay={"ransac": _t(idx)}))
    assert rois.shape == (2, 7) and list(rois[:, 1]) == [1, 3]
    np.testing.assert_array_equal(rois, ref_rois)
    np.testing.assert_allclose(poses[:, 4:], ref_poses[:, 4:], rtol=0, atol=2e-4)
    for a, b in zip(poses[:, :4], ref_poses[:, :4]):
        assert _quat_gap(a, b) <= 5e-3
    # nothing over the threshold: no rows
    r0, p0 = PT.decode_poses_3d({"label_2d": np.zeros_like(label)[None], "vertex_pred": _t(vp[None])}, depth,
                                meta, extents, C3)
    assert r0.shape == (0, 7) and p0.shape == (0, 7)


def _cfg3d(train: bool):
    return dict(num_classes=5, num_units=8, vertex_reg=True, vertex_reg_3d=True, pose_reg=False, is_train=train,
                keep_prob=1.0, trunk_scale=0.125, fc_dim=64)


def test_posecnn_3d_forward_matches_jax():
    """The 3D head ends at vertex_pred (no Hough, no pose head), as JAX's."""
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **_cfg3d(False))
    params = init_params_numpy(2, cfg)
    rng = np.random.RandomState(0)
    data = (rng.rand(1, 64, 96, 3) * 200 - 100).astype(np.float32)
    meta = np.zeros((1, 48), np.float32)
    meta[0, 0] = meta[0, 4] = 60.0
    model = make_model(cfg, params, "cpu")
    with torch.no_grad():
        out = posecnn_forward(model, cfg, _t(data), torch.ones(5, 3), _t(meta))
    ref = jax_forward(jax.tree_util.tree_map(jnp.asarray, params), JaxCfg(compute_dtype=jnp.float32, **_cfg3d(False)),
                      jnp.asarray(data), jnp.ones((5, 3)), jnp.asarray(meta))
    assert set(out) == set(ref) and "rois" not in out and "poses_tanh" not in out
    for k in ("score", "vertex_pred", "prob_normalized"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=k)
    np.testing.assert_array_equal(out["label_2d"].numpy(), np.asarray(ref["label_2d"]))


def test_3d_train_step_matches_jax():
    """One step of compute_losses on a 3D batch (frozen frames at 1/8 with
    a seeded vertmap): loss_regu, loss_cls, loss_vertex and the total within
    1e-5 relative; the vertex head's gradient within 2e-5 of its largest
    magnitude (the small training step's limit)."""
    from tools.make_torch_goldens import jax_train_steps, train_frames

    frames = train_frames()
    rng = np.random.RandomState(6)
    frames = [dataclasses.replace(f, vertmap=(rng.rand(*f.label.shape, 3).astype(np.float32) - 0.5) * 0.2)
              for f in frames]
    extents = np.full((22, 3), 0.1, np.float32)
    mcfg = M.MinibatchConfig(num_classes=22, chromatic=False, vertex_reg=True, vertex_reg_3d=True,
                             device_targets=True, max_gt=8)
    batch = M.get_minibatch(frames, mcfg, np.random.RandomState(0), extents=extents)
    cfg_kw = dict(_cfg3d(True), num_classes=22)
    hp_kw = dict(learning_rate=0.001, weight_reg=0.0001)
    params = init_params_numpy(3, PoseCNNConfig(**cfg_kw))
    points, symmetry = np.zeros((22, 8, 3), np.float32), np.zeros(22, np.float32)
    r_losses, r_grads, *_ = jax_train_steps(cfg_kw, hp_kw, params, batch, points, symmetry, extents)
    cfg, hp = PoseCNNConfig(compute_dtype=torch.float32, **cfg_kw), T.TrainHParams(**hp_kw)
    model = make_model(cfg, params, "cpu")
    loss, losses = T.compute_losses(model, cfg, hp, {k: _t(v) for k, v in batch.items()}, _t(points), _t(symmetry),
                                    _t(extents))
    loss.backward()
    assert set(losses) == set(r_losses) == {"loss", "loss_cls", "loss_regu", "loss_vertex"}
    for k, v in r_losses.items():
        assert abs(float(losses[k]) - v) <= 1e-5 * abs(v), (k, float(losses[k]), v)
    ref = params_from_numpy({k: v for k, v in r_grads.items() if not k.startswith("upscore")})
    for k in ("vertex_pred.weight", "score_conv4_vertex.weight"):
        g = dict(model.named_parameters())[k].grad
        assert float((g - ref[k]).abs().max()) <= 2e-5 * float(ref[k].abs().max()), k


def _narrow(monkeypatch):
    for name in ("train_model_cfg", "test_model_cfg"):
        orig = getattr(C, name)
        monkeypatch.setattr(C, name, lambda cfg, n, _f=orig: dataclasses.replace(
            _f(cfg, n), trunk_scale=0.125, fc_dim=64, compute_dtype=torch.float32))


def test_3d_cli_on_cpu(tmp_path, monkeypatch):
    """test_net --cfg lov_color_3d.yml on 2 frozen frames (narrow): the
    evaluator's summary, detections in the 7-column layout and ransac
    timings; train_net --cfg lov_color_3d.yml on lov_syn_val_v4 stops at
    the first batch: its frames carry no vertmap."""
    from posecnn_torch import test_net, train_net

    _narrow(monkeypatch)
    ev = tmp_path / "eval"
    assert test_net.main(["--cfg", CFG_3D, "--imdb", "lov_syn_val_v4", "--max_frames", "2", "--device", "cpu",
                          "--output", str(ev)]) == 0
    summary = json.loads((ev / "eval_summary.json").read_text())
    assert "seg_iou" in summary
    timing = json.loads((ev / "eval_timing.json").read_text())
    assert timing["frames"] == 2 and "ransac" in timing["ms"] and "nms" not in timing["ms"]
    with np.load(ev / "detections.npz") as d:
        assert all(d[k].shape[1] == 7 for k in d.files)
    with pytest.raises(ValueError, match="Frame.vertmap"):
        train_net.main(["--cfg", CFG_3D, "--imdb", "lov_syn_val_v4", "--iters", "1", "--device", "cpu",
                        "--output", str(tmp_path / "train")])
