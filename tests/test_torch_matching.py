"""The port's matching loss (`posecnn_torch/ops/matching_loss.py`, TRAIN.MATCHING)
against the JAX package's (`posecnn_tpu/ops/matching_loss.py`): every case of
tests/test_matching_loss.py through the port, each value beside JAX's on the
same numpy inputs; the loss inside `compute_losses` (its terms and every
gradient) against JAX's; the matching golden; and train_net --cfg with
TRAIN.MATCHING on the host path and on the device bank at narrow widths.

JAX's gradient of the loss is NaN on the Hough rows without a class (their
quaternion is zero, and the norm's gradient there is 0/0; ROADMAP Queue 3
item 57). The port's is 0 there. The reference for gradients is JAX's
function with that one gradient taken as 0
(`make_torch_goldens._quat2mat_zero_safe`: the same values, and the same
gradient wherever JAX's is finite); one test holds the port to JAX's own
gradient on the rows where it is finite and shows the NaN on the others.

Tolerances: values within 1e-6 relative (of 1e-6 at least); gradients of
the loss alone within 1e-5 of their largest magnitude; in the step, loss
terms and the gradient norm within 1e-5 relative and each gradient within
2e-5 of its largest magnitude (f32 sums in other orders, as
tests/test_torch_train.py).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.ops.matching_loss as J
from posecnn_torch.core import config as C
from posecnn_torch.engine import train as T
from posecnn_torch.ops import matching_loss as M
from tests.torch_parity import check_matching_golden, goldens, load_npz, matching_on_golden, t

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTR = (320.0, 320.0, 160.0, 120.0)
VALUE_RTOL, GRAD_TOL = 1e-6, 1e-5
NARROW = dict(trunk_scale=0.125, fc_dim=64)


def _cube_points(n=96, seed=0):
    return np.random.RandomState(seed).uniform(-0.04, 0.04, (n, 3)).astype(np.float32)


def _quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    q = np.zeros(4, np.float32)
    q[0] = np.cos(angle / 2)
    q[1:] = np.sin(angle / 2) * axis
    return q


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= VALUE_RTOL, (what, err)


def test_soft_render_occupancy_and_depth():
    pts = _cube_points()
    q, tr = _quat([0, 0, 1], 0.0), np.asarray([0.0, 0.0, 0.6], np.float32)
    gx, gy = np.linspace(120.0, 200.0, 32, dtype=np.float32), np.linspace(80.0, 160.0, 32, dtype=np.float32)
    occ, dep = M.soft_render(t(pts), t(q), t(tr), INTR, t(gx), t(gy))
    jocc, jdep = J.soft_render(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(tr), INTR, jnp.asarray(gx),
                               jnp.asarray(gy))
    _close(occ, jocc, "occupancy")
    _close(dep, jdep, "depth")
    occ, dep = occ.numpy(), dep.numpy()
    assert occ.shape == (32, 32) and dep.shape == (32, 32)
    assert 0.0 <= occ.min() and occ.max() < 1.0
    assert occ[16, 16] > 0.5 and occ[0, 0] < 0.05
    assert abs(dep[16, 16] - 0.6) < 0.06


def test_render_compare_zero_at_gt_and_positive_off_pose():
    pts = _cube_points()
    q, tr = _quat([0, 1, 0], 0.3), np.asarray([0.02, -0.01, 0.7], np.float32)
    roi = np.asarray([130.0, 90.0, 190.0, 150.0], np.float32)
    q_off = _quat([0, 1, 0], 0.9)
    same = float(M.render_compare_loss(t(q), t(tr), t(q), t(tr), t(pts), INTR, t(roi)))
    off = float(M.render_compare_loss(t(q_off), t(tr), t(q), t(tr), t(pts), INTR, t(roi)))
    j = [float(J.render_compare_loss(jnp.asarray(a), jnp.asarray(tr), jnp.asarray(q), jnp.asarray(tr),
                                     jnp.asarray(pts), INTR, jnp.asarray(roi))) for a in (q, q_off)]
    assert same < 1e-6 and abs(same - j[0]) <= 1e-7
    assert off > same + 1e-4
    _close(off, j[1], "off pose")


def test_render_compare_gradient_points_toward_gt():
    """A gradient step on the predicted quaternion reduces the loss; the
    gradient is JAX's."""
    pts = _cube_points()
    qg, tr = _quat([1, 0, 0], 0.0), np.asarray([0.0, 0.0, 0.6], np.float32)
    roi = np.asarray([120.0, 80.0, 200.0, 160.0], np.float32)
    qp = _quat([1, 0, 0], 0.5)

    def fn(q):
        return M.render_compare_loss(q, t(tr), t(qg), t(tr), t(pts), INTR, t(roi))

    q = t(qp).requires_grad_()
    l0 = fn(q)
    (g,) = torch.autograd.grad(l0, q)
    jl, jg = jax.value_and_grad(lambda a: J.render_compare_loss(a, jnp.asarray(tr), jnp.asarray(qg),
                                                                 jnp.asarray(tr), jnp.asarray(pts), INTR,
                                                                 jnp.asarray(roi)))(jnp.asarray(qp))
    _close(float(l0.detach()), float(jl), "loss")
    assert float(np.abs(g.numpy() - np.asarray(jg)).max()) <= GRAD_TOL * float(np.abs(np.asarray(jg)).max())
    assert float(g.norm()) > 0
    assert float(fn(q.detach() - 0.5 * g)) < float(l0)


def _batched_inputs(zero_inactive=False):
    C_, P, N = 4, 64, 6
    rng = np.random.RandomState(1)
    points = rng.uniform(-0.03, 0.03, (C_, P, 3)).astype(np.float32)
    meta = np.zeros(48, np.float32)
    meta[0] = meta[4] = 320.0
    meta[2], meta[5] = 160.0, 120.0
    poses_pred = rng.randn(N, 4 * C_).astype(np.float32)
    w = np.zeros((N, 4 * C_), np.float32)
    w[0, 4:8] = 1.0  # row 0 active for class 1, row 2 for class 2
    w[2, 8:12] = 1.0
    if zero_inactive:  # as the network's poses_pred: l2_normalize(tanh(fc8) * weight)
        poses_pred = poses_pred * w
    poses_target = poses_pred + 0.1
    poses_init = np.zeros((N, 7), np.float32)
    poses_init[:, 0] = 1.0
    poses_init[:, 4:6] = rng.randn(N, 2).astype(np.float32) * 0.02
    poses_init[:, 6] = 0.8
    rois = np.zeros((N, 7), np.float32)
    rois[:, 2:6] = [120, 80, 200, 160]
    return poses_pred, poses_target, w, poses_init, rois, points, meta, C_


def test_render_compare_batched_masks_inactive_rows():
    pp, pt, w, pi, rois, points, meta, C_ = _batched_inputs()
    args = (pt, w, pi, rois, points, meta)
    loss = float(M.render_compare_batched(t(pp), *map(t, args), C_))
    ref = float(J.render_compare_batched(jnp.asarray(pp), *map(jnp.asarray, args), C_))
    assert np.isfinite(loss) and loss > 0
    _close(loss, ref, "batched")
    zero = np.zeros_like(w)
    assert float(M.render_compare_batched(t(pp), t(pt), t(zero), *map(t, args[2:]), C_)) == 0.0
    assert float(J.render_compare_batched(jnp.asarray(pp), jnp.asarray(pt), jnp.asarray(zero),
                                          *map(jnp.asarray, args[2:]), C_)) == 0.0


def test_jax_gradient_nan_on_rows_without_a_class():
    """The network's poses_pred is zero on a row without a class; JAX's
    gradient at the slot that row reads (class 0's) is NaN (the quaternion
    norm's 0/0), the port's 0; on the rows with a class they agree."""
    pp, pt, w, pi, rois, points, meta, C_ = _batched_inputs(zero_inactive=True)
    args = (pt, w, pi, rois, points, meta)
    x = t(pp).requires_grad_()
    M.render_compare_batched(x, *map(t, args), C_).backward()
    jg = np.asarray(jax.grad(lambda a: J.render_compare_batched(a, *map(jnp.asarray, args), C_))(jnp.asarray(pp)))
    has = w.reshape(len(w), C_, 4)[:, :, 0].any(axis=1)
    assert np.isnan(jg[~has][:, :4]).all() and (jg[~has][:, 4:] == 0).all() and np.isfinite(jg[has]).all()
    g = x.grad.numpy()
    assert np.isfinite(g).all() and (g[~has] == 0).all()
    assert np.abs(g[has] - jg[has]).max() <= GRAD_TOL * np.abs(jg[has]).max()


def test_chamfer_matching_loss_still_zero_at_gt():
    pts = _cube_points()
    q, tr = _quat([0, 0, 1], 0.2), np.asarray([0.0, 0.0, 0.5], np.float32)
    assert float(M.matching_loss(t(q), t(tr), t(q), t(tr), t(pts), INTR)) < 1e-5
    q_off = _quat([0, 0, 1], 0.5)
    got = float(M.matching_loss(t(q_off), t(tr), t(q), t(tr), t(pts), INTR))
    ref = float(J.matching_loss(jnp.asarray(q_off), jnp.asarray(tr), jnp.asarray(q), jnp.asarray(tr),
                                jnp.asarray(pts), INTR))
    assert got > 1.0
    _close(got, ref, "chamfer")
    pp, pt, w, pi, rois, points, meta, C_ = _batched_inputs()
    args = (pt, w, pi, points, meta)
    _close(float(M.matching_loss_batched(t(pp), *map(t, args), C_)),
           float(J.matching_loss_batched(jnp.asarray(pp), *map(jnp.asarray, args), C_)), "chamfer batched")


def test_silhouette_iou_matches_jax():
    """The hard render comparison on the host rasterizer: a box under two
    poses 0.2 rad apart, and under one pose twice (IoU 1)."""
    from posecnn_torch.data.synthetic import Mesh
    from posecnn_torch.utils.quaternion_np import quat2mat

    mesh = Mesh.from_points(_cube_points(200).astype(np.float64))
    K = np.array([[320.0, 0, 80], [0, 320.0, 60], [0, 0, 1]])
    poses = []
    for angle in (0.0, 0.2):
        pose = np.zeros((3, 4))
        pose[:, :3] = quat2mat(_quat([0, 1, 1], angle).astype(np.float64))
        pose[:, 3] = [0.0, 0.0, 0.5]
        poses.append(pose)
    got = M.silhouette_iou(mesh.vertices, mesh.faces, poses[0], poses[1], K, 120, 160)
    ref = J.silhouette_iou(mesh.vertices, mesh.faces, poses[0], poses[1], K, 120, 160)
    assert got == ref and 0.3 < got < 1.0
    assert M.silhouette_iou(mesh.vertices, mesh.faces, poses[0], poses[0], K, 120, 160) == 1.0


def test_matching_flag_train_step():
    """One train step with matching_w > 0 (tests/test_matching_loss.py's
    small config, random batch): loss_matching is finite beside the other
    terms, and every gradient is finite."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import init_params_numpy, make_model

    C_, H, W = 4, 32, 32
    cfg = PoseCNNConfig(num_classes=C_, num_units=8, trunk_scale=0.25, vertex_reg=True, pose_reg=True,
                        is_train=True, keep_prob=1.0, compute_dtype=torch.float32, hough_class_slots=2,
                        hough_max_samples=32, hough_center_stride=4, hough_refine_window=8, label_threshold=5,
                        fc_dim=64, hough_sampler="approx", use_crop_pool=True)
    hp = T.TrainHParams(stepsize=100, matching_w=1.0)
    rng = np.random.RandomState(0)
    points = t(rng.randn(C_, 16, 3).astype(np.float32) * 0.03)
    symmetry = torch.zeros(C_)
    extents = t(0.08 + 0.05 * rng.rand(C_, 3).astype(np.float32))
    state = T.create_train_state(make_model(cfg, init_params_numpy(0, cfg), "cpu"), hp)
    step = T.make_train_step(cfg, hp, points, symmetry, extents)
    meta = np.zeros((1, 48), np.float32)
    meta[:, 0] = meta[:, 4] = 60.0
    meta[:, 2], meta[:, 5] = W / 2.0, H / 2.0
    batch = {
        "data": rng.randn(1, H, W, 3).astype(np.float32),
        "gt_label_2d": rng.randint(0, C_, size=(1, H, W)).astype(np.int32),
        "vertex_targets": rng.randn(1, H, W, 3 * C_).astype(np.float32) * 0.1,
        "vertex_weights": (rng.rand(1, H, W, 3 * C_) > 0.7).astype(np.float32),
        "meta_data": meta,
        "poses": np.zeros((8, 13), np.float32),
    }
    metrics = step(state, T.to_device(batch, "cpu"), T.Draws(torch.Generator().manual_seed(1)))
    assert "loss_matching" in metrics
    assert np.isfinite(float(metrics["loss_matching"])) and np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))


def test_add_loss_trains_rotation_with_rescaled_points():
    """tests/test_matching_loss.py's learning-dynamics check through the
    port's ADD loss: momentum SGD at the reference lr on a quaternion
    reduces its rotation error with the rescaled points and margin 1e-4,
    and does not with the raw metre-scale points and margin 0.01."""
    from posecnn_torch.data.minibatch import rescale_points
    from posecnn_torch.ops.add_loss import average_distance_loss
    from posecnn_torch.utils.pose_error import re as rot_err
    from posecnn_torch.utils.quaternion_np import quat2mat

    rng = np.random.RandomState(0)
    C_, P = 4, 128
    raw = rng.uniform(-0.05, 0.05, (C_, P, 3)).astype(np.float32)
    extents = np.abs(raw).max(1) * 2
    sym = np.zeros(C_, np.float32)
    qgt = np.array([np.cos(0.6), np.sin(0.6), 0, 0], np.float32)
    tgt, w = np.zeros((8, 4 * C_), np.float32), np.zeros((8, 4 * C_), np.float32)
    tgt[:, 4:8], w[:, 4:8] = qgt, 1.0

    def final_err(points, margin, steps=800):
        pred0 = np.zeros((8, 4 * C_), np.float32)
        pred0[:, 4:8] = [1, 0, 0, 0]
        pred = t(np.arctanh(np.clip(pred0, -0.999, 0.999))).requires_grad_()
        trace = torch.zeros_like(pred)
        for _ in range(steps):
            (g,) = torch.autograd.grad(average_distance_loss(torch.tanh(pred), t(tgt), t(w), t(points), t(sym),
                                                             margin), pred)
            with torch.no_grad():
                trace = 0.9 * trace + g
                pred -= 0.001 * trace
        q = np.tanh(pred.detach().numpy()[0, 4:8])
        q = q / np.linalg.norm(q)
        return rot_err(quat2mat(q.astype(np.float64)), quat2mat(qgt.astype(np.float64)))

    assert final_err(rescale_points(raw, extents, sym), 1e-4) < 35.0
    assert final_err(raw, 0.01) > 60.0


def test_matching_golden_is_current():
    """The committed matching golden equals JAX run again now."""
    G = goldens()
    g, ref = G.matching_golden(), load_npz(G.MATCHING_GOLDEN)
    assert sorted(g) == sorted(ref)
    for k in g:
        if np.asarray(g[k]).dtype.kind == "f":
            np.testing.assert_allclose(g[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            assert np.array_equal(np.asarray(g[k]), ref[k]), k
    assert ref["loss/loss_matching"] > 0 and os.path.getsize(G.MATCHING_GOLDEN) < 200 << 10


def test_matching_step_matches_golden():
    """The shared check of chip_smoke.py phase 20 (a), on the CPU."""
    err = check_matching_golden(*matching_on_golden("cpu"))
    assert err["loss_matching"] <= 1e-5


@pytest.mark.parametrize("hp_over", [dict(matching_w=1.0), dict(matching_w=2.0, pose_w=0.0, quat_w=0.0)],
                         ids=["with_add_and_quat", "matching_alone"])
def test_compute_losses_with_matching_matches_jax(hp_over):
    """compute_losses with TRAIN.MATCHING at the training golden's config
    and batch, on the raw clouds: every term, the gradient's global norm
    and every parameter's gradient against JAX's
    (`make_torch_goldens.jax_matching_losses`)."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import init_params_numpy, make_model, params_from_numpy

    G = goldens()
    hp_kw = {**G.TRAIN_HP, **hp_over}
    params = init_params_numpy(G.TRAIN_SEED, PoseCNNConfig(**G.TRAIN_CFG))
    batch, points, symmetry, extents = G.train_inputs()
    raw = G.raw_points()
    r_losses, r_grads, r_norm = G.jax_matching_losses(G.TRAIN_CFG, hp_kw, params, batch, points, symmetry, extents,
                                                     raw)
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **G.TRAIN_CFG)
    hp = T.TrainHParams(**hp_kw)
    state = T.create_train_state(make_model(cfg, params, "cpu"), hp)
    loss, losses = T.compute_losses(state.model, cfg, hp, {k: t(v) for k, v in batch.items()}, t(points),
                                    t(symmetry), t(extents), points_raw=t(raw))
    loss.backward()
    assert set(losses) == set(r_losses) and r_losses["loss_matching"] > 0
    for k, v in r_losses.items():
        assert abs(float(losses[k]) - v) <= 1e-5 * max(abs(v), 1e-3), (k, float(losses[k]), v)
    g_norm = float(state.optimizer.global_norm([p.grad for p in state.optimizer.params]))
    assert abs(g_norm - r_norm) <= 1e-5 * r_norm
    ref = params_from_numpy({k: v for k, v in r_grads.items() if not k.startswith("upscore")})
    for k, p in state.model.named_parameters():
        assert float((p.grad - ref[k]).abs().max()) <= 2e-5 * float(ref[k].abs().max()), k


def _matching_cfg(tmp_path, base: str, over: dict) -> str:
    """`base` (experiments/cfgs) with TRAIN.MATCHING and the replacements
    `over` (old line -> new line)."""
    with open(os.path.join(ROOT, "experiments", "cfgs", base)) as f:
        text = f.read()
    for old, new in over.items():
        assert old in text, old
        text = text.replace(old, new)
    text = text.replace("TRAIN:\n", "TRAIN:\n  MATCHING: True\n", 1)
    p = tmp_path / base
    p.write_text(text)
    return str(p)


def _record_matching(monkeypatch):
    """The clouds each matching loss of the run was given."""
    seen = []
    orig = T.render_compare_batched

    def record(*a, **k):
        seen.append(a[5].detach().clone())
        return orig(*a, **k)

    monkeypatch.setattr(T, "render_compare_batched", record)
    return seen


def _narrow(monkeypatch):
    orig = C.train_model_cfg
    monkeypatch.setattr(C, "train_model_cfg", lambda cfg, n: dataclasses.replace(orig(cfg, n), **NARROW))


def test_train_net_matching_host_path(tmp_path, monkeypatch):
    """train_net --cfg toy_pose.yml + TRAIN.MATCHING --iters 2 --device cpu
    (host batches, narrow): the config is no longer refused, each step's
    matching loss renders the dataset's raw clouds (not the rescaled ADD
    points), and loss_matching is in the metrics, finite."""
    from posecnn_torch import train_net
    from posecnn_torch.data.factory import get_imdb

    _narrow(monkeypatch)
    seen = _record_matching(monkeypatch)
    cfg = _matching_cfg(tmp_path, "toy_pose.yml", {})
    assert C.unsupported(C.cfg_from_file(cfg)) == []
    out = tmp_path / "train"
    assert train_net.main(["--cfg", cfg, "--iters", "2", "--device", "cpu", "--output", str(out)]) == 0
    raw = np.asarray(get_imdb("toy_train")._points_all, np.float32)
    assert len(seen) == 2 and all(np.array_equal(s.numpy(), raw) for s in seen)
    head, row = (out / "train_metrics.csv").read_text().splitlines()
    m = dict(zip(head.split(","), map(float, row.split(","))))
    assert np.isfinite(m["loss_matching"]) and m["loss_matching"] >= 0 and np.isfinite(m["grad_norm"])


def test_train_net_matching_bank_path(tmp_path, monkeypatch):
    """train_net --cfg lov_syn_capstone.yml + TRAIN.MATCHING (the device
    bank; the refresh off) --iters 2 --device cpu on a toy SyntheticDataset
    at narrow widths: the bank step renders the raw clouds, and
    loss_matching is in the metrics, finite."""
    from posecnn_torch import train_net
    from posecnn_torch.data import factory
    from posecnn_torch.data import synthetic as S
    from posecnn_torch.data.toy import toy as Toy

    _narrow(monkeypatch)
    seen = _record_matching(monkeypatch)
    imdb = S.SyntheticDataset(Toy("train", num_classes=4, num_images=4), split="train", num_images=4, width=128,
                              height=96, max_objects=3)
    monkeypatch.setattr(factory, "get_imdb", lambda name: imdb)
    cfg = _matching_cfg(tmp_path, "lov_syn_capstone.yml",
                        {"  BANK_REFRESH: True\n": "  BANK_REFRESH: False\n",
                         "  NUM_CLASSES: 22\n": "  NUM_CLASSES: 4\n  DISPLAY: 1\n"})
    out = tmp_path / "train"
    assert train_net.main(["--cfg", cfg, "--iters", "2", "--device", "cpu", "--output", str(out)]) == 0
    raw = np.asarray(imdb._points_all, np.float32)
    assert len(seen) == 2 and all(np.array_equal(s.numpy(), raw) for s in seen)
    rows = (out / "train_metrics.csv").read_text().splitlines()
    m = dict(zip(rows[0].split(","), map(float, rows[-1].split(","))))
    assert np.isfinite(m["loss_matching"]) and m["loss_matching"] >= 0 and np.isfinite(m["grad_norm"])
