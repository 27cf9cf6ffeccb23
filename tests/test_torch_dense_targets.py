"""Dense host vertex targets (TPU.DEVICE_TARGETS False) of the port against
the JAX package: `generate_vertex_targets`' 2D branch (by class, and by
instance through a mask, the rule the device path's nearest centre does not
follow), `get_minibatch(device_targets=False)` bit-equal to JAX's, the
dense vertex loss (`smooth_l1_loss_vertex`) and one training step on a
dense batch against JAX's `compute_losses`, and `train_net --cfg` with the
setting on the CPU at narrow widths.

Tolerances: the targets and batches exactly; the step's loss terms and
gradient norm within 1e-5 relative, each gradient within 2e-5 of its
largest magnitude (the small training step's, `tests/test_torch_train.py`).
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
from posecnn_tpu.ops.losses import smooth_l1_loss_vertex as jax_loss
from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import init_params_numpy, make_model, params_from_numpy
from posecnn_torch.data import minibatch as M
from posecnn_torch.engine import train as T
from posecnn_torch.engine.test import set_float32_precision
from posecnn_torch.ops.losses import smooth_l1_loss_vertex
from posecnn_torch.ops.vertex_targets import vertex_targets_device
from tests.torch_parity import goldens, t, v4_frame

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOY_CFG = os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _f32_precision():
    set_float32_precision()


def _jax_frame(f) -> JM.Frame:
    return JM.Frame(color=f.color, label=f.label, cls_indexes=f.cls_indexes, poses=f.poses, center=f.center,
                    intrinsic_matrix=f.intrinsic_matrix, depth=f.depth, factor_depth=f.factor_depth, mask=f.mask,
                    flipped=f.flipped, is_adaptation=f.is_adaptation)


def _two_instances(i: int = 0):
    """Frozen frame i with its second object relabelled as the first's class:
    two instances of one class, told apart by the mask."""
    f = v4_frame(i)
    c1, c2 = int(f.cls_indexes[0]), int(f.cls_indexes[1])
    mask = np.zeros(f.label.shape, np.int32)
    mask[f.label == c1], mask[f.label == c2] = 1, 2
    label = np.where(f.label == c2, c1, f.label).astype(f.label.dtype)
    cls = np.array(f.cls_indexes, copy=True)
    cls[1] = c1
    return dataclasses.replace(f, label=label, cls_indexes=cls, mask=mask)


def _models(C_: int = 22):
    rng = np.random.RandomState(3)
    points = rng.uniform(-0.05, 0.05, (C_, 16, 3)).astype(np.float32)
    extents = np.abs(rng.randn(C_, 3)).astype(np.float32) * 0.1 + 0.02
    symmetry = (rng.rand(C_) > 0.7).astype(np.float32)
    return points, extents, symmetry


def test_generate_vertex_targets_2d_matches_jax_and_routes_by_mask():
    """By class and by instance (two objects of one class): JAX's targets
    exactly. Through the mask every pixel points at its own instance's
    centre; the device path's nearest-centre rule sends some to the other."""
    f = _two_instances(0)
    for mask in (None, f.mask):
        ref = JM.generate_vertex_targets(f.label, f.cls_indexes, f.center, f.poses, 22, 10.0, mask=mask)
        got = M.generate_vertex_targets(f.label, f.cls_indexes, f.center, f.poses, 22, 10.0, mask=mask)
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    c = int(f.cls_indexes[0])
    centers = np.zeros((1, 24, 4), np.float32)
    centers[0, :2, 0], centers[0, :2, 1:3], centers[0, :2, 3] = c, f.center[:2], f.poses[2, 3, :2]
    dev, _ = vertex_targets_device(torch.from_numpy(f.label[None].astype(np.int32)), torch.from_numpy(centers), 22)
    sel = f.label == c
    differ = np.abs(dev[0].numpy()[sel][:, 3 * c:3 * c + 2] - got[0][sel][:, 3 * c:3 * c + 2]).max(-1) > 1e-3
    assert 0 < differ.mean() < 1


@pytest.mark.parametrize("case", ["color", "mask_adapt_flip", "scale_rgbd"])
def test_dense_minibatch_matches_jax(case):
    """B=2 frozen 480x640 frames: the chroma jitter and the noise on the
    host, two instances with a mask, an adaptation frame, a flipped frame,
    the input rescale, the RGBD depth image: every blob bit-equal, the
    RandomState left in step."""
    points, extents, symmetry = _models()
    frames = [v4_frame(2), v4_frame(3)]
    kw = dict(num_classes=22, chromatic=True, add_noise=True, vertex_reg=True, device_targets=False, max_gt=8)
    if case == "mask_adapt_flip":
        frames = [dataclasses.replace(_two_instances(0), flipped=True),
                  dataclasses.replace(v4_frame(1), is_adaptation=True)]
    elif case == "scale_rgbd":
        kw.update(scale=0.5, input_format="RGBD", is_symmetric=False)
    ra, rb = np.random.RandomState(5), np.random.RandomState(5)
    ref = JM.get_minibatch([_jax_frame(f) for f in frames], JM.MinibatchConfig(**kw), extents, points, symmetry,
                           rng=ra)
    got = M.get_minibatch(frames, M.MinibatchConfig(**kw), rb, extents=extents, points=points, symmetry=symmetry)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert ref[k].dtype == got[k].dtype and ref[k].shape == got[k].shape and np.array_equal(ref[k], got[k]), k
    assert ra.rand() == rb.rand()
    H = 240 if case == "scale_rgbd" else 480
    assert got["vertex_targets"].shape == (2, H, 4 * H // 3, 66) and got["data"].dtype == np.float32
    assert "chroma_dhls" not in got and "noise_sigma" not in got and "gt_centers" not in got
    if case == "mask_adapt_flip":
        assert not got["vertex_weights"][1].any() and (got["gt_label_2d"][1] == -1).all()


def test_dense_vertex_loss_matches_jax():
    rng = np.random.RandomState(2)
    pred = rng.randn(2, 6, 8, 15).astype(np.float32)
    target = rng.randn(2, 6, 8, 15).astype(np.float32) * 0.5
    weights = (rng.rand(2, 6, 8, 15) > 0.6).astype(np.float32) * 10.0
    for sigma in (1.0, 3.0):
        ref = float(jax_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weights), sigma))
        got = float(smooth_l1_loss_vertex(t(pred), t(target), t(weights), sigma))
        assert got == pytest.approx(ref, rel=1e-6)
    assert float(smooth_l1_loss_vertex(t(pred), t(target), t(weights * 0))) == 0.0


def test_dense_train_step_matches_jax():
    """The small training step (trunk 1/8, 22 classes, 64x80, float32,
    Hough on the network's labels) on a dense host batch: the loss terms,
    loss_vertex from the dense targets, the gradient norm and every
    gradient against JAX's compute_losses on the same batch."""
    G = goldens()
    points, extents, symmetry = _models()
    frames = G.train_frames()
    kw = dict(num_classes=22, chromatic=False, add_noise=False, vertex_reg=True, device_targets=False, max_gt=8)
    batch = JM.get_minibatch([_jax_frame(f) for f in frames], JM.MinibatchConfig(**kw), extents, points, symmetry,
                             rng=np.random.RandomState(0))
    assert "vertex_targets" in batch and batch["vertex_weights"].max() == 10.0
    cfg_kw, hp_kw = dict(G.TRAIN_CFG, hough_gt_mix=0.0), dict(G.TRAIN_HP)
    params = init_params_numpy(G.TRAIN_SEED, PoseCNNConfig(**cfg_kw))
    loss_pts = M.rescale_points(points, extents, symmetry)
    r_losses, r_grads, r_lr, r_norm, _ = G.jax_train_steps(cfg_kw, hp_kw, params, batch, loss_pts, symmetry, extents)
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **cfg_kw)
    hp = T.TrainHParams(**hp_kw)
    model = make_model(cfg, params, "cpu")
    state = T.create_train_state(model, hp)
    loss, losses = T.compute_losses(model, cfg, hp, {k: t(v) for k, v in batch.items()}, t(loss_pts), t(symmetry),
                                    t(extents))
    g_norm = float(T.train_update(state, loss, T.lr_schedule(hp)(0)))
    assert r_losses["loss_vertex"] > 0 and set(r_losses) == set(losses)
    for k, v in r_losses.items():
        assert abs(float(losses[k]) - v) <= 1e-5 * max(abs(v), 1e-3), (k, float(losses[k]), v)
    assert abs(g_norm - r_norm) <= 1e-5 * r_norm
    for k, g in params_from_numpy({k: v for k, v in r_grads.items() if not k.startswith("upscore")}).items():
        p = dict(model.named_parameters())[k]
        assert float((p.grad - g).abs().max()) <= 2e-5 * float(g.abs().max()), k


def _narrow(monkeypatch):
    for name in ("train_model_cfg", "test_model_cfg"):
        orig = getattr(C, name)
        monkeypatch.setattr(C, name, lambda cfg, n, _f=orig: dataclasses.replace(_f(cfg, n), trunk_scale=0.125,
                                                                                 fc_dim=64))


def test_train_net_with_dense_targets_on_cpu(tmp_path, monkeypatch):
    """train_net --cfg (toy_pose.yml with TPU.DEVICE_TARGETS False) --iters
    2 --device cpu at narrow widths: the dense batches through the
    prefetch thread, finite losses with loss_vertex, the snapshot; with
    HOUGH_GT_MIX as well the config is refused, naming the setting (JAX's
    step raises KeyError on the batch's missing gt_centers)."""
    from posecnn_torch import train_net

    _narrow(monkeypatch)
    cfg = tmp_path / "toy_dense.yml"
    cfg.write_text(open(TOY_CFG).read() + "TPU:\n  DEVICE_TARGETS: False\n")
    out = tmp_path / "train"
    assert train_net.main(["--cfg", str(cfg), "--iters", "2", "--device", "cpu", "--output", str(out)]) == 0
    rows = (out / "train_metrics.csv").read_text().splitlines()
    head = rows[0].split(",")
    vals = dict(zip(head, rows[1].split(",")))
    assert np.isfinite(float(vals["loss_vertex"])) and float(vals["loss_vertex"]) > 0
    timing = json.loads((out / "train_timing.json").read_text())
    assert timing["end_step"] == 2 and len(timing["ms"]["data_wait"]) == 2
    assert (out / "caffenet_fast_rcnn_iter_2.npz").exists()
    mix = tmp_path / "toy_dense_mix.yml"
    mix.write_text(open(TOY_CFG).read() + "TPU:\n  DEVICE_TARGETS: False\n  HOUGH_GT_MIX: 0.5\n")
    with pytest.raises(NotImplementedError, match="TPU.DEVICE_TARGETS"):
        train_net.main(["--cfg", str(mix), "--iters", "1", "--device", "cpu", "--output", str(tmp_path / "mix")])
    assert C.unsupported(C.cfg_from_file(str(cfg))) == []
