"""The host-fed training path of the port on the toy dataset, against the
JAX package: `engine.train.make_train_step` over two steps (the second
across a STEPSIZE boundary) against the toy golden of JAX's
`make_train_step`; Hough voting from the ground truth (`hough_from_gt`)
against JAX's with its Pallas vote kernel in interpret mode; the weights at
the toy widths carried both ways; the Solver on host batches; and the
cfg-driven `train_net` and `test_net` CLIs on the CPU at narrow widths,
whose snapshot loads in JAX's `restore_checkpoint`.

Tolerances: the golden's are `tests/torch_parity.py:check_toy_train_golden`;
Hough rois within 1e-3 and poses_init within 1e-4 (a mean depth summed in
another order), valid rows, classes, weights exactly, targets within 1e-6.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.models.posecnn as JP
import posecnn_tpu.ops.pallas.voting as JV
from posecnn_tpu.core import checkpoint as JC
from posecnn_tpu.core.checkpoint import _flatten_state
from posecnn_tpu.engine.train import TrainHParams as JaxHP
from posecnn_tpu.engine.train import create_train_state as jax_create_train_state
from posecnn_tpu.ops.hough_voting import hough_voting as jax_hough_voting
from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import init_params_numpy, make_model, params_to_numpy
from posecnn_torch.engine import train as T
from posecnn_torch.engine.test import set_float32_precision
from posecnn_torch.models.posecnn import posecnn_forward
from tests.torch_parity import check_toy_train_golden, goldens, load_npz, t, toy_train_on_golden

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOY_CFG = os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml")
NARROW = dict(trunk_scale=0.125, fc_dim=64)


@pytest.fixture(autouse=True)
def _f32_precision():
    set_float32_precision()


def test_toy_train_golden_is_current():
    """The committed golden equals JAX run again now."""
    G = goldens()
    g, ref = G.toy_train_golden(), load_npz(G.TOY_TRAIN_GOLDEN)
    assert sorted(g) == sorted(ref)
    for k in g:
        if np.asarray(g[k]).dtype.kind in "iufb":
            np.testing.assert_allclose(g[k], ref[k], rtol=1e-6, atol=1e-12, err_msg=k)
        else:
            assert np.array_equal(np.asarray(g[k]), ref[k]), k
    assert float(ref["step1/loss_pose"]) > 0  # the second step trains the pose head
    assert os.path.getsize(G.TOY_TRAIN_GOLDEN) < 2 << 20


def test_host_fed_step_matches_jax_golden():
    """Two host-fed steps (toy batches, flipped entries included) against
    JAX's make_train_step: losses, lr, gradient norm, parameter slices."""
    outs, before, after, g = toy_train_on_golden()
    err = check_toy_train_golden(outs, before, after, g)
    assert outs[0]["lr"] == pytest.approx(1e-3) and outs[1]["lr"] == pytest.approx(1e-4)
    assert err


def test_bank_step_is_the_host_step_on_a_sampled_batch():
    """make_bank_train_step samples a batch and runs make_train_step on it:
    the same outputs and update as the host step on that batch."""
    G = goldens()
    g = load_npz(G.TOY_TRAIN_GOLDEN)
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **{k[4:]: g[k].item() for k in g if k.startswith("cfg/")})
    hp = T.TrainHParams(**{k[3:]: g[k].item() for k in g if k.startswith("hp/")})
    consts = [t(g[k]) for k in ("points", "symmetry", "extents")]
    b = {k.split("/", 1)[1]: t(g[k]) for k in g if k.startswith("batch0/")}
    bank = {"data": b["data"], "label": b["gt_label_2d"].to(torch.uint8), "meta_data": b["meta_data"],
            "gt_centers": b["gt_centers"][:, :4], "pose_rows": torch.zeros((2, 4, 13))}
    rec = T.Draws(torch.Generator().manual_seed(0), record=True)
    s1 = T.create_train_state(make_model(cfg, init_params_numpy(1, cfg), "cpu"), hp)
    out1 = T.make_bank_train_step(cfg, hp, *consts, batch_size=2, max_gt=4)(s1, bank, rec)
    batch = T.sample_batch(bank, 2, 4, False, False, T.Draws(replay=rec.recorded))
    s2 = T.create_train_state(make_model(cfg, init_params_numpy(1, cfg), "cpu"), hp)
    out2 = T.make_train_step(cfg, hp, *consts)(s2, batch, T.Draws(replay=rec.recorded))
    for k in out1:
        assert torch.equal(out1[k], out2[k]), k
    assert all(torch.equal(a, b) for a, b in zip(s1.model.parameters(), s2.model.parameters()))


def _hough_from_gt_inputs():
    """A toy batch (two frames, one flipped) and a small model config."""
    g = load_npz(goldens().TOY_TRAIN_GOLDEN)
    b = {k.split("/", 1)[1]: g[k] for k in g if k.startswith("batch1/")}
    kw = dict(num_classes=4, num_units=16, is_train=True, keep_prob=1.0, hough_class_slots=3, hough_max_samples=128,
              hough_center_stride=4, hough_refine_window=8, label_threshold=50, hough_pixel_stride=3, skip_pixels=1,
              hough_sampler="approx", use_crop_pool=True, hough_from_gt=True, **NARROW)
    return b, kw, g["extents"]


def test_hough_from_gt_matches_jax(monkeypatch):
    """With hough_from_gt, Hough reads the GT label and the GT vertex
    targets, not the heads: the training outputs of JAX's posecnn_forward,
    its vote kernel in Pallas interpret mode, on the same batch."""
    b, kw, extents = _hough_from_gt_inputs()
    means = np.asarray([102.9801, 115.9465, 122.7717], np.float32)
    data = b["data"].astype(np.float32) - means
    params = init_params_numpy(5, PoseCNNConfig(**kw))
    jcfg = JP.PoseCNNConfig(compute_dtype=jnp.float32, **kw)
    orig = JV._votes_pallas
    monkeypatch.setattr(JV, "_votes_pallas", lambda s, c, block, interpret: orig(s, c, block, True))
    monkeypatch.setattr(JP, "hough_voting", functools.partial(jax_hough_voting, use_pallas=True))
    ref = JP.posecnn_forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg, jnp.asarray(data),
                             jnp.asarray(extents), jnp.asarray(b["meta_data"]), gt_poses=jnp.asarray(b["poses"]),
                             gt_label_2d=jnp.asarray(b["gt_label_2d"]), gt_centers=jnp.asarray(b["gt_centers"]))
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **kw)
    model = make_model(cfg, params, "cpu")
    with torch.no_grad():
        got = posecnn_forward(model, cfg, t(data), t(extents), t(b["meta_data"]), gt_poses=t(b["poses"]),
                              gt_label_2d=t(b["gt_label_2d"]), gt_centers=t(b["gt_centers"]), draws=T.Draws())
    np.testing.assert_array_equal(got["rois_valid"].numpy(), np.asarray(ref["rois_valid"]))
    np.testing.assert_array_equal(got["rois"][:, :2].numpy(), np.asarray(ref["rois"])[:, :2])
    np.testing.assert_array_equal(got["poses_weight"].numpy(), np.asarray(ref["poses_weight"]))
    np.testing.assert_allclose(got["rois"].numpy(), np.asarray(ref["rois"]), atol=1e-3)
    np.testing.assert_allclose(got["poses_init"].numpy(), np.asarray(ref["poses_init"]), atol=1e-4)
    np.testing.assert_allclose(got["poses_target"].numpy(), np.asarray(ref["poses_target"]), atol=1e-6)
    assert got["rois_valid"].sum() >= 2 and got["poses_weight"].sum() > 0  # both frames' objects are found
    # the heads do not enter: other weights, the same Hough outputs
    model2 = make_model(cfg, init_params_numpy(6, cfg), "cpu")
    with torch.no_grad():
        again = posecnn_forward(model2, cfg, t(data), t(extents), t(b["meta_data"]), gt_poses=t(b["poses"]),
                                gt_label_2d=t(b["gt_label_2d"]), gt_centers=t(b["gt_centers"]), draws=T.Draws())
    for k in ("rois", "poses_init", "poses_target", "poses_weight", "rois_valid"):
        assert torch.equal(again[k], got[k]), k
    with pytest.raises(ValueError, match="hough_from_gt needs"):
        posecnn_forward(model, cfg, t(data), t(extents), t(b["meta_data"]), draws=T.Draws())


def test_convert_carries_toy_widths_both_ways():
    """JAX parameters at NUM_UNITS 16 and 4 classes load into the port and
    come back unchanged (upscore filters from the bilinear formula)."""
    jcfg = JP.PoseCNNConfig(num_classes=4, num_units=16, compute_dtype=jnp.float32, **NARROW)
    params = jax.tree_util.tree_map(np.asarray, JP.init_posecnn_params(jax.random.PRNGKey(3), jcfg))
    model = make_model(PoseCNNConfig(num_classes=4, num_units=16, is_train=False, **NARROW), params, "cpu")
    assert model.score.weight.shape == (4, 16, 1, 1) and model.fc8.weight.shape == (16, 64)
    assert model.score_conv4.weight.shape[0] == 16 and model.vertex_pred.weight.shape[0] == 12
    back = params_to_numpy(model.state_dict())
    assert set(back) == set(params)
    for layer, leaves in params.items():
        for leaf, a in leaves.items():
            assert back[layer][leaf].shape == a.shape and np.array_equal(back[layer][leaf], a), (layer, leaf)


def test_solver_feeds_host_batches():
    """The Solver copies each host batch to the model's device, fetches one
    item ahead (no item past the last step) and records the data wait and
    step times."""
    seen = []

    def step(state, batch, draws):
        seen.append({k: (type(v).__name__, v.device.type) for k, v in batch.items()})
        state.step += 1
        return {"loss": torch.tensor(0.0)}

    fetched = []

    def source():
        for i in range(10):
            fetched.append(i)
            yield {"data": np.zeros((1, 2, 2, 3), np.uint8), "i": np.asarray([i])}

    state = T.create_train_state(make_model(PoseCNNConfig(num_classes=4, num_units=16, is_train=True,
                                                          use_crop_pool=True, **NARROW),
                                            init_params_numpy(0, PoseCNNConfig(num_classes=4, num_units=16, **NARROW)),
                                            "cpu"), T.TrainHParams())
    timings = {}
    T.Solver(step, display=10**6).train(source(), state, 3, log=None, handle_signals=False, timings=timings)
    assert fetched == [0, 1, 2] and state.step == 3
    assert seen[0] == {"data": ("Tensor", "cpu"), "i": ("Tensor", "cpu")}
    assert len(timings["data_wait"]) == 3 and len(timings["step"]) == 3 and "step_stream" not in timings


def _narrow(monkeypatch):
    """The CLIs' model configs at narrow widths (the trunk at 1/8, fc 64)."""
    for name in ("train_model_cfg", "test_model_cfg"):
        orig = getattr(C, name)
        monkeypatch.setattr(C, name, lambda cfg, n, _f=orig: dataclasses.replace(_f(cfg, n), **NARROW))


def test_train_net_and_test_net_cli_on_cpu(tmp_path, monkeypatch):
    """train_net --cfg toy_pose.yml --iters 2 --device cpu (at narrow
    widths): the metrics row, train_timing.json and a snapshot that JAX's
    restore_checkpoint loads key for key; then test_net --cfg on toy_val
    with that snapshot writes eval_summary.json and detections.npz."""
    from posecnn_torch import test_net, train_net

    _narrow(monkeypatch)
    out = tmp_path / "train"
    assert train_net.main(["--cfg", TOY_CFG, "--iters", "2", "--device", "cpu", "--output", str(out)]) == 0
    snap = out / "caffenet_fast_rcnn_iter_2.npz"
    assert snap.exists()
    rows = (out / "train_metrics.csv").read_text().splitlines()
    assert len(rows) == 2 and rows[1].startswith("2,")
    timing = json.loads((out / "train_timing.json").read_text())
    assert timing["end_step"] == 2 and len(timing["ms"]["data_wait"]) == 2 and len(timing["ms"]["step"]) == 2
    # JAX loads it: every key of its train state is in the file, values equal
    jcfg = JP.PoseCNNConfig(num_classes=4, num_units=16, compute_dtype=jnp.float32, is_train=True, keep_prob=0.5,
                            use_crop_pool=True, **NARROW)
    jstate = jax_create_train_state(jcfg, JaxHP(clip_grad_norm=10.0), jax.random.PRNGKey(0))
    restored = JC.restore_checkpoint(str(snap), jstate)
    flat = _flatten_state({"params": restored[0], "opt_state": restored[1], "step": restored[2]})
    with np.load(snap) as d:
        files = {k: d[k] for k in d.files}
    assert set(files) == set(flat) and int(restored[2]) == 2
    for k, v in files.items():
        assert np.array_equal(np.asarray(flat[k]), v), k

    ev = tmp_path / "eval"
    assert test_net.main(["--cfg", TOY_CFG, "--imdb", "toy_val", "--max_frames", "2", "--device", "cpu",
                          "--model", str(snap), "--output", str(ev)]) == 0
    summary = json.loads((ev / "eval_summary.json").read_text())
    assert 0 <= summary["mean_iou"] <= 1 and set(summary["seg_iou"]) <= {"__background__", "box_01", "box_02",
                                                                          "box_03"}
    timing = json.loads((ev / "eval_timing.json").read_text())
    assert timing["imdb"] == "toy_val" and timing["frames"] == 2 and not timing["pose_refine"]
    assert timing["nms_threshold"] == 0.3 and "icp" in timing["ms"]
    with np.load(ev / "detections.npz") as d:
        assert all(d[k].ndim == 2 and d[k].shape[1] == 7 for k in d.files)
    # --weights is read now (tests/test_torch_legacy_ckpt.py holds the
    # reader to JAX's): a missing file stops the run before its first step
    with pytest.raises(FileNotFoundError, match="vgg16.npy"):
        train_net.main(["--cfg", TOY_CFG, "--iters", "1", "--device", "cpu", "--weights",
                        str(tmp_path / "vgg16.npy"), "--output", str(tmp_path / "w")])
    # TRAIN.SYNTHESIZE runs now (tests/test_torch_synthesize.py trains it
    # on a tree); as shipped, its SYNROOT's files are not in the repository
    with pytest.raises(FileNotFoundError, match="data_syn"):
        train_net.main(["--cfg", os.path.join(ROOT, "experiments", "cfgs", "lov_color_2d.yml"), "--imdb",
                        "toy_train", "--iters", "1", "--device", "cpu", "--output", str(tmp_path / "syn")])
    assert C.get_output_dir(C.cfg_from_file(TOY_CFG), "toy_train", "vgg16_convs") == \
        os.path.join(ROOT, "output", "toy", "toy_train", "vgg16_convs")


def test_train_net_sigterm_with_prefetch_thread(tmp_path, monkeypatch):
    """SIGTERM during a host-fed run: the snapshot lands at the step
    reached, and the prefetch thread ends."""
    from posecnn_torch import train_net

    _narrow(monkeypatch)
    out = tmp_path / "train"
    steps = []
    orig = T.make_train_step

    def counting(*a, **k):
        inner = orig(*a, **k)

        def step(state, batch, draws):
            r = inner(state, batch, draws)
            steps.append(state.step)
            if state.step == 2:
                threading.Timer(0.0, lambda: os.kill(os.getpid(), signal.SIGTERM)).start()
            return r

        return step

    monkeypatch.setattr(T, "make_train_step", counting)
    assert train_net.main(["--cfg", TOY_CFG, "--iters", "1000", "--device", "cpu", "--output", str(out)]) == 0
    n = steps[-1]
    assert 2 <= n < 1000
    assert sorted(p.name for p in out.glob("*.npz")) == [f"caffenet_fast_rcnn_iter_{n}.npz"]
    t_end = time.monotonic() + 5
    while any(th.name == "prefetch" and th.is_alive() for th in threading.enumerate()):
        assert time.monotonic() < t_end, "the prefetch thread outlived the run"
        time.sleep(0.01)


def test_train_net_device_bank_branch_on_cpu(tmp_path, monkeypatch):
    """TPU.DEVICE_BANK with --cfg: every frame of the dataset in a bank on
    the device, the bank step sampling from it."""
    from posecnn_torch import train_net

    _narrow(monkeypatch)
    with open(TOY_CFG) as f:
        text = f.read().replace("  ADD_NOISE: False\n", "  ADD_NOISE: True\n  USE_FLIPPED: False\n")
    text += "TPU:\n  DEVICE_BANK: True\n"
    cfg = tmp_path / "bank.yml"
    cfg.write_text(text)
    out = tmp_path / "train"
    assert train_net.main(["--cfg", str(cfg), "--iters", "2", "--device", "cpu", "--output", str(out)]) == 0
    assert (out / "caffenet_fast_rcnn_iter_2.npz").exists()
    flipped = tmp_path / "flipped.yml"
    flipped.write_text(text.replace("  USE_FLIPPED: False\n", ""))
    with pytest.raises(ValueError, match="DEVICE_BANK"):
        train_net.main(["--cfg", str(flipped), "--iters", "1", "--device", "cpu", "--output", str(out)])
