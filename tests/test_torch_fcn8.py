"""FCN-8s (NETWORK FCN8VGG) of the port against the JAX package.

`models/fcn8.py` in float32 against `posecnn_tpu/models/fcn8.py` (1e-5 of
the largest magnitude, exact labels; dropout from JAX's own draws,
replayed), `loss_cross_entropy_single_frame`, one `make_seg_train_step`
step against JAX's (the losses 1e-5 relative, each parameter's update
within 5e-5 of its largest move: the small training step's gradient
limit), snapshots in the layout of JAX's `train_segmentation` both ways,
`test_net_segmentation`'s IoU against JAX's, the builders of the shipped
FCN8VGG cfgs against the JAX CLI's expressions, and `train_net` and
`test_net` on the CPU at narrow widths. Two faults of the JAX package are
held by calling it: its segmentation step does not apply a batch's device
chroma and noise, and its test_net hands `restore_checkpoint` a params
dict, which fails.

Frames: frozen frames v4/000000-000003 resampled to 64x96 (FCN-8s needs
sides that are multiples of 32), the trunk at 1/4 width, fc 64.
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

from posecnn_tpu.core import checkpoint as JCK
from posecnn_tpu.core.config import cfg_fresh
from posecnn_tpu.data.imdb import PoseEvaluator as JaxEvaluator
from posecnn_tpu.data.minibatch import MinibatchConfig as JaxMB
from posecnn_tpu.engine import test as JT
from posecnn_tpu.engine.train import TrainHParams as JaxHP
from posecnn_tpu.engine.train import make_optimizer, make_seg_train_step
from posecnn_tpu.models import fcn8 as JF
from posecnn_tpu.ops.losses import loss_cross_entropy_single_frame as jax_ce
from posecnn_torch.config import PIXEL_MEANS
from posecnn_torch.core import checkpoint as CK
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import params_to_numpy
from posecnn_torch.data.imdb import PoseEvaluator
from posecnn_torch.data.lov_syn import LovSynVal
from posecnn_torch.data.minibatch import load_frozen_frame
from posecnn_torch.engine import test as PT
from posecnn_torch.engine import train as T
from posecnn_torch.models import factory
from posecnn_torch.models import fcn8 as F
from posecnn_torch.ops.losses import loss_cross_entropy_single_frame
from tests.torch_parity import goldens

G = goldens()
NUM_CLASSES = 22
NARROW = dict(trunk_scale=0.25, fc_dim=64)
FCN8_CFGS = ("rgbd_scene_single_color_fcn8.yml", "rgbd_scene_single_depth_fcn8.yml",
             "rgbd_scene_single_normal_fcn8.yml")


def _small(i: int):
    """Frozen frame i on a 64x96 grid (every 7th row from 16, every 6th
    column from 32)."""
    f = load_frozen_frame(os.path.join(G.ROOT, "data", "lov_syn_val_v4", f"{i:06d}.npz"))
    rows, cols = 16 + 7 * np.arange(64), 32 + 6 * np.arange(96)
    return dataclasses.replace(f, color=np.ascontiguousarray(f.color[np.ix_(rows, cols)]),
                               label=np.ascontiguousarray(f.label[np.ix_(rows, cols)]))


class SmallFrames(LovSynVal):
    def load_frame(self, i):
        return _small(i)


def _params(seed: int = 1):
    return F.init_fcn8_params_numpy(seed, NUM_CLASSES, **NARROW)


def _jax(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _data() -> np.ndarray:
    raw = np.stack([_small(i).color for i in (0, 1)]).astype(np.float32)
    return raw - np.asarray(PIXEL_MEANS, np.float32).reshape(1, 1, 1, 3)


def _jax_dropout_draws(rng, params, data):
    """JAX's dropout draws in fcn8_forward under `rng`, as the port's named
    uniforms: `bernoulli(key, p, shape)` is `uniform(key, shape) < p`."""
    r6, r7 = jax.random.split(rng)
    B, H, W = data.shape[:3]
    fc = params["fc6"]["weights"].shape[-1]
    shape = (B, H // 32, W // 32, fc)
    u6, u7 = jax.random.uniform(r6, shape), jax.random.uniform(r7, shape)
    assert bool(jnp.all(jax.random.bernoulli(r6, 0.5, shape) == (u6 < 0.5)))
    return {"dropout/fc6": torch.from_numpy(np.asarray(u6)), "dropout/fc7": torch.from_numpy(np.asarray(u7))}


def test_loss_cross_entropy_single_frame_matches_jax():
    """One-hot and soft label weights, with unlabelled pixels."""
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 8, 12, 5).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    onehot = np.eye(5, dtype=np.float32)[rng.randint(0, 5, (2, 8, 12))] * (rng.rand(2, 8, 12, 1) > 0.2)
    soft = rng.rand(2, 8, 12, 5).astype(np.float32)
    for labels in (onehot, soft, np.zeros_like(soft)):
        got = float(loss_cross_entropy_single_frame(torch.from_numpy(logp), torch.from_numpy(labels)))
        ref = float(jax_ce(jnp.asarray(logp), jnp.asarray(labels)))
        assert abs(got - ref) <= 1e-6 * max(abs(ref), 1.0), (got, ref)


@pytest.mark.parametrize("keep_prob", [1.0, 0.5])
def test_fcn8_forward_matches_jax(keep_prob):
    """float32 endpoints against JAX's on the same weights and frames:
    score, prob and prob_normalized within 1e-5 of the largest magnitude,
    label_2d exact; with dropout, JAX's draws replayed."""
    params = _params()
    data = _data()
    model = F.make_fcn8(NUM_CLASSES, params, "cpu", **NARROW)
    rng = jax.random.PRNGKey(3)
    draws = T.Draws(replay=_jax_dropout_draws(rng, params, data)) if keep_prob < 1 else None
    with torch.no_grad():
        out = F.fcn8_forward(model, torch.from_numpy(data), NUM_CLASSES, compute_dtype=torch.float32,
                             keep_prob=keep_prob, draws=draws)
    ref = JF.fcn8_forward(_jax(params), jnp.asarray(data), NUM_CLASSES, compute_dtype=jnp.float32,
                          keep_prob=keep_prob, rng=rng)
    for k in ("score", "prob", "prob_normalized"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=k)
    np.testing.assert_array_equal(out["label_2d"].numpy(), np.asarray(ref["label_2d"]))
    assert out["score"].shape == (2, 64, 96, NUM_CLASSES)


def test_fcn8_bf16_forward_runs_the_trunk_in_bf16():
    """The default compute dtype: bf16 convolutions with float32 outputs,
    labels agreeing with the float32 network on >= 99% of the pixels."""
    params = _params()
    model = F.make_fcn8(NUM_CLASSES, params, "cpu", **NARROW)
    data = torch.from_numpy(_data())
    with torch.no_grad():
        b = F.fcn8_forward(model, data, NUM_CLASSES)
        f = F.fcn8_forward(model, data, NUM_CLASSES, compute_dtype=torch.float32)
    assert b["score"].dtype == torch.float32
    assert float((b["label_2d"] == f["label_2d"]).float().mean()) >= 0.99


def _batch(chroma: bool = False):
    labels = np.stack([_small(i).label for i in (0, 1)]).astype(np.int32)
    labels[0, :4] = -1  # unlabelled rows
    raw = np.stack([_small(i).color for i in (0, 1)])
    batch = {"data": raw, "gt_label_2d": labels}
    if chroma:
        batch["chroma_dhls"] = np.asarray(G.TRAIN_CHROMA, np.float32)
        batch["noise_sigma"] = np.asarray([3.0, 5.0], np.float32)
    return batch


def _jax_seg_step(params, hp_kw, batch, rng):
    hp = JaxHP(**hp_kw)
    step = make_seg_train_step(lambda p, d, r: JF.fcn8_forward(p, d, NUM_CLASSES, compute_dtype=jnp.float32,
                                                               keep_prob=0.5, rng=r), hp, NUM_CLASSES)
    p = _jax(params)
    state = (p, make_optimizer(hp).init(p), jnp.asarray(0, jnp.int32))
    state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    return {k: float(v) for k, v in m.items()}, jax.tree_util.tree_map(np.asarray, state[0])


HP = dict(learning_rate=0.001, momentum=0.9, gamma=0.1, stepsize=80000, weight_reg=0.0001, clip_grad_norm=10.0)


def test_seg_train_step_matches_jax():
    """One `make_seg_train_step` step (dropout at keep 0.5 from JAX's draws,
    uint8 data with unlabelled pixels, clipping on) against JAX's: loss and
    loss_cls within 1e-5 relative, the lr exactly, each parameter after the
    update within 5e-5 of its largest move (plus two float32 ulps)."""
    params = _params()
    batch = _batch()
    rng = jax.random.PRNGKey(5)
    ref, ref_after = _jax_seg_step(params, HP, batch, rng)
    means = np.asarray(PIXEL_MEANS, np.float32).reshape(1, 1, 1, 3)
    draws = _jax_dropout_draws(rng, params, batch["data"].astype(np.float32) - means)
    hp = T.TrainHParams(**HP)
    state = T.create_train_state(F.make_fcn8(NUM_CLASSES, params, "cpu", **NARROW), hp)
    step = T.make_seg_train_step(lambda m, d, dr: F.fcn8_forward(m, d, NUM_CLASSES, compute_dtype=torch.float32,
                                                                 keep_prob=0.5, draws=dr), hp, NUM_CLASSES)
    got = step(state, T.to_device(batch, "cpu"), T.Draws(replay=draws))
    for k in ("loss", "loss_cls"):
        assert abs(float(got[k]) - ref[k]) <= 1e-5 * abs(ref[k]), (k, float(got[k]), ref[k])
    assert float(got["lr"]) == pytest.approx(ref["lr"], abs=1e-9) and state.step == 1
    after = params_to_numpy(state.model.state_dict())
    assert sorted(after) == sorted(ref_after)
    for layer, leaves in ref_after.items():
        for leaf, r in leaves.items():
            move = np.abs(r - params[layer][leaf]).max()
            err = np.abs(after[layer][leaf] - r).max()
            assert err <= 5e-5 * move + 2.4e-7 * np.abs(params[layer][leaf]).max(), (layer, leaf, err, move)


def test_seg_step_ignores_the_device_chroma_and_noise_as_jax_does():
    """A fault of the JAX package, called: its segmentation step reads only
    data and gt_label_2d, so a batch's chroma_dhls and noise_sigma (which a
    COLOR FCN8VGG minibatch under TPU.DEVICE_TARGETS ships) change nothing.
    The port's step does the same."""
    params = _params()
    rng = jax.random.PRNGKey(5)
    plain, with_aug = _jax_seg_step(params, HP, _batch(), rng), _jax_seg_step(params, HP, _batch(chroma=True), rng)
    assert plain[0] == with_aug[0]
    hp = T.TrainHParams(**HP)
    outs = []
    for chroma in (False, True):
        state = T.create_train_state(F.make_fcn8(NUM_CLASSES, params, "cpu", **NARROW), hp)
        step = T.make_seg_train_step(lambda m, d, dr: F.fcn8_forward(m, d, NUM_CLASSES, compute_dtype=torch.float32),
                                     hp, NUM_CLASSES)
        outs.append({k: float(v) for k, v in step(state, T.to_device(_batch(chroma), "cpu"), T.Draws()).items()})
    assert outs[0] == outs[1]


def test_fcn8_snapshots_load_in_both_packages(tmp_path):
    """A port FCN-8s snapshot restores into the JAX state of
    `train_segmentation` ((params, opt_state, step), clipping on) key for
    key and bit for bit, the bilinear upscore filters included; JAX's
    snapshot of it restores into a fresh port state bit for bit."""
    params = _params()
    hp = T.TrainHParams(clip_grad_norm=10.0)
    state = T.create_train_state(F.make_fcn8(NUM_CLASSES, params, "cpu", **NARROW), hp)
    gen = torch.Generator().manual_seed(0)
    for p, t in zip(state.optimizer.params, state.optimizer.trace):
        t.copy_(torch.randn(p.shape, generator=gen))
    state.step = 4
    path = CK.save_checkpoint(str(tmp_path / "port"), state, 4, prefix="fcn8_normal_single")
    jp = _jax(_params(2))
    jstate = (jp, make_optimizer(JaxHP(clip_grad_norm=10.0)).init(jp), jnp.asarray(0, jnp.int32))
    restored = JCK.restore_checkpoint(path, jstate)
    flat = JCK._flatten_state({"params": restored[0], "opt_state": restored[1], "step": restored[2]})
    with np.load(path) as d:
        files = {k: d[k] for k in d.files}
    assert set(files) == set(flat) and int(restored[2]) == 4
    assert "['params']['upscore32']['weights']" in files and files["['params']['fc6']['weights']"].shape[:2] == (7, 7)
    for k, v in files.items():
        assert np.array_equal(np.asarray(flat[k]), v), k
    jpath = JCK.save_checkpoint(str(tmp_path / "jax"), restored, 4, prefix="fcn8_normal_single")
    fresh = T.create_train_state(F.make_fcn8(NUM_CLASSES, _params(3), "cpu", **NARROW), hp)
    CK.restore_checkpoint(jpath, fresh)
    assert fresh.step == 4
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.trace, fresh.optimizer.trace):
        assert torch.equal(a, b)


def test_jax_test_net_cannot_restore_an_fcn8_snapshot_and_the_port_reads_it(tmp_path):
    """A fault of the JAX package, called: tools/test_net.py hands
    `restore_checkpoint` the params dict of FCN-8s, which it unpacks as a
    3-tuple (params, opt_state, step), so `--model` fails there. The port
    reads the snapshot as JAX's `load_params_npz` does, key for key; a
    leaf of another shape keeps its value, logged as JAX logs it."""
    params = _params()
    state = T.create_train_state(F.make_fcn8(NUM_CLASSES, params, "cpu", **NARROW), T.TrainHParams())
    path = CK.save_checkpoint(str(tmp_path), state, 1, prefix="fcn8", include_opt_state=False)
    with pytest.raises(ValueError, match="unpack"):
        JCK.restore_checkpoint(path, _jax(_params(2)))
    target = _params(2)
    target["score_fr"]["weights"] = np.zeros((1, 1, 64, 3), np.float32)  # a leaf of another shape
    logs, jlogs = [], []
    got = CK.load_params_npz(path, target, log=logs.append)
    ref = JCK.load_params_npz(path, _jax(target), log=jlogs.append)
    assert logs[0] == jlogs[0] and logs[-1].split(" from ")[0] == jlogs[-1].split(" from ")[0]
    for layer, leaves in got.items():
        for leaf, a in leaves.items():
            np.testing.assert_array_equal(a, np.asarray(ref[layer][leaf]), err_msg=f"{layer}/{leaf}")
    np.testing.assert_array_equal(got["conv1_1"]["weights"], params["conv1_1"]["weights"])


def test_test_net_segmentation_matches_jax():
    """test_net_segmentation on 4 small frames, the same weights (float32):
    the evaluator's IoU summary equal to JAX's."""
    params = _params()
    data = SmallFrames()
    ev = PoseEvaluator(data.classes, data._extents, data._points, [])
    jev = JaxEvaluator(data.classes, data._extents, data._points, [])
    timings = {}
    PT.test_net_segmentation(F.make_fcn8(NUM_CLASSES, params, "cpu", **NARROW),
                             lambda m, d: F.fcn8_forward(m, d, NUM_CLASSES, compute_dtype=torch.float32), data,
                             PIXEL_MEANS, evaluator=ev, max_frames=4, log=None, timings=timings)
    JT.test_net_segmentation(_jax(params), lambda p, d: JF.fcn8_forward(p, d, NUM_CLASSES, compute_dtype=jnp.float32),
                             data, PIXEL_MEANS, evaluator=jev, max_frames=4, log=None)
    s, js = ev.summary(), jev.summary()
    assert s["seg_iou"] == js["seg_iou"] and s["mean_iou"] == js["mean_iou"]
    assert len(timings["infer"]) == len(timings["evaluator"]) == 4


@pytest.mark.parametrize("name", FCN8_CFGS)
def test_seg_settings_are_the_jax_clis(name):
    """`seg_settings` against the expressions of tools/train_net.py:396-414
    (`train_segmentation`) on the shipped FCN8VGG cfgs."""
    path = os.path.join(G.ROOT, "experiments", "cfgs", name)
    c, ref = C.cfg_from_file(path), cfg_fresh(path)
    assert c.NETWORK == "FCN8VGG" and not C.unsupported(c, True) and not C.unsupported(c, False)
    hp, mcfg = C.seg_settings(c, NUM_CLASSES)
    want_hp = JaxHP(learning_rate=ref.TRAIN.LEARNING_RATE, momentum=ref.TRAIN.MOMENTUM, gamma=ref.TRAIN.GAMMA,
                    stepsize=ref.TRAIN.STEPSIZE, weight_reg=ref.TRAIN.WEIGHT_REG, clip_grad_norm=ref.TRAIN.GRAD_CLIP)
    assert dataclasses.asdict(hp) == dataclasses.asdict(want_hp)
    want = JaxMB(num_classes=NUM_CLASSES, pixel_means=ref.pixel_means(), chromatic=ref.TRAIN.CHROMATIC,
                 add_noise=ref.TRAIN.ADD_NOISE, vertex_reg=False, device_targets=ref.TPU.DEVICE_TARGETS,
                 input_format=ref.INPUT)
    for k, v in dataclasses.asdict(want).items():
        g = getattr(mcfg, k)
        assert np.array_equal(g, v) if isinstance(v, np.ndarray) else g == v, k


def test_factory_names():
    """Every name of the JAX package's registry gives the port's (init,
    forward), `dcgan` and `vgg16_gan` too; unknown names KeyError."""
    init, fwd = factory.get_network("fcn8_vgg")
    assert init is F.init_fcn8_params_numpy and fwd is F.fcn8_forward
    from posecnn_torch.core.convert import init_params_numpy
    from posecnn_torch.models.posecnn import posecnn_forward

    from posecnn_torch.models.detection import init_vgg16_det_params_numpy, vgg16_det_forward
    from posecnn_torch.models.posecnn_full import init_posecnn_full_params_numpy, posecnn_full_forward

    assert factory.get_network("vgg16_convs") == (init_params_numpy, posecnn_forward)
    assert factory.get_network("vgg16_det") == (init_vgg16_det_params_numpy, vgg16_det_forward)
    assert factory.get_network("vgg16_full") == (init_posecnn_full_params_numpy, posecnn_full_forward)
    from posecnn_torch.models.resnet50 import init_resnet50_params_numpy, resnet50_forward

    assert factory.get_network("resnet50") == (init_resnet50_params_numpy, resnet50_forward)
    from posecnn_torch.models.video import (init_video3d_params_numpy, init_video_params_numpy, video3d_forward,
                                            video_forward)

    assert factory.get_network("vgg16") == (init_video_params_numpy, video_forward)
    assert factory.get_network("vgg16_3d") == (init_video3d_params_numpy, video3d_forward)
    from posecnn_torch.models.gan import (dcgan_generator, init_dcgan_params_numpy, init_vgg16_gan_params_numpy,
                                          vgg16_gan_forward)

    assert factory.get_network("dcgan") == (init_dcgan_params_numpy, dcgan_generator)
    assert factory.get_network("vgg16_gan") == (init_vgg16_gan_params_numpy, vgg16_gan_forward)
    assert all(factory.get_network(n) for n in factory.JAX_NETWORKS)
    with pytest.raises(KeyError):
        factory.get_network("alexnet")


def _narrow_fcn8(monkeypatch):
    init, make = F.init_fcn8_params_numpy, F.make_fcn8
    monkeypatch.setattr(F, "init_fcn8_params_numpy", lambda seed, n: init(seed, n, trunk_scale=0.125, fc_dim=64))
    monkeypatch.setattr(F, "make_fcn8", lambda n, p, dev: make(n, p, dev, trunk_scale=0.125, fc_dim=64))


def test_train_net_and_test_net_fcn8_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """train_net --cfg rgbd_scene_single_normal_fcn8.yml --imdb
    lov_syn_val_v4 --iters 2 --device cpu (FCN-8s at narrow widths, the
    NORMAL host path): finite losses, the snapshot at 2; --resume --iters 3
    starts from it; test_net --cfg with that snapshot writes the IoU
    summary of 2 frames."""
    from posecnn_torch import test_net, train_net

    _narrow_fcn8(monkeypatch)
    cfg = os.path.join(G.ROOT, "experiments", "cfgs", "rgbd_scene_single_normal_fcn8.yml")
    out = tmp_path / "train"
    args = ["--cfg", cfg, "--imdb", "lov_syn_val_v4", "--device", "cpu", "--output", str(out)]
    assert train_net.main(args + ["--iters", "2"]) == 0
    assert (out / "fcn8_normal_single_iter_2.npz").exists()
    timing = json.loads((out / "train_timing.json").read_text())
    assert timing["end_step"] == 2
    first = [ln for ln in capsys.readouterr().out.splitlines() if "iter 1/2" in ln][0]
    assert np.isfinite(float(first.split("loss_cls: ")[1].split()[0])) and " lr: 0.001 " in first
    assert train_net.main(args + ["--iters", "3", "--resume"]) == 0
    timing = json.loads((out / "train_timing.json").read_text())
    assert timing["start_step"] == 2 and timing["end_step"] == 3
    ev = tmp_path / "eval"
    assert test_net.main(["--cfg", cfg, "--imdb", "lov_syn_val_v4", "--max_frames", "2", "--device", "cpu",
                          "--model", str(out / "fcn8_normal_single_iter_3.npz"), "--output", str(ev)]) == 0
    summary = json.loads((ev / "eval_summary.json").read_text())
    assert 0 <= summary["mean_iou"] <= 1 and json.loads((ev / "eval_timing.json").read_text())["frames"] == 2
    assert C.get_output_dir(C.cfg_from_file(cfg), "lov_syn_val_v4", "fcn8_vgg").endswith(
        os.path.join("rgbd_scene", "lov_syn_val_v4", "fcn8_vgg"))
