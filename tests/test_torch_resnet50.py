"""ResNet-50 (NETWORK RESNET50, --network resnet50) of the port against the
JAX package.

`models/resnet50.py` in float32 against `posecnn_tpu/models/resnet50.py`
on JAX's own weights carried across (score within 1e-4 of its largest
magnitude, label_2d equal wherever the two best scores are further apart
than twice that), and against the committed JAX golden
(`tests/golden/torch_port_resnet50.npz`, the check `chip_smoke.py` phase 17
(a) runs on the card); the numpy init against JAX's shapes and scales; one
`make_seg_train_step` step against JAX's (at float64 on both sides: loss
within 1e-5 relative, every gradient within 1e-4 of its largest magnitude,
the batch norms' included; at float32: the loss);
snapshots both ways; the network picked from NETWORK and --network with
the JAX CLIs' precedence; `train_net` and `test_net` with --network
resnet50 under the FCN8VGG cfg on the CPU.

Frames: frozen frames v4/000000-000003 resampled to 64x80, 5 or 10 classes.
ResNet-50 has no width option (nor has JAX's), so it runs at full width.
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
from posecnn_tpu.engine.train import TrainHParams as JaxHP
from posecnn_tpu.engine.train import make_optimizer, make_seg_train_step
from posecnn_tpu.models import resnet50 as JR
from posecnn_torch.config import PIXEL_MEANS
from posecnn_torch.core import checkpoint as CK
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import params_to_numpy
from posecnn_torch.data.lov_syn import LovSynVal
from posecnn_torch.data.minibatch import load_frozen_frame
from posecnn_torch.engine import train as T
from posecnn_torch.models import factory
from posecnn_torch.models import resnet50 as R
from tests.torch_parity import check_resnet50_golden, goldens, load_npz, resnet50_on_golden

G = goldens()
N = 5
ROWS, COLS = 16 + 7 * np.arange(64), 32 + 7 * np.arange(80)


def _small(i: int):
    """Frozen frame i on a 64x80 grid (every 7th row from 16, every 7th
    column from 32)."""
    f = load_frozen_frame(os.path.join(G.ROOT, "data", "lov_syn_val_v4", f"{i:06d}.npz"))
    return dataclasses.replace(f, color=np.ascontiguousarray(f.color[np.ix_(ROWS, COLS)]),
                               label=np.ascontiguousarray(f.label[np.ix_(ROWS, COLS)]),
                               depth=None if f.depth is None else np.ascontiguousarray(f.depth[np.ix_(ROWS, COLS)]))


class SmallFrames(LovSynVal):
    def load_frame(self, i):
        return _small(i)


def _jax_params(seed: int = 0, n: int = N):
    """JAX's own init (`init_resnet50_params`) as numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, JR.init_resnet50_params(jax.random.PRNGKey(seed), n))


def _data() -> np.ndarray:
    raw = np.stack([_small(i).color for i in (0, 1)]).astype(np.float32)
    return raw - np.asarray(PIXEL_MEANS, np.float32).reshape(1, 1, 1, 3)


def test_resnet50_forward_matches_jax():
    """float32 endpoints on JAX's init carried across: score within 1e-4 of
    its largest magnitude, prob and prob_normalized likewise, label_2d
    equal outside ties (the two best scores within 2e-4 of the largest)."""
    params = _jax_params()
    data = _data()
    model = R.make_resnet50(N, params, "cpu")
    with torch.no_grad():
        out = R.resnet50_forward(model, torch.from_numpy(data), N, compute_dtype=torch.float32)
    ref = JR.resnet50_forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(data), N,
                              compute_dtype=jnp.float32)
    for k in ("score", "prob", "prob_normalized"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=k)
    check_resnet50_golden(out, {"out/score": np.asarray(ref["score"]), "out/label_2d": np.asarray(ref["label_2d"])})
    assert out["score"].shape == (2, 64, 80, N) and out["label_2d"].dtype == torch.int32


def test_resnet50_golden_is_current():
    """The committed ResNet-50 golden equals JAX run again now, and stays
    well under 1 MB; its label map holds more than one class."""
    g, ref = G.resnet50_golden(), load_npz(G.RESNET50_GOLDEN)
    assert sorted(g) == sorted(ref)
    for k in g:
        if np.asarray(g[k]).dtype.kind == "f":
            np.testing.assert_allclose(g[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            assert np.array_equal(np.asarray(g[k]), ref[k]), k
    assert os.path.getsize(G.RESNET50_GOLDEN) < 400 << 10 and len(np.unique(ref["out/label_2d"])) >= 3


def test_resnet50_matches_jax_golden():
    """The golden's check (`check_resnet50_golden`, run on the card by
    chip_smoke.py phase 17 (a)) on the CPU."""
    err = check_resnet50_golden(*resnet50_on_golden("cpu"))
    assert err["score"] <= 1e-4 * err["score_max"]


def test_init_matches_jax_shapes_and_scales():
    """`init_resnet50_params_numpy` has JAX's layers, leaves and shapes;
    each weight's standard deviation is within 10% of JAX's draw's (He
    fan-in, branch2c and score 0.01), the biases zero and the batch norms
    the identity; upscore the bilinear 32x32 filter."""
    ours, ref = R.init_resnet50_params_numpy(0, N), _jax_params()
    assert sorted(ours) == sorted(ref)
    for layer, leaves in ref.items():
        assert sorted(ours[layer]) == sorted(leaves), layer
        for leaf, r in leaves.items():
            a = ours[layer][leaf]
            assert a.shape == r.shape and a.dtype == np.float32, (layer, leaf)
            if leaf == "weights" and layer != "upscore":
                assert abs(a.std() / r.std() - 1) < 0.1 if a.size > 1000 else a.std() > 0, (layer, a.std(), r.std())
                assert np.abs(a).max() <= 2 * r.std() * 1.15, layer  # truncated at 2 sigma
            else:
                np.testing.assert_array_equal(a, r, err_msg=f"{layer}/{leaf}")


def _batch():
    labels = np.stack([_small(i).label for i in (0, 1)]).astype(np.int32)
    labels[0, :4] = -1  # unlabelled rows
    return {"data": np.stack([_small(i).color for i in (0, 1)]), "gt_label_2d": labels}


def _jax_seg_step(params, batch, hp_kw, x64: bool):
    """JAX's `make_seg_train_step` on ResNet-50 at float32, or at float64
    (`jax.enable_x64`; its conv2d still rounds each convolution's result to
    float32): (its metrics, its momentum trace after the step, as float64
    numpy)."""
    dt = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        jhp = JaxHP(**hp_kw)
        jstep = make_seg_train_step(lambda p, d, r: JR.resnet50_forward(p, d.astype(dt), N, compute_dtype=dt), jhp, N)
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), params)
        (_, jopt, _), jm = jstep((jp, make_optimizer(jhp).init(jp), jnp.asarray(0, jnp.int32)),
                                 {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        return {k: float(v) for k, v in jm.items()}, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                                                            jopt[0].trace)


def _port_seg_step(params, batch, hp_kw, dtype):
    """The port's step on ResNet-50 in `dtype` (its parameters and its
    convolutions; each convolution's result rounded to float32, as JAX's
    conv2d does): (metrics, the gradients as float64 numpy, state)."""
    hp = T.TrainHParams(**hp_kw)
    state = T.create_train_state(R.make_resnet50(N, params, "cpu").to(dtype), hp)
    step = T.make_seg_train_step(lambda m, d, dr: R.resnet50_forward(m, d, N, compute_dtype=dtype), hp, N)
    got = step(state, T.to_device(batch, "cpu"), T.Draws())
    grads = params_to_numpy({k: p.grad.double() for k, p in state.model.named_parameters()})
    return {k: float(v) for k, v in got.items()}, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                                                        grads), state


SEG_HP = dict(learning_rate=0.001, momentum=0.9, gamma=0.1, stepsize=80000, weight_reg=0.0001, clip_grad_norm=0.0)


def test_seg_train_step_matches_jax():
    """One `make_seg_train_step` step of ResNet-50 (uint8 data with
    unlabelled pixels, no clipping, so JAX's momentum trace after the step
    is its gradient) against JAX's. At float64 on both sides (each
    convolution's result rounded to float32 on both, as JAX's conv2d does
    under x64): loss and loss_cls within 1e-5 relative, every gradient
    within 1e-4 of its largest magnitude (the batch norms' mean and
    variance included, which the step moves and the L2 term leaves out, as
    JAX's does). At float32: the loss terms within 1e-5 relative and the lr
    (JAX's float32, the port's float64). Float32 gradients are not held
    here: on the CPU this network's deep-block gradients (res4d_branch2b's
    weights, bn4d_branch2b's mean) read up to 1.7e-3 of their largest
    magnitude from the float64 step, with the convolution backend and the
    thread count (oneDNN at 1 thread 3.5e-4, without oneDNN 1.7e-3, at 2-8
    threads 5e-6), in JAX's float32 step as in the port's."""
    params = _jax_params(1)
    batch = _batch()
    jm64, ref_grads = _jax_seg_step(params, batch, SEG_HP, x64=True)
    got64, grads, state = _port_seg_step(params, batch, SEG_HP, torch.float64)
    for k in ("loss", "loss_cls"):
        assert abs(got64[k] - jm64[k]) <= 1e-5 * abs(jm64[k]), (k, got64[k], jm64[k])
    assert state.step == 1 and sorted(grads) == sorted(ref_grads)
    assert not np.abs(ref_grads.pop("upscore")["weights"]).any()  # JAX's fixed filter: zero gradient
    for layer, leaves in ref_grads.items():
        for leaf, r in leaves.items():
            g = grads[layer][leaf]
            assert np.abs(r).max() > 0, (layer, leaf)
            err = np.abs(g - r).max()
            assert err <= 1e-4 * np.abs(r).max(), (layer, leaf, err, np.abs(r).max())
    jm, _ = _jax_seg_step(params, batch, SEG_HP, x64=False)
    got, _, _ = _port_seg_step(params, batch, SEG_HP, torch.float32)
    for k in ("loss", "loss_cls"):
        assert abs(got[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, got[k], jm[k])
    assert got["lr"] == pytest.approx(jm["lr"], rel=1e-7)


def test_resnet50_snapshots_load_in_both_packages(tmp_path):
    """A port ResNet-50 snapshot restores into the JAX state of
    `train_segmentation` ((params, opt_state, step), clipping on) key for
    key and bit for bit, the batch norms and the bilinear upscore filter
    included; JAX's snapshot of it restores into a fresh port state bit for
    bit. JAX's test_net hands `restore_checkpoint` a params dict, which
    fails; the port reads the snapshot at the network's shapes
    (`load_params_npz`), key for key as JAX's `load_params_npz` does."""
    params = _jax_params(2)
    hp = T.TrainHParams(clip_grad_norm=10.0)
    state = T.create_train_state(R.make_resnet50(N, params, "cpu"), hp)
    gen = torch.Generator().manual_seed(0)
    for p, t in zip(state.optimizer.params, state.optimizer.trace):
        t.copy_(torch.randn(p.shape, generator=gen))
    state.step = 4
    path = CK.save_checkpoint(str(tmp_path / "port"), state, 4, prefix="fcn8_color_single")
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_params(3))
    jstate = (jp, make_optimizer(JaxHP(clip_grad_norm=10.0)).init(jp), jnp.asarray(0, jnp.int32))
    restored = JCK.restore_checkpoint(path, jstate)
    flat = JCK._flatten_state({"params": restored[0], "opt_state": restored[1], "step": restored[2]})
    with np.load(path) as d:
        files = {k: d[k] for k in d.files}
    assert set(files) == set(flat) and int(restored[2]) == 4
    assert files["['params']['upscore']['weights']"].shape == (32, 32, N, N)
    assert "['params']['bn5c_branch2c']['variance']" in files
    for k, v in files.items():
        assert np.array_equal(np.asarray(flat[k]), v), k
    jpath = JCK.save_checkpoint(str(tmp_path / "jax"), restored, 4, prefix="fcn8_color_single")
    fresh = T.create_train_state(R.make_resnet50(N, _jax_params(4), "cpu"), hp)
    CK.restore_checkpoint(jpath, fresh)
    assert fresh.step == 4
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.trace, fresh.optimizer.trace):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unpack"):
        JCK.restore_checkpoint(path, jp)
    got = CK.load_params_npz(path, R.init_resnet50_params_numpy(5, N))
    ref = JCK.load_params_npz(path, jp)
    for layer, leaves in got.items():
        for leaf, a in leaves.items():
            np.testing.assert_array_equal(a, np.asarray(ref[layer][leaf]), err_msg=f"{layer}/{leaf}")
    np.testing.assert_array_equal(got["res4c_branch2b"]["weights"], params["res4c_branch2b"]["weights"])


# the JAX CLIs' picks (tools/train_net.py:83-96, tools/test_net.py:61-109)
# for a config's NETWORK and --network
PICKS = [
    ("FCN8VGG", "resnet50", "resnet50"), ("FCN8VGG", "vgg16_convs", "fcn8_vgg"),
    ("FCN8VGG", "vgg16_full", "fcn8_vgg"), ("FCN8VGG", "vgg16_det", "vgg16_det"),
    ("RESNET50", "vgg16_convs", "resnet50"), ("RESNET50", "fcn8_vgg", "resnet50"),
    ("VGG16DET", "resnet50", "vgg16_det"), ("VGG16FULL", "resnet50", "resnet50"),
    ("VGG16FULL", "fcn8_vgg", "fcn8_vgg"), ("VGG16FULL", "vgg16_convs", "vgg16_full"),
    ("VGG16", "vgg16_full", "vgg16_full"), ("VGG16", "vgg16_convs", "vgg16_convs"),
    ("VGG16GAN", "vgg16_convs", "vgg16_convs"), (None, "resnet50", "resnet50"),
]


@pytest.mark.parametrize("network,flag,want", PICKS)
def test_pick_network_has_the_jax_clis_precedence(network, flag, want):
    """VGG16DET by either first, then ResNet-50 by either (an FCN8VGG cfg
    with --network resnet50 builds ResNet-50), then FCN-8s, then VGG16FULL,
    else the flag."""
    assert C.pick_network(network, flag) == want


def test_factory_and_config_know_resnet50():
    init, fwd = factory.get_network("resnet50")
    assert init is R.init_resnet50_params_numpy and fwd is R.resnet50_forward
    cfg = C.cfg_from_file(os.path.join(G.ROOT, "experiments", "cfgs", "rgbd_scene_single_color_fcn8.yml"))
    cfg.NETWORK = "RESNET50"
    assert not C.unsupported(cfg, True) and not C.unsupported(cfg, False)


def test_train_net_and_test_net_resnet50_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """train_net --cfg rgbd_scene_single_color_fcn8.yml (NETWORK FCN8VGG)
    --network resnet50 --imdb lov_syn_val_v4 --iters 2 --device cpu on
    64x80 frames: ResNet-50, not FCN-8s, trains (its batch norms in the
    snapshot at 2), with finite losses; test_net with the same flags on that
    snapshot writes the IoU summary of 2 frames under .../resnet50."""
    from posecnn_torch import test_net, train_net
    from posecnn_torch.data import factory as DF

    get = DF.get_imdb
    monkeypatch.setattr(DF, "get_imdb", lambda name: SmallFrames() if name == "lov_syn_val_v4" else get(name))
    cfg = os.path.join(G.ROOT, "experiments", "cfgs", "rgbd_scene_single_color_fcn8.yml")
    out = tmp_path / "train"
    args = ["--cfg", cfg, "--network", "resnet50", "--imdb", "lov_syn_val_v4", "--device", "cpu"]
    assert train_net.main(args + ["--iters", "2", "--output", str(out)]) == 0
    snap = out / "fcn8_color_single_iter_2.npz"
    with np.load(snap) as d:
        assert "['params']['bn_conv1']['mean']" in d.files and "['params']['fc6']['weights']" not in d.files
    log = capsys.readouterr().out
    first = [ln for ln in log.splitlines() if "iter 1/2" in ln][0]
    assert np.isfinite(float(first.split("loss_cls: ")[1].split()[0])) and " lr: 0.001 " in first
    assert json.loads((out / "train_timing.json").read_text())["end_step"] == 2
    ev = tmp_path / "eval"
    assert test_net.main(args + ["--max_frames", "2", "--model", str(snap), "--output", str(ev)]) == 0
    summary = json.loads((ev / "eval_summary.json").read_text())
    timing = json.loads((ev / "eval_timing.json").read_text())
    assert 0 <= summary["mean_iou"] <= 1 and timing["frames"] == 2 and timing["network"] == "resnet50"
    assert "restored 163/163 tensors" in capsys.readouterr().out
    assert C.get_output_dir(C.cfg_from_file(cfg), "lov_syn_val_v4", "resnet50").endswith(
        os.path.join("rgbd_scene", "lov_syn_val_v4", "resnet50"))
