"""The domain head (TRAIN.ADAPT) and the GAN cfg's host batch
(TRAIN.GAN) of the port against the JAX package.

`ops/gradient_reversal.py` against `jax.vjp` of JAX's (the forward exact,
the gradient -lambda * g exact in float32 and bfloat16); PoseCNN's domain
head (`fc9`, `domain_score`, gradient reversal) in a training step against
JAX's `compute_losses` (float32, keep 0.5 with JAX's five dropout draws
replayed: domain_score and domain_prob within 1e-5 of their largest
magnitude, domain_label and label_domain exact, every loss term within
1e-5 relative, every gradient within 5e-5 of its largest magnitude, the
small training golden's limits); host batches bit-equal to JAX's for the
GAN minibatch (`data_gan`, `gan_z` drawn after the frames, and the
batches after it) and for the adaptation stream fed in-memory frames;
`restore_params` on a snapshot with the domain head; the refusal of
TRAIN.ADAPT_ROOT; and the adaptation and GAN cfgs through `train_net` and
`test_net` on the CPU at narrow widths.
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
from posecnn_tpu.data import layer as JL
from posecnn_tpu.data import minibatch as JM
from posecnn_tpu.data.toy import toy as JaxToy
from posecnn_tpu.engine.train import TrainHParams as JaxHP
from posecnn_tpu.engine.train import compute_losses as jax_compute_losses
from posecnn_tpu.engine.train import create_train_state as jax_create_train_state
from posecnn_tpu.models.posecnn import PoseCNNConfig as JaxCfg
from posecnn_tpu.models.posecnn import posecnn_forward as jax_forward
from posecnn_tpu.ops.chromatic import chromatic_device
from posecnn_tpu.ops.gradient_reversal import gradient_reversal as jax_gradient_reversal
from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.core import checkpoint as CK
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import init_params_numpy, make_model, param_shapes
from posecnn_torch.data import layer as L
from posecnn_torch.data import minibatch as M
from posecnn_torch.data.toy import toy as Toy
from posecnn_torch.engine import train as T
from posecnn_torch.engine.test import set_float32_precision
from posecnn_torch.models.posecnn import posecnn_forward
from posecnn_torch.ops.gradient_reversal import gradient_reversal
from tests.torch_parity import goldens, t

G = goldens()
CFGS = os.path.join(G.ROOT, "experiments", "cfgs")
ADAPT_CFG = os.path.join(CFGS, "lov_color_sugar_box_adapt.yml")
GAN_CFG = os.path.join(CFGS, "shapenet_single_single_color_gan.yml")
# PoseCNN with the domain head at narrow widths, trained as the adaptation
# cfg trains it (keep 0.5, crop pool, Hough from the heads)
ADAPT_KW = dict(num_classes=22, num_units=8, trunk_scale=0.125, fc_dim=64, is_train=True, keep_prob=0.5,
                adaptation=True, hough_class_slots=4, hough_max_samples=64, hough_center_stride=4,
                hough_refine_window=8, label_threshold=10, hough_pixel_stride=1, skip_pixels=1,
                hough_sampler="approx", use_crop_pool=True)
ADAPT_HP = dict(learning_rate=0.001, momentum=0.9, gamma=0.1, stepsize=80000, weight_reg=0.0001, adapt_weight=0.1)


@pytest.fixture(autouse=True)
def _f32_precision():
    set_float32_precision()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lam", [0.01, 1.0])
def test_gradient_reversal_matches_jax_vjp(dtype, lam):
    """Identity forward; the gradient -lambda * g in g's dtype, exactly as
    `jax.vjp` of JAX's custom_vjp gives it."""
    rng = np.random.RandomState(0)
    x, g = rng.randn(3, 7, 7, 5).astype(np.float32), rng.randn(3, 7, 7, 5).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y, vjp = jax.vjp(lambda a: jax_gradient_reversal(a, lam), jnp.asarray(x, jd))
    (ref,) = vjp(jnp.asarray(g, jd))
    xt = torch.tensor(x, dtype=td, requires_grad=True)
    yt = gradient_reversal(xt, lam)
    yt.backward(torch.tensor(g, dtype=td))
    assert yt.dtype == xt.grad.dtype == td
    np.testing.assert_array_equal(yt.detach().float().numpy(), np.asarray(y.astype(jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def _adapt_batch(kind: str):
    """The small training batch (frames v4/000000-1 at 64x80, chroma, no
    noise): as it is ("real": Hough's rows carry domain 0), or as the
    minibatch builds a batch of adaptation frames ("adaptation": labels -1,
    no centre rows, no GT rows, so Hough's rows carry domain 1)."""
    batch, points, symmetry, extents = G.train_inputs()
    if kind == "adaptation":
        batch["gt_label_2d"] = np.full_like(batch["gt_label_2d"], -1)
        batch["gt_centers"] = np.zeros_like(batch["gt_centers"])
        batch["poses"] = np.zeros_like(batch["poses"])
    return batch, points, symmetry, extents


@pytest.mark.parametrize("kind", ["real", "adaptation"])
def test_domain_head_and_loss_match_jax(kind):
    """One training forward and backward of PoseCNN with the domain head
    (float32) against JAX's compute_losses on the same weights, batch and
    dropout draws, on a batch of real frames and one of adaptation frames:
    the head's outputs, every loss term (loss_domain among them, the mean
    over all R rows at adapt_weight) and every gradient, the reversed one
    into the trunk included."""
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **ADAPT_KW)
    jcfg, jhp = JaxCfg(compute_dtype=jnp.float32, **ADAPT_KW), JaxHP(**ADAPT_HP)
    params = init_params_numpy(4, cfg)
    assert params["fc9"]["weights"].shape == (7 * 7 * 64, 256) and params["domain_score"]["weights"].shape == (256, 2)
    batch, points, symmetry, extents = _adapt_batch(kind)
    rng = jax.random.PRNGKey(7)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    consts = (jnp.asarray(points), jnp.asarray(symmetry), jnp.asarray(extents))

    @jax.jit
    def jax_side(p):
        (_, losses), grads = jax.value_and_grad(jax_compute_losses, has_aux=True)(p, jcfg, jhp, jb, *consts, rng)
        data = chromatic_device(jb["data"].astype(jnp.float32), jb["chroma_dhls"]) - jnp.asarray(
            jhp.pixel_means, jnp.float32).reshape(1, 1, 1, 3)
        out = jax_forward(p, jcfg, data, consts[2], jb["meta_data"], jb["poses"], jb["gt_label_2d"], rng=rng)
        return losses, grads, {k: out[k] for k in ("domain_score", "domain_prob", "domain_label", "label_domain",
                                                   "rois_valid", "poses_pred")}

    losses, grads, ref = jax.tree_util.tree_map(np.asarray, jax_side(jp))
    R = ref["domain_score"].shape[0]
    names = ("dropout/add_score", "dropout/addv", "dropout/fc6", "dropout/fc7", "dropout/fc9")
    shapes = ((2, 8, 10, 8), (2, 8, 10, 128), (R, 64), (R, 64), (R, 256))
    draws = {n: torch.from_numpy(np.array(jax.random.uniform(k, s)))
             for n, k, s in zip(names, jax.random.split(rng, 5), shapes)}
    model = make_model(cfg, params, "cpu")
    bt = T.to_device(batch, "cpu")
    loss, got = T.compute_losses(model, cfg, T.TrainHParams(**ADAPT_HP), bt, t(points), t(symmetry), t(extents),
                                 T.Draws(replay=draws))
    loss.backward()
    with torch.no_grad():
        out = posecnn_forward(model, cfg, T.preprocess(bt["data"], T.TrainHParams(), bt, None), t(extents),
                              bt["meta_data"], gt_poses=bt["poses"], gt_label_2d=bt["gt_label_2d"],
                              draws=T.Draws(replay=draws))
    for k in ("domain_score", "domain_prob", "poses_pred"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=0, atol=1e-5 * np.abs(ref[k]).max(), err_msg=k)
    for k in ("domain_label", "label_domain", "rois_valid"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)
    valid = ref["rois_valid"]
    assert valid.any() and set(ref["label_domain"][valid].tolist()) == {int(kind == "adaptation")}
    assert not ref["label_domain"][~valid].any()  # invalid rows: domain 0, in the loss all the same
    assert sorted(got) == sorted(losses) and "loss_domain" in got
    for k, v in losses.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * abs(float(v)), (k, float(got[k]), float(v))
    for name, p in model.named_parameters():
        layer = name.split(".")[-2]
        g = grads[layer]["weights" if name.endswith("weight") else "biases"]
        g = g.transpose(3, 2, 0, 1) if g.ndim == 4 else g.T
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=5e-5 * max(np.abs(g).max(), 1e-30), err_msg=name)
    assert np.abs(grads["fc9"]["weights"]).max() > 0 and np.abs(grads["domain_score"]["weights"]).max() > 0


def _toy_layers(over: dict, jax_mcfg_over: dict, **layer_kw):
    """(JAX layer, port layer) on toy_train with flipped entries, under
    toy_pose.yml with the TRAIN settings `over`."""
    cfg = C.cfg_replace(C.cfg_from_file(os.path.join(CFGS, "toy_pose.yml")), TRAIN=over)
    mcfg = C.minibatch_cfg(cfg, 4)
    jmcfg = JM.MinibatchConfig(**{f.name: getattr(mcfg, f.name) for f in dataclasses.fields(mcfg)})
    jmcfg = dataclasses.replace(jmcfg, **jax_mcfg_over)
    a, b = JaxToy("train"), Toy("train")
    a.append_flipped_images()
    b.append_flipped_images()
    jkw = {k: v[0] for k, v in layer_kw.items()}
    pkw = {k: v[1] for k, v in layer_kw.items()}
    return (JL.GtSynthesizeLayer(a, jmcfg, ims_per_batch=2, seed=3, **jkw),
            L.GtSynthesizeLayer(b, mcfg, ims_per_batch=2, seed=3, **pkw))


def _assert_batches_equal(ja, pb, n: int) -> list:
    out = []
    for i in range(n):
        x, y = ja.forward(), pb.forward()
        assert sorted(x) == sorted(y), (i, sorted(x), sorted(y))
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and np.array_equal(x[k], y[k]), (i, k)
        out.append(y)
    assert ja.rng.randint(1 << 30) == pb.rng.randint(1 << 30)  # the streams are in step
    return out


def test_gan_host_batches_bit_equal():
    """TRAIN.GAN on toy_pose.yml (COLOR, CHROMATIC and ADD_NOISE): the
    jitter and the noise run on the host, `data_gan` is the jittered image
    / 127.5 - 1 and `gan_z` U(-1, 1) drawn after the frames; 12 batches key
    by key, so each batch's draws follow the last one's `gan_z`."""
    ja, pb = _toy_layers({"GAN": True, "ADD_NOISE": True}, {})
    assert pb.mcfg.gan and pb.mcfg.input_format == "COLOR" and pb.mcfg.device_targets
    ys = _assert_batches_equal(ja, pb, 12)
    y = ys[0]
    assert "chroma_dhls" not in y and "noise_sigma" not in y and y["data"].dtype == np.uint8
    assert y["data_gan"].shape == (2, 96, 128, 3) and y["data_gan"].dtype == np.float32
    assert y["gan_z"].shape == (2, 100) and -1 <= y["gan_z"].min() and y["gan_z"].max() <= 1
    assert all(-1 <= b["data_gan"].min() and b["data_gan"].max() <= 1 for b in ys)


def _adapt_frames(frame_cls, toy):
    """An adaptation source in the manner of tools/train_net.py:212-222:
    a frame drawn from `rng`, unlabelled (no classes, no poses)."""
    def frames(i, rng):
        f = toy.load_frame(int(rng.randint(toy.num_images)))
        h, w = f.color.shape[:2]
        return frame_cls(color=f.color, label=np.zeros((h, w), np.int32), cls_indexes=np.zeros(0, np.float32),
                         poses=np.zeros((3, 4, 0), np.float32), center=np.zeros((0, 2), np.float32),
                         intrinsic_matrix=np.eye(3) * 100)
    return frames


def test_adaptation_stream_bit_equal():
    """The adaptation stream (adapt_ratio 2: a batch of adaptation frames
    with probability 2/3, drawn before the index stream): 16 batches key
    by key against JAX's layer fed the same in-memory frames; an
    adaptation batch has the label -1 everywhere, no centre rows and no
    pose rows."""
    ja, pb = _toy_layers({"ADAPT": True, "ADAPT_RATIO": 2}, {},
                         adapt=(True, True), adapt_ratio=(2, 2),
                         adapt_frames=(_adapt_frames(JM.Frame, JaxToy("train")), _adapt_frames(M.Frame, Toy("train"))))
    ys = _assert_batches_equal(ja, pb, 16)
    adapted = [y for y in ys if (y["gt_label_2d"] == -1).all()]
    assert 0 < len(adapted) < len(ys)
    assert all(not y["gt_centers"].any() and not y["poses"].any() for y in adapted)
    with pytest.raises(ValueError, match="adapt_frames"):
        L.GtSynthesizeLayer(Toy("train"), M.MinibatchConfig(num_classes=4), adapt=True)


def test_restore_params_skips_the_domain_head(tmp_path):
    """A snapshot trained with the domain head: it restores key for key
    into JAX's train state with the head; scored without the head (test
    config), `restore_params` reads every parameter but fc9 and
    domain_score, as JAX's `restore_checkpoint` does into a state without
    them; a leaf the model has and the file lacks still raises."""
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **ADAPT_KW)
    state = T.create_train_state(make_model(cfg, init_params_numpy(2, cfg), "cpu"), T.TrainHParams())
    state.step = 5
    path = CK.save_checkpoint(str(tmp_path), state, 5, prefix="vgg16_fcn_color_sugar_box_adapt")
    jcfg = JaxCfg(compute_dtype=jnp.float32, **ADAPT_KW)
    full = JCK.restore_checkpoint(path, jax_create_train_state(jcfg, JaxHP(), jax.random.PRNGKey(0)))
    flat = JCK._flatten_state({"params": full[0], "opt_state": full[1], "step": full[2]})
    with np.load(path) as d:
        files = {k: d[k] for k in d.files}
    assert set(files) == set(flat) and "['params']['fc9']['weights']" in files
    test_cfg = dataclasses.replace(cfg, adaptation=False, is_train=False)
    shapes = param_shapes(test_cfg)
    assert "fc9" not in shapes and "domain_score" not in shapes
    got = CK.restore_params(path, shapes)
    ref = JCK.restore_checkpoint(path, jax_create_train_state(dataclasses.replace(jcfg, adaptation=False,
                                                                                  is_train=False), JaxHP(),
                                                              jax.random.PRNGKey(1)))[0]
    assert sorted(got) == sorted(k for k in ref if not k.startswith("upscore"))
    for layer, leaves in got.items():
        for leaf, a in leaves.items():
            np.testing.assert_array_equal(a, np.asarray(ref[layer][leaf]), err_msg=f"{layer}/{leaf}")
    make_model(test_cfg, got, "cpu")
    with pytest.raises(ValueError, match="lacks"):
        CK.restore_params(path, {**shapes, "fc10": {"weights": (4, 2)}})


def test_adapt_root_is_refused_and_the_shipped_cfgs_build(tmp_path):
    """As shipped, the adaptation cfg sets no ADAPT_ROOT: JAX's CLI then has
    no adaptation frames and trains the domain head on real frames alone,
    as the port does. A non-empty ADAPT_ROOT builds: its PNG frames are
    read (`utils.png`), and a JPEG among them is refused when the
    adaptation source is built; VGG16GAN is refused for testing
    (TEST.VERTEX_REG_2D False)."""
    from posecnn_torch.train_net import adaptation_source
    from posecnn_torch.utils.png import write_png

    cfg = C.cfg_from_file(ADAPT_CFG)
    assert cfg.TRAIN.ADAPT and not cfg.TRAIN.ADAPT_ROOT and C.unsupported(cfg) == []
    model_cfg, hp = C.train_model_cfg(cfg, 22), C.train_hparams(cfg)
    assert model_cfg.adaptation and model_cfg.adapt_lambda == 0.01 and hp.adapt_weight == cfg.TRAIN.ADAPT_WEIGHT
    real = tmp_path / "real"
    real.mkdir()
    p = tmp_path / "c.yml"
    p.write_text(open(ADAPT_CFG).read().replace("  ADAPT: True\n", f"  ADAPT: True\n  ADAPT_ROOT: {real}\n"))
    assert C.unsupported(C.cfg_from_file(str(p))) == []
    write_png(str(real / "f.png"), np.zeros((8, 8, 3), np.uint8))
    assert adaptation_source(C.cfg_from_file(str(p))) is not None
    (real / "g.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(NotImplementedError, match="g.jpg"):
        adaptation_source(C.cfg_from_file(str(p)))
    gan = C.cfg_from_file(GAN_CFG)
    assert C.minibatch_cfg(gan, 22).gan and not C.train_model_cfg(gan, 22).vertex_reg
    assert C.unsupported(gan) == [] and C.unsupported(gan, train=False) == ["TEST.VERTEX_REG_2D: False"]


def _narrow(monkeypatch):
    """The CLIs' model configs at narrow widths (the trunk at 1/8, fc 64)."""
    for name in ("train_model_cfg", "test_model_cfg"):
        orig = getattr(C, name)
        monkeypatch.setattr(C, name, lambda cfg, n, _f=orig: dataclasses.replace(_f(cfg, n), trunk_scale=0.125,
                                                                                  fc_dim=64))


def test_train_net_and_test_net_adapt_and_gan_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """train_net --cfg lov_color_sugar_box_adapt.yml --imdb lov_syn_val_v4
    --iters 2 --device cpu (narrow widths): loss_domain in the log, finite,
    and the snapshot with fc9 and domain_score; test_net --cfg on it scores
    2 frames without the head. train_net --cfg
    shapenet_single_single_color_gan.yml --iters 2: the label head alone,
    on host batches with the GAN blobs; finite losses."""
    from posecnn_torch import test_net, train_net

    _narrow(monkeypatch)
    out = tmp_path / "adapt"
    assert train_net.main(["--cfg", ADAPT_CFG, "--imdb", "lov_syn_val_v4", "--iters", "2", "--device", "cpu",
                           "--output", str(out)]) == 0
    first = [ln for ln in capsys.readouterr().out.splitlines() if "iter 1/2" in ln][0]
    assert np.isfinite(float(first.split("loss_domain: ")[1].split()[0]))
    snap = out / "vgg16_fcn_color_sugar_box_adapt_iter_2.npz"
    with np.load(snap) as d:
        assert "['params']['domain_score']['weights']" in d.files
    ev = tmp_path / "eval"
    assert test_net.main(["--cfg", ADAPT_CFG, "--imdb", "lov_syn_val_v4", "--max_frames", "2", "--device", "cpu",
                          "--model", str(snap), "--output", str(ev)]) == 0
    assert json.loads((ev / "eval_timing.json").read_text())["frames"] == 2
    gan = tmp_path / "gan"
    assert train_net.main(["--cfg", GAN_CFG, "--imdb", "lov_syn_val_v4", "--iters", "2", "--device", "cpu",
                           "--output", str(gan)]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if "iter 1/2" in ln][0]
    assert np.isfinite(float(line.split("loss_cls: ")[1].split()[0])) and "loss_vertex" not in line
    assert (gan / "vgg16_gan_color_single_iter_2.npz").exists()
