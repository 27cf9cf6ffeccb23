"""The JAX package's public functions that no path of either package calls,
through the port, each against the JAX function on the same numpy inputs:
the losses of `ops/losses.py` (`loss_cross_entropy_steps`,
`loss_quaternion`, `triplet_loss_embedding`, `lifted_structured_loss`),
the one-image `roi_pool` and `crop_pool`, the quaternion helpers (tensor
and numpy), the blob helpers, `se3.transform_points`, the batched pose
errors, `core/profiler.py` (`trace`, `span`), `utils/timer.py`, and
`freeze_dataset` (with the port's `tools/freeze_dataset.py`) on a stand-in
synthetic set.

Tolerances: values within 1e-6 of their largest magnitude (1e-5 where a
float32 sum of hundreds of terms is taken in another order), gradients
within 1e-5 of theirs; the roi pools' values and gradients exact on float32
maps without ties (JAX unjitted: its jitted pool moves the last bin's edge,
ROADMAP Queue 3 item 11); prep_im_for_blob's resize within cv2's float32
INTER_LINEAR limit of `utils/resize.py` (1e-6 of the largest magnitude);
the frozen set's manifest byte for byte and its frames bit for bit.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import t

torch.set_num_threads(1)

TOL, SUM_TOL = 1e-6, 1e-5


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, (what, err)


def _grad_both(port_fn, jax_fn, x, tol=SUM_TOL):
    """Values and gradients (of the sum of the output) of port_fn and jax_fn
    at x (numpy)."""
    xt = t(x).requires_grad_()
    y = port_fn(xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    jy, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    (jg,) = vjp(jnp.ones_like(jy))
    _close(y.detach(), jy, "value", tol)
    _close(g, jg, "gradient", tol)


def test_loss_cross_entropy_steps_and_quaternion_match_jax():
    from posecnn_torch.ops import losses as P
    from posecnn_tpu.ops import losses as J

    rng = np.random.RandomState(0)
    scores = [np.log(np.random.RandomState(i).dirichlet(np.ones(4), (2, 5, 6))).astype(np.float32) for i in range(3)]
    labels = [np.eye(4, dtype=np.float32)[rng.randint(0, 4, (2, 5, 6))] for _ in range(3)]
    labels[2][:] = 0.0  # a step with no labelled pixel counts 0
    got = P.loss_cross_entropy_steps([t(s) for s in scores], [t(lb) for lb in labels])
    _close(got, J.loss_cross_entropy_steps([jnp.asarray(s) for s in scores], [jnp.asarray(lb) for lb in labels]),
           "steps")
    pred, tgt = rng.randn(6, 4).astype(np.float32), rng.randn(6, 4).astype(np.float32)
    w = (rng.rand(6, 4) > 0.3).astype(np.float32)
    _grad_both(lambda x: P.loss_quaternion(x, t(tgt), t(w)),
               lambda x: J.loss_quaternion(x, jnp.asarray(tgt), jnp.asarray(w)), pred)


@pytest.mark.parametrize("loss", ["triplet_loss_embedding", "lifted_structured_loss"])
def test_embedding_losses_match_jax(loss):
    """(N=24, D=8) embeddings of 4 labels, one label alone (an anchor
    without a positive) — value and gradient."""
    from posecnn_torch.ops import losses as P
    from posecnn_tpu.ops import losses as J

    rng = np.random.RandomState(1)
    emb = rng.randn(24, 8).astype(np.float32)
    labels = rng.randint(0, 3, 24).astype(np.int32)
    labels[5] = 7
    _grad_both(lambda x: getattr(P, loss)(x, t(labels), margin=0.5),
               lambda x: getattr(J, loss)(x, jnp.asarray(labels), margin=0.5), emb)


def _pool_inputs():
    rng = np.random.RandomState(2)
    feat = rng.randn(2, 12, 14, 5).astype(np.float32)  # distinct values: no ties
    rois = np.zeros((6, 7), np.float32)
    rois[:, 0] = [0, 1, 1, 0, 1, 0]
    rois[:, 1] = [1, 2, 0, 4, 3, 2]
    rois[:, 2:6] = [[10, 20, 120, 150], [0, 0, 223, 191], [40, 33, 90, 70], [5, 5, 9, 9], [100, 80, 180, 170],
                    [60, 60, 61, 200]]
    return feat, rois


@pytest.mark.parametrize("pool_channel", [False, True])
def test_roi_pool_one_image_matches_jax(pool_channel):
    from posecnn_torch.ops.roi_pool import roi_pool

    J = importlib.import_module("posecnn_tpu.ops.roi_pool")  # the package exports a function of that name

    feat, rois = _pool_inputs()
    with jax.disable_jit():
        _grad_both(lambda f: roi_pool(f, t(rois), 7, 7, 1.0 / 16.0, pool_channel),
                   lambda f: J.roi_pool(f, jnp.asarray(rois), 7, 7, 1.0 / 16.0, pool_channel), feat, tol=0.0)


def test_crop_pool_one_image_matches_jax():
    from posecnn_torch.ops.roi_pool import crop_pool

    J = importlib.import_module("posecnn_tpu.ops.roi_pool")

    feat, rois = _pool_inputs()
    with jax.disable_jit():
        _grad_both(lambda f: crop_pool(f, t(rois), 1.0 / 16.0, 7),
                   lambda f: J.crop_pool(f, jnp.asarray(rois), 1.0 / 16.0, 7), feat, tol=TOL)


def test_quaternion_helpers_match_jax():
    from posecnn_torch.utils import quaternion as P
    from posecnn_torch.utils import quaternion_np as PN
    from posecnn_tpu.utils import quaternion as J
    from posecnn_tpu.utils import quaternion_np as JN

    rng = np.random.RandomState(3)
    q1, q2 = rng.randn(5, 4).astype(np.float32), rng.randn(5, 4).astype(np.float32)
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    pts = rng.randn(5, 7, 3).astype(np.float32)
    _close(P.qmult(t(q1), t(q2)), J.qmult(jnp.asarray(q1), jnp.asarray(q2)), "qmult")
    _close(P.qconj(t(q1)), J.qconj(jnp.asarray(q1)), "qconj")
    _close(P.rotate_points(t(q1), t(pts)), J.rotate_points(jnp.asarray(q1), jnp.asarray(pts)), "rotate_points")
    _close(P.quat_angle(t(q1), t(q2)), J.quat_angle(jnp.asarray(q1), jnp.asarray(q2)), "quat_angle")
    a, b = q1[0].astype(np.float64), (2.0 * q2[0]).astype(np.float64)
    assert np.array_equal(PN.qmult(a, b), JN.qmult(a, b))
    assert np.array_equal(PN.qinverse(b), JN.qinverse(b))
    assert np.allclose(PN.qmult(b, PN.qinverse(b)), [1, 0, 0, 0])


def test_blob_helpers_match_jax():
    """im_list_to_blob (3 channels and 1), prep_im_for_blob on uint8 and on
    float32 (which it mean-subtracts in place in both packages: ROADMAP
    Queue 3 item 56) at a capped and an uncapped scale, unpad_im."""
    from posecnn_torch.utils import blob as P
    from posecnn_tpu.utils import blob as J

    rng = np.random.RandomState(4)
    ims = [rng.randn(7, 9, 3).astype(np.float32), rng.randn(10, 6, 3).astype(np.float32)]
    assert np.array_equal(P.im_list_to_blob(ims, 3), J.im_list_to_blob(ims, 3))
    ones = [im[:, :, 0] for im in ims]
    assert np.array_equal(P.im_list_to_blob(ones, 1), J.im_list_to_blob(ones, 1))
    means = np.array([[[102.9801, 115.9465, 122.7717]]], np.float32)
    im8 = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    for target, cap in ((96, 1000), (96, 100)):
        got, s = P.prep_im_for_blob(im8, means, target, cap)
        ref, rs = J.prep_im_for_blob(im8, means, target, cap)
        assert s == rs and got.shape == ref.shape
        _close(got, ref, f"prep {target} {cap}")
    f32 = im8.astype(np.float32)
    a, b = f32.copy(), f32.copy()
    got, _ = P.prep_im_for_blob(a, means, 48, 1000)
    ref, _ = J.prep_im_for_blob(b, means, 48, 1000)
    assert np.array_equal(a, b) and np.array_equal(a, f32 - means)  # in place, in both
    assert np.array_equal(got, ref)  # scale 1: no resize
    padded = np.pad(rng.randn(13, 21, 2), ((0, 3), (0, 11), (0, 0)))
    assert np.array_equal(P.unpad_im(padded, 16), J.unpad_im(padded, 16))
    assert np.array_equal(P.unpad_im(padded[:, :, 0], 8), J.unpad_im(padded[:, :, 0], 8))


def test_transform_points_and_pose_errors_match_jax():
    from posecnn_torch.utils import pose_error as P
    from posecnn_torch.utils.quaternion_np import quat2mat
    from posecnn_torch.utils.se3 import transform_points
    from posecnn_tpu.utils import pose_error as J
    from posecnn_tpu.utils.se3 import transform_points as jtp

    rng = np.random.RandomState(5)
    R = np.stack([quat2mat(q / np.linalg.norm(q)) for q in rng.randn(3, 4)]).astype(np.float32)
    R2 = np.stack([quat2mat(q / np.linalg.norm(q)) for q in rng.randn(3, 4)]).astype(np.float32)
    tr, tr2 = rng.randn(3, 3).astype(np.float32), rng.randn(3, 3).astype(np.float32)
    pts = (0.05 * rng.randn(3, 40, 3)).astype(np.float32)
    RT = np.concatenate([R, tr[:, :, None]], axis=2)
    assert np.allclose(transform_points(RT, pts), jtp(RT, pts), rtol=0, atol=1e-6)
    _close(transform_points(t(RT), t(pts)), jtp(jnp.asarray(RT), jnp.asarray(pts)), "transform_points (tensors)")
    args = (R, tr, R2, tr2, pts)
    _close(P.add_batched(*map(t, args)), J.add_jax(*map(jnp.asarray, args)), "add")
    _close(P.adi_batched(*map(t, args)), J.adi_jax(*map(jnp.asarray, args)), "adi", SUM_TOL)
    _close(P.re_batched(t(R), t(R2)), J.re_jax(jnp.asarray(R), jnp.asarray(R2)), "re", SUM_TOL)
    _close(P.te_batched(t(tr), t(tr2)), J.te_jax(jnp.asarray(tr), jnp.asarray(tr2)), "te")
    for i in range(3):  # and the numpy metrics of one pose
        assert abs(float(P.add_batched(*(t(a[i]) for a in args))) - P.add(R[i], tr[i], R2[i], tr2[i], pts[i])) < 1e-5


def test_profiler_trace_timer_and_annotate(tmp_path):
    """trace() writes a Chrome trace that holds a span's `posecnn:` range
    (`span` took the place of `annotate`, which named calls in the trace,
    and of `device_timer`, which synchronised to time a block: a recorder
    times the block on the host without a sync); the span keeps the
    block's result, and records nothing outside a trace or a recorder."""
    from posecnn_torch.core import profiler

    def work(x):
        with profiler.span("matmul"):
            return x @ x

    assert not hasattr(profiler, "device_timer") and not hasattr(profiler, "annotate")
    x = torch.randn(64, 64)
    with profiler.trace(str(tmp_path)):
        y = work(x)
    assert torch.equal(y, x @ x)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "posecnn:matmul" for e in events)
    rec = profiler.Recorder()
    with profiler.recording(rec):
        for _ in range(2):
            work(x)
    ms = rec.take()
    assert set(ms) == {"matmul"} and ms["matmul"] > 0 and len(rec.spans) == 0
    assert profiler.span("matmul") is profiler._NULL


def test_timer_and_rate_meter_match_jax(monkeypatch):
    """On one clock (time.time patched to a fixed sequence), Timer and
    RateMeter report what JAX's report."""
    import time

    from posecnn_torch.utils import timer as P
    from posecnn_tpu.utils import timer as J

    got = []
    for mod in (P, J):
        clock = iter([1.0, 1.5, 2.0, 2.25, 10.0, 10.5, 10.75, 11.75])
        monkeypatch.setattr(time, "time", lambda: next(clock))
        tm, rm = mod.Timer(), mod.RateMeter(alpha=0.5)
        tm.tic()
        a = tm.toc()
        tm.tic()
        b = tm.toc(average=False)
        rates = [rm.tick(), rm.tick(2), rm.tick(), rm.tick(4)]
        got.append((a, b, tm.calls, tm.average_time, rates))
    assert got[0] == got[1] and got[0][4][-1] > 0


def test_freeze_dataset_matches_jax(tmp_path):
    """freeze_dataset of a stand-in SyntheticDataset (the toy base, 96x128,
    3 frames of the val split) writes JAX's manifest byte for byte and its
    frames' arrays; the port's tool re-freezes a split (--imdb toy_train
    --base toy_train --num 2: the manifest again JAX's), its --verify
    passes on it and fails on a changed digest."""
    import posecnn_tpu.data.synthetic as JS
    from posecnn_torch.data import synthetic as S
    from posecnn_torch.data.toy import toy as Toy
    from posecnn_torch.tools import freeze_dataset as tool
    from posecnn_tpu.data.toy import toy as JaxToy

    kw = dict(split="val", num_images=3, width=128, height=96, max_objects=3)
    a, b = tmp_path / "port", tmp_path / "jax"
    S.freeze_dataset(S.SyntheticDataset(Toy("train", num_classes=4, num_images=4), **kw), str(a))
    JS.freeze_dataset(JS.SyntheticDataset(JaxToy("train", num_classes=4, num_images=4), **kw), str(b))
    assert (a / "manifest.json").read_bytes() == (b / "manifest.json").read_bytes()
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == ["000000.npz", "000001.npz", "000002.npz",
                                                               "manifest.json"]
    for name in ("000000.npz", "000002.npz"):
        with np.load(a / name) as x, np.load(b / name) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), (name, k)

    out = tmp_path / "tool"
    assert tool.main(["--imdb", "toy_train", "--base", "toy_train", "--num", "2", "--out", str(out)]) == 0
    ref = tmp_path / "tool_jax"
    JS.freeze_dataset(JS.SyntheticDataset(JaxToy("train"), split="val", num_images=2), str(ref))
    assert (out / "manifest.json").read_bytes() == (ref / "manifest.json").read_bytes()
    assert tool.main(["--verify", str(out), "--base", "toy_train"]) == 0
    manifest = json.loads((out / "manifest.json").read_text())
    manifest["frames"][1] = "0" * 64
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1))
    assert tool.main(["--verify", str(out), "--base", "toy_train"]) == 1


@pytest.mark.parametrize("k,stride,side", [(3, 2, 9), (2, 2, 8), (3, 1, 7)])
def test_avg_pool_matches_jax(k, stride, side):
    """`layers.avg_pool` (SAME, the padding not counted) against JAX's."""
    from posecnn_torch.models.layers import avg_pool
    from posecnn_tpu.models import layers as JL

    x = np.random.RandomState(side).randn(2, side, side + 3, 4).astype(np.float32)
    _close(avg_pool(t(x), k, stride), JL.avg_pool(jnp.asarray(x), k, stride), "avg_pool")


def test_small_helpers_match_jax():
    """The registries (`register`, `list_networks`), `cfg_fresh`,
    `ensure_dir`, `bank_nbytes` and `create_det_train_state` as JAX's."""
    from posecnn_torch.core import config as C
    from posecnn_torch.data import factory as DF
    from posecnn_torch.data.device_bank import bank_nbytes
    from posecnn_torch.engine.train import TrainHParams, create_det_train_state
    from posecnn_torch.models import factory as MF
    from posecnn_torch.models.detection import DetConfig
    from posecnn_tpu.core import config as JC
    from posecnn_tpu.data.device_bank import bank_nbytes as jax_nbytes
    from posecnn_tpu.models import factory as JMF

    assert MF.list_networks() == JMF.list_networks()
    MF.register("tiny", len, max)
    try:
        assert MF.get_network("tiny") == (len, max) and "tiny" in MF.list_networks()
    finally:
        MF._REGISTERED.clear()
    with pytest.raises(ValueError, match="built in"):  # a built-in name has one lookup
        MF.register("vgg16_full", len, max)
    DF.register("tiny_set", lambda: "made")
    try:
        assert DF.get_imdb("tiny_set") == "made"
    finally:
        del DF._DATASETS["tiny_set"]
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments", "cfgs",
                        "toy_pose.yml")
    a, b = C.cfg_fresh(path), JC.cfg_fresh(path)
    assert a.TRAIN.NUM_UNITS == b.TRAIN.NUM_UNITS == 16 and a.EXP_DIR == b.EXP_DIR and C.cfg_fresh().EXP_DIR == \
        JC.cfg_fresh().EXP_DIR
    bank = {"data": np.zeros((2, 4, 5, 3), np.uint8), "meta_data": np.zeros((2, 48), np.float32)}
    assert bank_nbytes(bank) == jax_nbytes(bank) == bank_nbytes({k: t(v) for k, v in bank.items()})
    state = create_det_train_state(DetConfig(num_classes=3, fc_dim=64, trunk_scale=0.125), TrainHParams(), 0)
    assert state.step == 0 and all(float(tr.abs().sum()) == 0 for tr in state.optimizer.trace)
