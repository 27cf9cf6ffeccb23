"""The detection network (NETWORK VGG16DET) of the port against the JAX
package.

Held exactly: the box functions on numpy arrays, IoUs and clipping on
tensors (the box transforms within 2 ulps: torch's exp and log against
XLA's) and the clip gradient on a bound, the anchors, the NMS keep mask
(random integer boxes with equal scores and IoUs exactly at the 0.3 and
0.7 thresholds), the RPN layers' labels, kept rows and ranks with JAX's
uniforms replayed (targets and weights within 1e-6), `proposal_layer`'s
scores and rows on bf16-rounded scores with ties (its boxes within 2e-5
px), `postprocess_det`, `DetectionEvaluator` and `gt_boxes_from_poses`.

The network at float32 on the same weights (the numpy init carried across
by the converter) and JAX's draws replayed, a 192x192 frame (the smallest
side where anchors of scale 8 lie inside the image), the trunk at 1/4
width, fc 64, 4 classes: every output within 1e-5 of its largest
magnitude (integers exact); one training step's losses within 1e-5
relative and the gradients of rpn_bbox_pred, conv_rpn, fc6 and conv1_2
within `STEP_GRAD_LIMITS` (fc6 1e-4 of its largest magnitude; the others
reach the loss through the crops' roi coordinates, where the 2x2 max
turns rounding into jumps: see there). The proposal path carries the
gradient of the box deltas into the crops and the box targets, as in JAX:
on identical inputs its gradient is held within 1e-4.

Snapshots load both ways; train_net and test_net --cfg lov_det.yml run
on the CPU at narrow widths on the toy dataset.
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
from posecnn_tpu.engine import test as JT
from posecnn_tpu.engine.train import TrainHParams as JaxHP
from posecnn_tpu.engine.train import make_det_train_step as jax_det_step
from posecnn_tpu.engine.train import make_optimizer
from posecnn_tpu.models import detection as JD
from posecnn_tpu.ops import bbox as JB
from posecnn_tpu.ops import nms as JN
from posecnn_tpu.ops import rpn as JR
from posecnn_torch.core import checkpoint as CK
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import params_from_numpy, params_to_numpy, param_shapes
from posecnn_torch.data.factory import get_imdb
from posecnn_torch.engine import test as PT
from posecnn_torch.engine import train as T
from posecnn_torch.models import detection as D
from posecnn_torch.ops import bbox as B
from posecnn_torch.ops import nms as N
from posecnn_torch.ops import rpn as R

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DET_CFG = os.path.join(ROOT, "experiments", "cfgs", "lov_det.yml")
NARROW = dict(trunk_scale=0.25, fc_dim=64, num_classes=4)
HW = 192

torch.set_num_threads(2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _jax_params(p):
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in p.items()}


def _boxes(rng, n, size=100.0, integer=False):
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * size * 0.5 + 1
    b = np.concatenate([xy, xy + wh], axis=1)
    return (np.round(b) if integer else b).astype(np.float32)


# ------------------------------------------------------------------ box ops


def test_bbox_functions_match_jax():
    """bbox_overlaps and clip_boxes on torch tensors equal JAX's bit for
    bit; bbox_transform and bbox_transform_inv within 2 float32 ulps (torch's
    log and exp against XLA's, each 1 ulp apart at most); on numpy arrays all four are JAX's own
    numpy arithmetic, bit for bit."""
    rng = np.random.RandomState(0)
    a, q = _boxes(rng, 40), _boxes(rng, 7)
    deltas = (rng.randn(40, 12) * 0.3).astype(np.float32)
    cases = [
        ("overlaps", lambda m, x, y: m.bbox_overlaps(x, y), (a, q)),
        ("transform", lambda m, x, y: m.bbox_transform(x, y), (a, _boxes(rng, 40))),
        ("transform_inv", lambda m, x, y: m.bbox_transform_inv(x, y), (a, deltas)),
        ("clip", lambda m, x, y: m.clip_boxes(x, (60, 80)), (rng.randn(40, 12).astype(np.float32) * 60, None)),
    ]
    for name, f, (x, y) in cases:
        ref = np.asarray(f(JB, jnp.asarray(x), None if y is None else jnp.asarray(y)))
        got = f(B, _t(x), None if y is None else _t(y)).numpy()
        if name in ("transform", "transform_inv"):
            np.testing.assert_array_max_ulp(got, ref, maxulp=2)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
        np.testing.assert_array_equal(f(B, x, y), f(JB, x, y), err_msg=name + " numpy")


def test_clip_boxes_gradient_on_a_bound_matches_jax():
    """jnp.clip splits the gradient in half at a coordinate exactly on a
    bound; the port's clip does the same (torch.clamp would pass all)."""
    x = np.array([[0.0, 5.0, 79.0, 59.0], [-3.0, 2.0, 90.0, 10.0]], np.float32)
    w = np.arange(1, 9, dtype=np.float32).reshape(2, 4)
    ref = jax.grad(lambda b: jnp.sum(JB.clip_boxes(b, (60, 80)) * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (B.clip_boxes(xt, (60, 80)) * _t(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
    assert xt.grad[0, 0] == 0.5  # a coordinate on the lower bound


def test_anchors_match_jax():
    for ratios, scales in (((0.5, 1, 2), (8, 16, 32)), ((1,), (4, 8))):
        base = R.generate_anchors(16, ratios, scales)
        np.testing.assert_array_equal(base, JR.generate_anchors(16, ratios, scales))
        np.testing.assert_array_equal(R.shifted_anchors(5, 7, 16, base), JR.shifted_anchors(5, 7, 16, base))


# ---------------------------------------------------------------------- NMS


def _nms_boxes(seed: int):
    """Random integer boxes, scores with many ties (bf16-rounded), and pairs
    whose IoU is exactly 0.7 and 0.3 (areas 100 against 70 and 30)."""
    rng = np.random.RandomState(seed)
    b = _boxes(rng, 300, size=60.0, integer=True)
    s = np.round(rng.rand(300) * 16) / 16
    exact = np.array([[0, 0, 9, 9], [0, 0, 9, 6], [0, 0, 9, 2], [20, 20, 29, 29], [20, 20, 29, 26],
                      [40, 40, 49, 49], [40, 40, 49, 42]], np.float32)
    b = np.concatenate([exact, b]).astype(np.float32)
    s = np.concatenate([[0.9, 0.8, 0.8, 0.7, 0.7, 0.6, 0.6], s]).astype(np.float32)
    return b, s


@pytest.mark.parametrize("thresh", [0.3, 0.7])
@pytest.mark.parametrize("seed", [0, 1])
def test_nms_keep_matches_nms_jax(thresh, seed):
    b, s = _nms_boxes(seed)
    ref = np.asarray(JN.nms_jax(jnp.asarray(b), jnp.asarray(s), thresh))
    got = N.nms_keep(_t(b), _t(s), thresh).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(got)
    # the exact-IoU pairs: equal to the threshold keeps the box
    ious = np.asarray(JB.bbox_overlaps(b[:7], b[:7]))
    assert ious[0, 1] == np.float32(0.7) and ious[0, 2] == np.float32(0.3)
    order = np.argsort(-s, kind="stable")
    np.testing.assert_array_equal(N.nms_keep_sorted(_t(b[order]), thresh).numpy(), ref[order])


def _nonfinite_boxes(boxes: np.ndarray) -> np.ndarray:
    """Boxes with NaN and infinite coordinates among the first rows, as a
    diverged network's proposals have them."""
    b = boxes.copy()
    b[3, 0] = np.nan
    b[5] = np.nan
    b[8, 2] = np.inf
    b[11, 1] = -np.inf
    b[13, 2:] = np.inf
    b[17, :2] = np.inf
    return b


@pytest.mark.parametrize("thresh", [0.3, 0.7])
def test_nms_keep_matches_nms_jax_on_nonfinite_boxes(thresh):
    """NaN and infinite coordinates: every IoU with them decides as
    jnp.minimum/maximum make it decide (NaN never suppresses)."""
    b, s = _nms_boxes(2)
    b = _nonfinite_boxes(b)
    ref = np.asarray(JN.nms_jax(jnp.asarray(b), jnp.asarray(s), thresh))
    np.testing.assert_array_equal(N.nms_keep(_t(b), _t(s), thresh).numpy(), ref)
    order = np.argsort(-s, kind="stable")
    np.testing.assert_array_equal(N.nms_keep_sorted(_t(b[order]), thresh).numpy(), ref[order])


def test_nms_keep_sorted_checks_its_input():
    with pytest.raises(ValueError):
        N.nms_keep_sorted(torch.zeros((4, 5)), 0.5)
    with pytest.raises(ValueError):
        N.nms_keep_sorted(torch.zeros((4, 4), dtype=torch.float64), 0.5)
    assert N.nms_keep_sorted(torch.zeros((0, 4)), 0.5).shape == (0,)


# --------------------------------------------------------------- RPN layers


def _draws(**arrays):
    return T.Draws(replay={k: _t(v) for k, v in arrays.items()})


def test_anchor_target_layer_matches_jax():
    """JAX's uniforms (k1, k2 of split(key)) replayed: labels exact (fg and
    bg kept by the same ranks), targets and weights within 1e-6."""
    base = R.generate_anchors()
    anchors = R.shifted_anchors(16, 16, 16, base)
    gt = np.array([[60, 60, 180, 180, 2], [20, 100, 120, 230, 1], [0, 0, 0, 0, 0]], np.float32)
    key = jax.random.PRNGKey(3)
    ref = JR.anchor_target_layer(key, jnp.asarray(anchors), jnp.asarray(gt), (256, 256), rpn_batchsize=64)
    k1, k2 = jax.random.split(key)
    A = anchors.shape[0]
    d = _draws(**{"rpn/anchor_fg": jax.random.uniform(k1, (A,)), "rpn/anchor_bg": jax.random.uniform(k2, (A,))})
    got = R.anchor_target_layer(d, _t(anchors), _t(gt), (256, 256), rpn_batchsize=64)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert (got.labels == 1).sum() >= 2 and (got.labels == 0).sum() > 0
    for k in ("bbox_targets", "bbox_inside_weights", "bbox_outside_weights"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_proposal_layer_matches_jax_on_tied_scores():
    """bf16-rounded fg probabilities (many ties: lax.top_k puts the lower
    index first) and deltas: the scores, and so the rows kept and their
    order, exact; the boxes within 2e-5 px (the decode's exp: a few ulps
    of the image's size)."""
    A, Hf, Wf = 9, 6, 7
    rng = np.random.RandomState(1)
    anchors = R.shifted_anchors(Hf, Wf, 16, R.generate_anchors())
    logits = jnp.asarray(rng.randn(Hf, Wf, A, 2).astype(np.float32)).astype(jnp.bfloat16).astype(jnp.float32)
    prob = jax.nn.softmax(logits, axis=-1)
    prob = np.asarray(jnp.concatenate([prob[..., 0], prob[..., 1]], axis=-1).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    assert len(np.unique(prob[..., A:])) < prob[..., A:].size  # ties
    deltas = (rng.randn(Hf, Wf, 4 * A) * 0.2).astype(np.float32)
    for pre, post, thr in ((6000, 300, 0.7), (200, 50, 0.5)):
        ref = JR.proposal_layer(jnp.asarray(prob), jnp.asarray(deltas), jnp.asarray(anchors), (96, 112), A,
                                pre_nms_top_n=pre, post_nms_top_n=post, nms_thresh=thr)
        got = R.proposal_layer(_t(prob), _t(deltas), _t(anchors), (96, 112), A, pre_nms_top_n=pre,
                               post_nms_top_n=post, nms_thresh=thr)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=2e-5)
        np.testing.assert_array_equal(got[0].numpy() == 0, np.asarray(ref[0]) == 0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        assert (got[1] > 0).sum() > 10


def test_proposal_target_layer_matches_jax():
    rng = np.random.RandomState(2)
    n = 300
    boxes = _boxes(rng, n, size=150.0)
    boxes[:40] = np.array([50, 50, 120, 130], np.float32) + rng.randn(40, 4).astype(np.float32) * 6
    rois = np.concatenate([np.zeros((n, 1), np.float32), boxes], axis=1)
    rois[250:] = 0  # zero rows past the survivors, as proposal_layer leaves them
    scores = rng.rand(n).astype(np.float32)
    gt = np.array([[50, 50, 120, 130, 3], [10, 10, 60, 40, 1], [0, 0, 0, 0, 0]], np.float32)
    poses = np.zeros((3, 13), np.float32)
    poses[:2, 6:10] = rng.randn(2, 4)
    key = jax.random.PRNGKey(5)
    ref = JR.proposal_target_layer(key, jnp.asarray(rois), jnp.asarray(scores), jnp.asarray(gt), jnp.asarray(poses),
                                   4, batch_size=64)
    k1, k2 = jax.random.split(key)
    d = _draws(**{"rpn/target_fg": jax.random.uniform(k1, (n,)), "rpn/target_bg": jax.random.uniform(k2, (n,))})
    got = R.proposal_target_layer(d, _t(rois), _t(scores), _t(gt), _t(poses), 4, batch_size=64)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert (got.labels > 0).sum() >= 5
    for k in ("rois", "scores", "bbox_targets", "bbox_inside_weights", "bbox_outside_weights", "poses_target",
              "poses_weight"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), rtol=0, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------------ the network


def _det_setup(train: bool = True):
    cfg = D.DetConfig(compute_dtype=torch.float32, is_train=train, **NARROW)
    jcfg = JD.DetConfig(compute_dtype=jnp.float32, is_train=train, num_classes=4, fc_dim=64)
    params = D.init_vgg16_det_params_numpy(7, cfg)
    rng = np.random.RandomState(4)
    raw = (rng.rand(1, HW, HW, 3) * 255).astype(np.uint8)
    gt = np.zeros((6, 5), np.float32)
    gt[:3] = [[40, 30, 150, 160, 1], [100, 20, 180, 90, 3], [10, 120, 70, 185, 2]]
    poses = np.zeros((6, 13), np.float32)
    poses[:3, 1] = gt[:3, 4]
    q = rng.randn(3, 4)
    poses[:3, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    poses[:3, 10:] = [[0.1, 0.0, 1.0], [0.0, 0.1, 1.2], [-0.1, 0.0, 0.9]]
    return cfg, jcfg, params, raw, gt, poses


def _jax_draws(rng, n_anchors: int, cfg) -> dict:
    """JAX's draws in vgg16_det_forward under `rng`, by the port's names:
    split(rng, 4) -> (r_at, r_pt, r_d6, r_d7), each RPN layer splitting
    its own in two; bernoulli(key, p, shape) is uniform(key, shape) < p."""
    r_at, r_pt, r_d6, r_d7 = jax.random.split(rng, 4)
    a1, a2 = jax.random.split(r_at)
    p1, p2 = jax.random.split(r_pt)
    R_, fc = cfg.roi_batch_size, cfg.fc_dim
    u6 = jax.random.uniform(r_d6, (R_, fc))
    assert bool(jnp.all(jax.random.bernoulli(r_d6, 0.5, (R_, fc)) == (u6 < 0.5)))
    return {"rpn/anchor_fg": jax.random.uniform(a1, (n_anchors,)),
            "rpn/anchor_bg": jax.random.uniform(a2, (n_anchors,)),
            "rpn/target_fg": jax.random.uniform(p1, (cfg.rpn_post_nms_top_n,)),
            "rpn/target_bg": jax.random.uniform(p2, (cfg.rpn_post_nms_top_n,)),
            "dropout/fc6": u6, "dropout/fc7": jax.random.uniform(r_d7, (R_, fc))}


def _close(got, ref, name, tol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(got, ref, err_msg=name)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("train", [True, False])
def test_det_forward_matches_jax(train):
    cfg, jcfg, params, raw, gt, poses = _det_setup(train)
    model = D.make_det_model(cfg, params, "cpu")
    data = raw.astype(np.float32) - np.array([102.9801, 115.9465, 122.7717], np.float32)
    rng = jax.random.PRNGKey(11)
    n_anchors = (HW // 16) ** 2 * 9
    draws = _draws(**_jax_draws(rng, n_anchors, cfg)) if train else None
    with torch.no_grad():
        out = D.vgg16_det_forward(model, cfg, _t(data), _t(gt) if train else None, _t(poses) if train else None,
                                  draws=draws)
    with jax.disable_jit():
        ref = JD.vgg16_det_forward(_jax_params(params), jcfg, jnp.asarray(data), jnp.asarray(gt) if train else None,
                                   jnp.asarray(poses) if train else None, rng=rng)
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k].numpy(), ref[k], k)
    if train:
        assert (out["labels"] > 0).sum() >= 3 and (out["rpn_labels"] == 1).sum() >= 3
    assert out["rois_raw"][:, 3].max() > 0


def _det_step_both():
    """One training step of each package from the same weights, batch and
    draws: (JAX's losses, JAX's gradients as a state_dict (its momentum
    trace after one step from zero), the port's losses, the port's state)."""
    cfg, jcfg, params, raw, gt, poses = _det_setup(True)
    hp = T.TrainHParams(pose_w=1.0)
    rng_np = np.random.RandomState(9)
    points = (rng_np.randn(4, 64, 3) * 0.05).astype(np.float32)
    symmetry = np.zeros(4, np.float32)
    batch = {"data": raw, "gt_boxes": gt, "poses": poses}
    rng = jax.random.PRNGKey(12)
    jstate = (_jax_params(params), make_optimizer(JaxHP()).init(_jax_params(params)), jnp.asarray(0, jnp.int32))
    with jax.disable_jit():
        jstate2, jl = jax_det_step(jcfg, JaxHP(), points, symmetry)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    state = T.create_train_state(D.make_det_model(cfg, params, "cpu"), hp)
    step = T.make_det_train_step(cfg, hp, _t(points), _t(symmetry))
    n_anchors = (HW // 16) ** 2 * 9
    got = step(state, T.to_device(batch, "cpu"), _draws(**_jax_draws(rng, n_anchors, cfg)))
    trace = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate2[1][0].trace))
    return jl, trace, got, state


def _grad_err(state, trace, k):
    ref = trace[k].numpy()
    assert np.abs(ref).max() > 0, k
    return float(np.abs(dict(state.model.named_parameters())[k].grad.numpy() - ref).max() / np.abs(ref).max())


# the full step's gradients against JAX's, as |error| over the largest
# magnitude. fc6 reads the pooled crops; the proposal path (rpn_bbox_pred,
# conv_rpn) and the trunk (conv1_2) reach the loss through the crops' roi
# coordinates too, and there a 2x2 max over bilinear samples of a map with
# ReLU zeros makes the roi gradient jump: rois 1e-5 px apart (the two
# packages' conv_rpn rounding) move it by 1e-3 of its largest magnitude,
# and swapping JAX's conv5 for the port's by 4e-3. Measured: rpn_bbox_pred
# 8.9e-4, conv_rpn 9.9e-5, fc6 4.1e-7, conv1_2 1.1e-4 (1.1e-4 and 4.5e-5
# for the first two with both heads on JAX's conv5).
# `test_det_proposal_path_gradients_match_jax` holds the proposal path's
# gradient at 1e-4 on identical inputs.
STEP_GRAD_LIMITS = {"rpn_bbox_pred.weight": 5e-3, "conv_rpn.weight": 1e-3, "fc6.weight": 1e-4,
                    "trunk.conv1_2.weight": 1e-3}


def test_det_step_matches_jax():
    """One training step: the six loss terms within 1e-5 relative, the lr,
    the step counter, and the gradients within `STEP_GRAD_LIMITS`; the RCNN
    box loss alone gives rpn_bbox_pred a gradient (JAX's proposals are not
    under stop_gradient, and neither are the port's)."""
    jl, trace, got, state = _det_step_both()
    for k in ("loss_rpn_cls", "loss_rpn_box", "loss_cls", "loss_box", "loss_pose", "loss_regu", "loss"):
        ref = float(jl[k])
        assert abs(float(got[k]) - ref) <= 1e-5 * abs(ref) + 1e-12, (k, float(got[k]), ref)
    assert float(got["loss_rpn_box"]) > 0 and float(got["loss_box"]) > 0
    assert float(got["lr"]) == pytest.approx(float(jl["lr"]), rel=1e-7)
    for k, lim in STEP_GRAD_LIMITS.items():
        assert _grad_err(state, trace, k) <= lim, (k, _grad_err(state, trace, k))
    assert state.step == 1
    cfg, jcfg, params, raw, gt, poses = _det_setup(True)
    model = D.make_det_model(cfg, params, "cpu")
    data = raw.astype(np.float32) - np.array([102.9801, 115.9465, 122.7717], np.float32)
    out = D.vgg16_det_forward(model, cfg, _t(data), _t(gt), _t(poses),
                              draws=_draws(**_jax_draws(jax.random.PRNGKey(12), (HW // 16) ** 2 * 9, cfg)))
    from posecnn_torch.ops.losses import smooth_l1_loss

    smooth_l1_loss(out["bbox_pred"], out["bbox_targets"], out["bbox_inside_weights"],
                   out["bbox_outside_weights"]).backward()
    assert float(model.rpn_bbox_pred.weight.grad.norm()) > 0


def test_det_proposal_path_gradients_match_jax():
    """The gradient of the proposal path on identical inputs: the RPN box
    deltas through proposal_layer (decode, clip, top-k, NMS, scatter),
    proposal_target_layer (JAX's uniforms), the crop pool of one conv5 map
    with ReLU zeros and a linear box head, into the box loss with its
    regression targets: d loss / d deltas within 1e-4 of its largest
    magnitude (measured 1.2e-7)."""
    from posecnn_tpu.ops.losses import smooth_l1_loss as jax_sl1
    from posecnn_tpu.ops.roi_pool import crop_pool_batched as jax_crop
    from posecnn_torch.ops.losses import smooth_l1_loss
    from posecnn_torch.ops.roi_pool import crop_pool_batched

    rng = np.random.RandomState(0)
    A, Hf, C_ = 9, 12, 4
    anchors = R.shifted_anchors(Hf, Hf, 16, R.generate_anchors())
    prob = rng.rand(Hf, Hf, 2 * A).astype(np.float32)
    deltas = (rng.randn(Hf, Hf, 4 * A) * 0.1).astype(np.float32)
    conv5 = np.maximum(rng.randn(1, Hf, Hf, 16), 0).astype(np.float32)
    w = (rng.randn(49 * 16, 4 * C_) * 0.01).astype(np.float32)
    gt = np.array([[40, 30, 150, 160, 1], [100, 20, 180, 90, 3], [0, 0, 0, 0, 0]], np.float32)
    poses = np.zeros((3, 13), np.float32)
    key = jax.random.PRNGKey(1)
    k1, k2 = jax.random.split(key)
    draws = _draws(**{"rpn/target_fg": jax.random.uniform(k1, (300,)), "rpn/target_bg": jax.random.uniform(k2, (300,))})

    def head(m, crop, sl1, rois, scores, pt_fn, cat, zeros):
        pt = pt_fn(rois, scores)
        r = pt.rois
        z = zeros((r.shape[0], 1))
        p5 = crop(conv5_of(m), cat([r[:, :1], z, r[:, 1:5], z], 1)[None], 1 / 16, 7)[0]
        bp = p5.reshape(p5.shape[0], -1) @ w_of(m)
        return sl1(bp, pt.bbox_targets, pt.bbox_inside_weights, pt.bbox_outside_weights) + (bp ** 2).sum() * 1e-3, pt

    def conv5_of(m):
        return jnp.asarray(conv5) if m == "jax" else _t(conv5)

    def w_of(m):
        return jnp.asarray(w) if m == "jax" else _t(w)

    def jax_loss(d):
        rois, sc = JR.proposal_layer(jnp.asarray(prob), d, jnp.asarray(anchors), (192, 192), A)
        return head("jax", jax_crop, jax_sl1, rois, sc,
                    lambda r, s: JR.proposal_target_layer(key, r, s, jnp.asarray(gt), jnp.asarray(poses), C_),
                    lambda xs, axis: jnp.concatenate(xs, axis=axis), jnp.zeros)[0]

    with jax.disable_jit():
        ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(deltas)))
    d = _t(deltas).requires_grad_(True)
    rois, sc = R.proposal_layer(_t(prob), d, _t(anchors), (192, 192), A)
    loss, pt = head("port", crop_pool_batched, smooth_l1_loss, rois, sc,
                    lambda r, s: R.proposal_target_layer(draws, r, s, _t(gt), _t(poses), C_),
                    lambda xs, axis: torch.cat(xs, dim=axis), torch.zeros)
    loss.backward()
    assert (pt.labels > 0).sum() >= 5
    err = np.abs(d.grad.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, err


def test_det_snapshots_load_both_ways(tmp_path):
    """A port snapshot restores in JAX into a 3-tuple train state (key for
    key, value for value; the unclipped trace at ['opt_state'][0].trace),
    and a JAX snapshot loads in the port."""
    cfg, jcfg, params, raw, gt, poses = _det_setup(True)
    hp = T.TrainHParams()
    state = T.create_train_state(D.make_det_model(cfg, params, "cpu"), hp)
    for p, tr in zip(state.optimizer.params, state.optimizer.trace):
        tr.copy_(torch.randn_like(p))
    state.step = 5
    path = CK.save_checkpoint(str(tmp_path / "port"), state, 5, prefix="vgg16_det")
    jparams = _jax_params(params)
    jstate = (jparams, make_optimizer(JaxHP()).init(jparams), jnp.asarray(0, jnp.int32))
    restored = JCK.restore_checkpoint(path, jstate)
    flat = JCK._flatten_state({"params": restored[0], "opt_state": restored[1], "step": restored[2]})
    with np.load(path) as d:
        files = {k: d[k] for k in d.files}
    assert set(files) == set(flat) and int(restored[2]) == 5
    assert any(k.startswith("['opt_state'][0].trace") for k in files)
    for k, v in files.items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v, err_msg=k)
    # JAX -> port (the step counter is the state's; the file name's is 7)
    jpath = JCK.save_checkpoint(str(tmp_path / "jax"), restored, 7, prefix="vgg16_det")
    state2 = T.create_train_state(D.make_det_model(cfg, D.init_vgg16_det_params_numpy(1, cfg), "cpu"), hp)
    CK.restore_checkpoint(jpath, state2)
    assert state2.step == 5 and jpath.endswith("vgg16_det_iter_7.npz")
    for (k, v), v2 in zip(state.model.state_dict().items(), state2.model.state_dict().values()):
        assert torch.equal(v, v2), k
    for a, b in zip(state.optimizer.trace, state2.optimizer.trace):
        assert torch.equal(a, b)
    # test_net --model reads every parameter of the model at its shape
    got = CK.restore_params(jpath, param_shapes(cfg))
    assert set(got) == set(params_to_numpy(state.model.state_dict()))


# ----------------------------------------------------- evaluation helpers


def test_postprocess_det_matches_jax():
    rng = np.random.RandomState(6)
    C_ = 5
    rois = np.concatenate([np.zeros((60, 1)), _boxes(rng, 60, 120.0)], axis=1).astype(np.float32)
    logits = rng.randn(60, C_).astype(np.float32) * 2
    out = {"rois": rois, "cls_prob": np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1)),
           "bbox_pred": (rng.randn(60, 4 * C_) * 0.2).astype(np.float32),
           "poses_tanh": np.tanh(rng.randn(60, 4 * C_)).astype(np.float32)}
    for nms_t, reg in ((0.3, True), (0.5, False)):
        ref = JT.postprocess_det(out, C_, (130, 150), nms_threshold=nms_t, bbox_reg=reg)
        got = PT.postprocess_det(out, C_, (130, 150), nms_threshold=nms_t, bbox_reg=reg)
        np.testing.assert_array_equal(got, ref)
        assert len(got) > 5


def test_detection_evaluator_and_gt_boxes_match_jax():
    """gt_boxes_from_poses on the frozen frames (the port's own copy of
    project_box_corners) and the evaluator's AP on detections jittered
    around them, with misses, duplicates and a label-map frame."""
    ds = get_imdb("lov_syn_val_v4")
    rng = np.random.RandomState(8)
    je, pe = JT.DetectionEvaluator(ds.classes), PT.DetectionEvaluator(ds.classes)
    for i in range(6):
        fr = ds.load_frame(i)
        gtb = PT.gt_boxes_from_poses(fr, ds._extents)
        np.testing.assert_array_equal(gtb, JT.gt_boxes_from_poses(fr, ds._extents))
        assert len(gtb) > 0
        dets = np.zeros((2 * len(gtb), 10), np.float32)
        dets[:, 0] = np.tile(gtb[:, 0], 2)
        dets[:, 1:5] = np.tile(gtb[:, 1:5], (2, 1)) + rng.randn(2 * len(gtb), 4) * 8
        dets[:, 5] = rng.rand(2 * len(gtb))
        dets = dets[rng.rand(len(dets)) < 0.8]
        label = fr.label if i == 5 else None
        je.add_frame(dets, gt_label=label, gt_boxes=None if i == 5 else gtb)
        pe.add_frame(dets, gt_label=label, gt_boxes=None if i == 5 else gtb)
    ref, got = je.summary(), pe.summary()
    assert got == ref and 0 < got["mAP@0.5"] < 1


# ---------------------------------------------------------------- the CLIs


def _narrow(monkeypatch):
    orig = C.det_model_cfg
    monkeypatch.setattr(C, "det_model_cfg", lambda cfg, n, train=True: dataclasses.replace(
        orig(cfg, n, train), trunk_scale=0.125, fc_dim=64))


def test_det_train_net_and_test_net_cli_on_cpu(tmp_path, monkeypatch):
    """train_net --cfg lov_det.yml --imdb toy_train --iters 2 (narrow): the
    snapshot at the last step (the unclipped trace), train_timing.json;
    test_net --cfg lov_det.yml on that snapshot writes eval_summary.json
    with mAP@0.5 and eval_timing.json; --resume is refused, as the JAX
    trainer has none."""
    from posecnn_torch import test_net, train_net

    _narrow(monkeypatch)
    out = tmp_path / "train"
    assert train_net.main(["--cfg", DET_CFG, "--imdb", "toy_train", "--iters", "2", "--device", "cpu",
                           "--output", str(out)]) == 0
    snap = out / "vgg16_det_color_pose_iter_2.npz"
    with np.load(snap) as d:
        assert int(d["['step']"]) == 2 and "['opt_state'][0].trace['fc6']['weights']" in d.files
    timing = json.loads((out / "train_timing.json").read_text())
    assert timing["end_step"] == 2 and len(timing["ms"]["step"]) == 2 and "nms" in timing["launches"]
    ev = tmp_path / "eval"
    assert test_net.main(["--cfg", DET_CFG, "--imdb", "toy_val", "--max_frames", "2", "--device", "cpu",
                          "--model", str(snap), "--output", str(ev)]) == 0
    summary = json.loads((ev / "eval_summary.json").read_text())
    assert set(summary) == {"ap_per_class", "mAP@0.5"} and 0 <= summary["mAP@0.5"] <= 1
    timing = json.loads((ev / "eval_timing.json").read_text())
    assert timing["frames"] == 2 and set(timing["ms"]) >= {"infer", "postprocess", "evaluator", "frame"}
    with pytest.raises(NotImplementedError, match="resume"):
        train_net.main(["--cfg", DET_CFG, "--imdb", "toy_train", "--iters", "1", "--device", "cpu",
                        "--output", str(out), "--resume"])


def test_det_model_cfg_and_hparams_follow_the_jax_cli():
    """Training: the DetConfig defaults whatever TRAIN.RPN_* say, no
    clipping; testing: TEST.RPN_*."""
    c = C.cfg_from_file(DET_CFG)
    tr, te = C.det_model_cfg(c, 22, train=True), C.det_model_cfg(c, 22, train=False)
    assert (tr.rpn_pre_nms_top_n, tr.rpn_post_nms_top_n, tr.rpn_nms_thresh, tr.is_train) == (6000, 300, 0.7, True)
    assert c.TRAIN.RPN_PRE_NMS_TOP_N == 12000
    assert (te.rpn_pre_nms_top_n, te.rpn_post_nms_top_n, te.rpn_nms_thresh, te.is_train) == (
        c.TEST.RPN_PRE_NMS_TOP_N, c.TEST.RPN_POST_NMS_TOP_N, c.TEST.RPN_NMS_THRESH, False)
    hp = C.det_hparams(c)
    assert hp.clip_grad_norm == 0 and hp.learning_rate == c.TRAIN.LEARNING_RATE and hp.pose_w == c.TRAIN.POSE_W
    for f in dataclasses.fields(JD.DetConfig):
        if f.name != "compute_dtype":
            assert getattr(D.DetConfig(), f.name) == f.default, f.name


# ------------------------------------------------------------------ golden


def test_det_golden_holds_the_port():
    """The committed JAX golden (`tools/make_torch_goldens.py:det_golden`),
    which `chip_smoke.py` holds the card to, holds the port on the CPU."""
    from tests.torch_parity import check_det_golden, det_on_golden

    out, g = det_on_golden("cpu")
    err = check_det_golden(out, g)
    assert (g["out/rois"][:, 3] > 0).sum() > 50 and int(g["ransac/n"]) > 300, err


def test_det_golden_is_current():
    """Regenerating the golden with the JAX package gives the committed file."""
    from tests.torch_parity import goldens, load_npz

    G = goldens()
    fresh, golden = G.det_golden(), load_npz(G.DET_GOLDEN)
    assert set(fresh) == set(golden)
    for k in golden:
        if golden[k].dtype.kind in "fc":
            np.testing.assert_allclose(fresh[k], golden[k], rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(fresh[k], golden[k], err_msg=k)
