"""The ops of the port's training step against the JAX package, on the same
numpy inputs: hard label and the fused cross entropy, vertex targets and the
fused vertex loss, the ADD/ADD-S loss, `crop_pool_batched`, the training
outputs of Hough voting, the chromatic jitter and the noise field; and the
port's own randomness (dropout, `Draws`), which is tested by distribution and
by replay, never matched to JAX's bits (ROADMAP queue 3, hazard 9).

Tolerances: values and gradients in float32 within 1e-5 of the reference's
largest magnitude (f32 sums in other orders); integer and boolean outputs
exactly; Hough rois within 1e-3 (the mean depth is a float sum in another
order); colours within 1e-3 on the 0..255 scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.ops.add_loss as JA
import posecnn_tpu.ops.chromatic as JCh
import posecnn_tpu.ops.losses as JLo
import posecnn_tpu.ops.vertex_targets as JV
from posecnn_tpu.ops.hard_label import hard_label as jax_hard_label
from posecnn_tpu.ops.roi_pool import crop_pool_batched as jax_crop_pool_batched
from posecnn_tpu.ops.hough_voting import hough_voting as jax_hough
from posecnn_torch.data.minibatch import load_frozen_frame, pose_rows
from posecnn_torch.engine.train import Draws
from posecnn_torch.models import layers as L
from posecnn_torch.ops import add_loss as A
from posecnn_torch.ops import chromatic as Ch
from posecnn_torch.ops import hard_label as H
from posecnn_torch.ops import losses as Lo
from posecnn_torch.ops import roi_pool as R
from posecnn_torch.ops import vertex_targets as V
from posecnn_torch.ops.hough_voting import hough_voting
from tests.torch_parity import goldens, t

torch.set_num_threads(1)


def _close(got, ref, rel=1e-5):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-12))


def _scores(seed, B=2, Hh=6, W=7, C=5):
    rng = np.random.RandomState(seed)
    score = np.maximum(rng.randn(B, Hh, W, C) * 2.0, 0).astype(np.float32)
    gt = rng.randint(0, C, (B, Hh, W)).astype(np.int32)
    gt[0, 0, :3] = -1  # adaptation pixels: no label
    score[1, 2, :, 0] = 9.0  # confident background: gated out below the threshold
    gt[1, 2, :] = 0
    return score, gt


def test_hard_label_matches_jax():
    score, gt = _scores(0)
    prob = np.asarray(jax.nn.softmax(jnp.asarray(score), axis=-1))
    ref = jax_hard_label(jnp.asarray(prob), jnp.asarray(gt), 0.7)
    got = H.hard_label(t(prob), t(gt), 0.7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got.requires_grad


@pytest.mark.parametrize("threshold", [1.0, 0.7])
def test_hard_label_cross_entropy_matches_jax(threshold):
    score, gt = _scores(1)
    ref, vjp = jax.vjp(lambda s: JLo.loss_cross_entropy_hard_label_sparse(s, jnp.asarray(gt), threshold),
                       jnp.asarray(score))
    (rg,) = vjp(jnp.float32(1.0))
    st = t(score).requires_grad_(True)
    got = Lo.loss_cross_entropy_hard_label_sparse(st, t(gt), threshold)
    got.backward()
    _close(got, ref)
    _close(st.grad, rg)


def _vertex_scene(seed, B=2, Hh=12, W=14, C=4):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, C, (B, Hh, W)).astype(np.int32)
    label[1, :2, :] = -1
    centers = np.zeros((B, 5, 4), np.float32)
    centers[0, 0] = [1, 3.5, 2.0, 0.8]
    centers[0, 1] = [1, 11.0, 9.5, 1.3]  # a second instance of class 1: nearest-centre routing
    centers[0, 2] = [2, 6.0, 6.0, 1.1]
    centers[1, 0] = [3, 2.0, 10.0, 0.6]
    centers[1, 1] = [2, 12.5, 1.0, 1.9]  # class 1 has no row in image 1: not found
    vert = rng.randn(B, Hh, W, 3 * C).astype(np.float32)
    return label, centers, vert


def test_vertex_targets_match_jax():
    label, centers, _ = _vertex_scene(2)
    e, found = V._nearest_rows(t(label), t(centers))
    re, rf = JV._nearest_rows(jnp.asarray(label), jnp.asarray(centers))
    np.testing.assert_array_equal(found.numpy(), np.asarray(rf))
    _close(e, re)
    tg, wg = V.vertex_targets_device(t(label), t(centers), 4)
    rt, rw = JV.vertex_targets_device(jnp.asarray(label), jnp.asarray(centers), 4)
    _close(tg, rt)
    np.testing.assert_array_equal(wg.numpy(), np.asarray(rw))


def test_vertex_loss_matches_jax():
    """The loss and its gradient, with and without z_obj_norm
    (TPU.VERTEX_Z_OBJ_NORM)."""
    label, centers, vert = _vertex_scene(3)
    vert[0, :, :, :3] *= 4.0  # some |diff| > 1: both arms of the smooth L1
    for z_obj_norm in (False, True):
        ref, vjp = jax.vjp(lambda v: JV.smooth_l1_loss_vertex_sparse(
            v, jnp.asarray(label), jnp.asarray(centers), 4, 10.0, z_obj_norm=z_obj_norm), jnp.asarray(vert))
        (rg,) = vjp(jnp.float32(1.0))
        vt = t(vert).requires_grad_(True)
        got = V.smooth_l1_loss_vertex_sparse(vt, t(label), t(centers), 4, 10.0, z_obj_norm=z_obj_norm)
        got.backward()
        _close(got, ref)
        _close(vt.grad, rg)


def _unit(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _add_inputs(seed, N=7, C=4, P=40):
    rng = np.random.RandomState(seed)
    points = (rng.randn(C, P, 3) * 0.5).astype(np.float32)
    target = np.zeros((N, 4 * C), np.float32)
    pred = rng.randn(N, 4 * C).astype(np.float32) * 0.1
    weight = np.zeros((N, 4 * C), np.float32)
    for n in range(N):
        c = 1 + n % (C - 1)
        q = _unit(rng.randn(4))
        target[n, 4 * c:4 * c + 4] = q
        # rows from close to far from the target: some points below the margin
        pred[n, 4 * c:4 * c + 4] = _unit(q + rng.randn(4) * (0.02 * n))
        if n != 3:  # row 3 has no active class
            weight[n, 4 * c:4 * c + 4] = 1.0
    symmetry = np.array([0, 0, 1, 0], np.float32)  # class 2 is symmetric (ADD-S)
    return pred, target, weight, points, symmetry


@pytest.mark.parametrize("margin", [0.01, 0.05])
def test_add_loss_matches_jax(margin):
    pred, target, weight, points, symmetry = _add_inputs(4)
    args = [jnp.asarray(a) for a in (target, weight, points, symmetry)]
    ref, vjp = jax.vjp(lambda p: JA.average_distance_loss(p, *args, margin), jnp.asarray(pred))
    (rg,) = vjp(jnp.float32(1.0))
    pt = t(pred).requires_grad_(True)
    got = A.average_distance_loss(pt, t(target), t(weight), t(points), t(symmetry), margin)
    got.backward()
    _, bd = A.add_loss_forward(t(pred), t(target), t(weight), t(points), t(symmetry), margin)
    d2_rows = []  # the hinge is crossed: some rows have points on both sides
    for n in range(pred.shape[0]):
        x1, x2 = (np.einsum("ij,pj->pi", A.quat2mat(t(q)).numpy(), points[1 + n % 3]) for q in
                  (pred[n, 4 * (1 + n % 3):4 * (1 + n % 3) + 4], target[n, 4 * (1 + n % 3):4 * (1 + n % 3) + 4]))
        d2_rows.append(((x1 - x2) ** 2).sum(-1))
    d2 = np.concatenate(d2_rows)
    assert (d2 < margin).any() and (d2 >= margin).any()
    assert float(ref) > 0
    _close(got, ref)
    _close(pt.grad, rg)
    _close(bd, rg)


def test_add_s_nearest_neighbour_ties_take_the_earliest_index():
    """Equidistant GT-rotated candidates: the first index wins, in both."""
    C, P = 2, 4
    points = np.zeros((C, P, 3), np.float32)
    points[1] = [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 2, 0]]
    target = np.zeros((1, 4 * C), np.float32)
    target[0, 4:8] = [1, 0, 0, 0]
    weight = np.zeros_like(target)
    weight[0, 4:8] = 1
    pred = target.copy()
    pred[0, 4:8] = _unit(np.array([0.9, 0.0, 0.0, 0.3]))
    symmetry = np.array([0, 1], np.float32)
    x1 = torch.zeros((1, 1, 3))
    x2 = t(points[1])[None]
    assert int(A._nearest(x1, x2, 2)[0, 0]) == 0
    x1 = torch.tensor([[[0.0, 1.0, 0.0]]])
    assert int(A._nearest(x1, x2[:, 1:3], 1)[0, 0]) == 0  # (1,0,0) and (-1,0,0) tie across blocks
    args = [jnp.asarray(a) for a in (target, weight, points, symmetry)]
    ref, vjp = jax.vjp(lambda p: JA.average_distance_loss(p, *args, 1e-4, 1), jnp.asarray(pred))
    (rg,) = vjp(jnp.float32(1.0))
    pt = t(pred).requires_grad_(True)
    got = A.average_distance_loss(pt, t(target), t(weight), t(points), t(symmetry), 1e-4)
    got.backward()
    _close(got, ref)
    _close(pt.grad, rg)


def test_crop_pool_matches_jax():
    """Forward and gradient in float32, rois inside the map (tie-free), and
    a bf16 map promotes to f32 crops, as in JAX."""
    rng = np.random.RandomState(5)
    feat = rng.randn(2, 10, 12, 8).astype(np.float32)
    rois = np.zeros((2, 3, 7), np.float32)
    x1 = rng.uniform(0, 80, (2, 3))
    y1 = rng.uniform(0, 60, (2, 3))
    rois[..., 2], rois[..., 3] = x1, y1
    rois[..., 4] = x1 + rng.uniform(10, 90 - x1)
    rois[..., 5] = y1 + rng.uniform(10, 75 - y1)
    g = rng.randn(2, 3, 7, 7, 8).astype(np.float32)
    ref, vjp = jax.vjp(lambda f: jax_crop_pool_batched(f, jnp.asarray(rois), 1.0 / 8.0, 7), jnp.asarray(feat))
    (rg,) = vjp(jnp.asarray(g))
    ft = t(feat).requires_grad_(True)
    got = R.crop_pool_batched(ft, t(rois), 1.0 / 8.0, 7)
    got.backward(t(g))
    _close(got, ref)
    _close(ft.grad, rg)
    fb = t(feat).to(torch.bfloat16)
    ref_b = jax_crop_pool_batched(jnp.asarray(feat).astype(jnp.bfloat16), jnp.asarray(rois), 1.0 / 8.0, 7)
    got_b = R.crop_pool_batched(fb, t(rois), 1.0 / 8.0, 7)
    assert got_b.dtype == torch.float32 and ref_b.dtype == jnp.float32
    _close(got_b, ref_b)


def test_hough_training_outputs_match_jax():
    """Training outputs (9 jittered rows a detection, GT quaternion targets
    matched by IoU > 0.2, weights, domains) on frame v4/000000's ground
    truth with its GT rows, at the flagship training Hough settings."""
    G = goldens()
    label, vert, extents, meta = G.hough_inputs()
    frame = load_frozen_frame(f"{G.ROOT}/{G.HOUGH_FRAME}")
    gt = np.zeros((8, 13), np.float32)
    rows = pose_rows(0, frame)
    gt[: len(rows)] = rows
    kw = dict(num_classes=22, is_train=True, skip_pixels=1, label_threshold=500, class_slots=8, max_samples=1024,
              center_stride=4, refine_window=16, pixel_grid_stride=3, sampler="approx")
    ref = jax_hough(jnp.asarray(label[None]), jnp.asarray(vert[None]), jnp.asarray(extents), jnp.asarray(meta[None]),
                    jnp.asarray(gt), **kw)
    got = hough_voting(t(label[None]), t(vert[None]), t(extents), t(meta[None]), t(gt), **kw)
    assert got.rois.shape == (72, 7)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.domains.numpy(), np.asarray(ref.domains))
    np.testing.assert_array_equal(got.poses_weight.numpy(), np.asarray(ref.poses_weight))
    np.testing.assert_array_equal(got.rois[:, :2].numpy(), np.asarray(ref.rois)[:, :2])
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(ref.rois), atol=1e-3)
    np.testing.assert_allclose(got.poses_target.numpy(), np.asarray(ref.poses_target), atol=1e-6)
    np.testing.assert_allclose(got.poses_init.numpy(), np.asarray(ref.poses_init), atol=1e-4)
    assert int(got.num_rois) == 9 * 5 and got.poses_weight.sum() > 0  # some detections match their GT row


def test_chromatic_and_noise_match_jax():
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (2, 9, 11, 3)).astype(np.float32)
    img[0, 0, :4] = [[0, 0, 0], [255, 255, 255], [128, 128, 128], [255, 0, 0]]  # grey and primaries
    dhls = np.array([[1.7, -20.0, 25.0], [-1.8, 25.6, -25.6]], np.float32)
    ref = JCh.chromatic_device(jnp.asarray(img), jnp.asarray(dhls))
    got = Ch.chromatic_device(t(img), t(dhls))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)
    field = rng.randn(2, 9, 11).astype(np.float32)
    sigma = np.array([8.0, 0.0], np.float32)
    ref_n = jnp.clip(jnp.asarray(img) + jnp.asarray(sigma)[:, None, None, None] * jnp.asarray(field)[..., None], 0, 255)
    np.testing.assert_array_equal(Ch.add_noise_field(t(img), t(sigma), t(field)).numpy(), np.asarray(ref_n))


def test_dropout_by_distribution():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = L.dropout(x, 0.5, gen)
    kept = y > 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.005
    assert torch.all(y[kept] == 2.0)
    same = L.dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(y, same)
    assert L.dropout(x, 1.0, gen) is x
    u = torch.rand(200_000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(L.dropout(x, 0.5, uniform=u), y)


def test_draws_record_and_replay():
    rec = Draws(torch.Generator().manual_seed(1), record=True)
    a = (rec.uniform("u", (3,), "cpu"), rec.normal("n", (2, 2), "cpu"), rec.randint("i", 7, (4,), "cpu"))
    rep = Draws(replay=rec.recorded)
    b = (rep.uniform("u", (3,), "cpu"), rep.normal("n", (2, 2), "cpu"), rep.randint("i", 7, (4,), "cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[2].max()) < 7


def test_training_after_inference_mode_in_one_process():
    """The deconv's cached interpolation matrix, first made under
    torch.inference_mode, must not be an inference tensor: a later training
    step saves it for the backward (found on the card by chip_smoke.py)."""
    x = torch.randn(1, 3, 5, 4)
    with torch.inference_mode():
        L.deconv(x, 4, 2)
    xr = x.clone().requires_grad_(True)
    L.deconv(xr, 4, 2).sum().backward()
    assert xr.grad is not None and torch.isfinite(xr.grad).all()
