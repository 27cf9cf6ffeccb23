"""The multi-instance Hough mode (VOTING_THRESHOLD > 0) of the port against
`posecnn_tpu/ops/hough_voting.py:hough_voting_multi`.

Both packages get the same label map and vertex field: the two-instance
scene of `tests/test_hough.py::test_hough_multi_instance_mode`, and a seeded
scene of four identical blobs with random depths, whose vote maps tie
between blobs (equal votes are taken in index order, as `lax.top_k` takes
them). Rows, validity, classes, votes, boxes, targets, weights, domains and
num_rois must be equal. The initial poses' translation is a mean depth whose
sum JAX takes in its own order: it is held to 2 f32 ulps (rtol 2.4e-7,
atol 0); the rest of the pose rows exactly. A small PoseCNN forward at
vote_threshold > 0 (JAX unjitted, the weights carried across by
`core/convert.py`) is held the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.models.posecnn import posecnn_forward as jax_posecnn_forward
from posecnn_tpu.ops.hough_voting import hough_voting_multi as jax_multi
from posecnn_torch.config import PIXEL_MEANS
from posecnn_torch.core.convert import make_model
from posecnn_torch.models.posecnn import posecnn_forward
from posecnn_torch.ops.hough_voting import hough_voting_multi
from tests.test_hough import C, H, W
from tests.test_torch_posecnn import _jax_nested
from tests.torch_parity import golden_weights, goldens, load_npz, slice_cfgs, t

torch.set_num_threads(1)

POSE_RTOL = 2.4e-7  # 2 ulps of float32


def _compare(out, ref):
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    assert int(out.num_rois) == int(ref.num_rois)
    np.testing.assert_array_equal(out.rois.numpy(), np.asarray(ref.rois))
    poses, ref_poses = out.poses_init.numpy(), np.asarray(ref.poses_init)
    np.testing.assert_array_equal(poses[:, :4], ref_poses[:, :4])
    np.testing.assert_allclose(poses[:, 4:], ref_poses[:, 4:], rtol=POSE_RTOL, atol=0)
    for k in ("poses_target", "poses_weight", "domains"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), np.asarray(getattr(ref, k)), err_msg=k)


def _blob(label, vertex, cx, cy, r, cls, logz):
    for y in range(label.shape[0]):
        for x in range(label.shape[1]):
            if (x - cx) ** 2 + (y - cy) ** 2 < r * r:
                label[y, x] = cls
                dx, dy = cx - x, cy - y
                n = np.sqrt(dx * dx + dy * dy) + 1e-10
                vertex[y, x, 3 * cls:3 * cls + 3] = dx / n, dy / n, logz[y, x]


def two_instances():
    """tests/test_hough.py:test_hough_multi_instance_mode's scene, one GT row
    on each instance."""
    rng = np.random.RandomState(0)
    label = np.zeros((H, W), dtype=np.int32)
    vertex = rng.randn(H, W, 3 * C).astype(np.float32) * 0.1
    for cx, cy in [(8.0, 8.0), (24.0, 14.0)]:
        _blob(label, vertex, cx, cy, 5, 1, np.zeros((H, W)))
    extents = np.zeros((C, 3), dtype=np.float32)
    extents[1] = [0.2, 0.2, 0.2]
    meta = np.zeros(48, dtype=np.float32)
    meta[0], meta[4] = 60.0, 60.0
    meta[2], meta[5] = W / 2.0, H / 2.0
    gt = np.zeros((3, 13), np.float32)
    for i, (cx, cy) in enumerate([(8.0, 8.0), (24.0, 14.0)]):
        gt[i, 1], gt[i, 6] = 1, 1.0
        gt[i, 10:13] = (cx - W / 2.0) / 60.0, (cy - H / 2.0) / 60.0, 1.0
    gt[1, 6:10] = np.array([0.9, 0.1, 0.3, 0.2]) / np.linalg.norm([0.9, 0.1, 0.3, 0.2])
    kw = dict(num_classes=C, voting_threshold=3.0, per_threshold=0.0, skip_pixels=1, label_threshold=10,
              class_slots=2, max_samples=128, max_detections_per_image=8)
    return (label[None], vertex[None], extents, meta[None], gt), kw, 32


def tied_blobs(seed=3):
    """Two images of four identical blobs (two of class 1, two of class 2)
    whose vote maps tie between blobs, with seeded random depths (the mean
    depth is then an inexact sum), more local maxima than detection rows,
    and a GT row on the first blob."""
    rng = np.random.RandomState(seed)
    B, h, w = 2, 40, 48
    label = np.zeros((B, h, w), dtype=np.int32)
    vertex = (rng.randn(B, h, w, 3 * C) * 0.1).astype(np.float32)
    for b in range(B):
        logz = rng.uniform(-0.3, 0.3, (h, w))
        for (cx, cy), cls in zip([(9, 9), (33, 9), (9, 29), (33, 29)], (1, 2, 1, 2)):
            _blob(label[b], vertex[b], cx + b, cy, 6, cls, logz)
    extents = np.full((C, 3), 0.15, np.float32)
    meta = np.zeros((B, 48), np.float32)
    meta[:, 0], meta[:, 4], meta[:, 2], meta[:, 5] = 80.0, 80.0, w / 2.0, h / 2.0
    gt = np.zeros((2, 13), np.float32)
    gt[0, 1], gt[0, 6], gt[0, 10:13] = 1, 1.0, ((9 - w / 2.0) / 80.0, (9 - h / 2.0) / 80.0, 1.0)
    kw = dict(num_classes=C, voting_threshold=2.0, per_threshold=0.01, skip_pixels=2, label_threshold=20,
              class_slots=3, max_samples=64, max_detections_per_image=6)
    return (label, vertex, extents, meta, gt), kw, 16


SCENES = {"two_instances": two_instances, "tied_blobs": tied_blobs}


@pytest.mark.parametrize("sampler", ["exact", "approx"])
@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("scene", list(SCENES))
def test_multi_matches_jax(scene, is_train, sampler):
    args, kw, chunk = SCENES[scene]()
    ref = jax_multi(*[jnp.asarray(a) for a in args], is_train=is_train, sampler=sampler, sample_chunk=chunk, **kw)
    out = hough_voting_multi(*[t(a) for a in args], is_train=is_train, sampler=sampler, **kw)
    B, D = args[0].shape[0], kw["max_detections_per_image"]
    assert out.rois.shape == (B * D * (9 if is_train else 1), 7)
    _compare(out, ref)
    assert int(out.num_rois) >= 2 * (9 if is_train else 1)


def test_ties_resolve_in_index_order():
    """tied_blobs has more selected maxima of equal votes than rows: the rows
    kept are the first in (slot, row, column) order, as lax.top_k keeps
    them, and the two packages agree on which."""
    args, kw, chunk = tied_blobs()
    out = hough_voting_multi(*[t(a) for a in args], is_train=False, **kw)
    ref = jax_multi(*[jnp.asarray(a) for a in args], is_train=False, sample_chunk=chunk, **kw)
    _compare(out, ref)
    rois = out.rois.numpy().reshape(2, kw["max_detections_per_image"], 7)
    for b in range(2):
        r = rois[b][rois[b][:, 6] > 0]
        votes = r[:, 6]
        assert (np.diff(votes) <= 0).all()
        tied = votes == votes[0]
        assert tied.sum() >= 2  # a tie at the top
        centre = np.stack([(r[:, 2] + r[:, 4]) / 2, (r[:, 3] + r[:, 5]) / 2], 1)[tied]
        key = r[tied, 1] * 1e6 + np.round(centre[:, 1]) * 1e3 + np.round(centre[:, 0])
        assert (np.diff(key) > 0).all()  # slot (class), then row, then column


def test_posecnn_forward_multi_matches_jax():
    """The small slice's network (f32, trunk_scale 0.125, C=4, 96x128, the
    golden's seed weights) at vote_threshold 1.0: JAX's forward unjitted
    against the port's, the label map equal and the Hough rows held as
    above."""
    golden = load_npz(goldens().SLICE_GOLDEN)
    jcfg, cfg = slice_cfgs(golden, jnp.float32, torch.float32, vote_threshold=1.0, vote_percentage=0.0,
                           label_threshold=50)
    weights = golden_weights(golden)
    means = np.asarray(PIXEL_MEANS, np.float32).reshape(1, 1, 1, 3)
    data = golden["raw"].astype(np.float32) - means
    with jax.disable_jit():
        ref = jax_posecnn_forward(_jax_nested(weights), jcfg, jnp.asarray(data), jnp.asarray(golden["extents"]),
                                  jnp.asarray(golden["meta"]))
    model = make_model(cfg, weights, "cpu")
    with torch.no_grad():
        out = posecnn_forward(model, cfg, t(data), t(golden["extents"]), t(golden["meta"]))
    np.testing.assert_array_equal(out["label_2d"].numpy(), np.asarray(ref["label_2d"]))
    assert out["rois"].shape == (16, 7) and bool(out["rois_valid"].any())

    class Rows:
        def __init__(self, o):
            self.rois, self.poses_init, self.valid, self.num_rois = o["rois"], o["poses_init"], o["rois_valid"], \
                o["num_rois"]
            self.poses_target, self.poses_weight = o["poses_target"], o["poses_weight"]
            self.domains = torch.zeros(1) if isinstance(o["rois"], torch.Tensor) else np.zeros(1)

    _compare(Rows(out), Rows(ref))
    np.testing.assert_allclose(out["poses_tanh"].numpy(), np.asarray(ref["poses_tanh"]), atol=1e-5)
