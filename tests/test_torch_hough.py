"""Hough voting of the port against `posecnn_tpu/ops/hough_voting.py`.

Both packages get the same label map and vertex field. Vote counts are exact
in both, so the slots, their classes and the winning centres must agree;
rois are held to atol 1e-3 and poses_init to atol 1e-4 (the mean depth is a
float sum taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.ops.hough_voting import hough_voting as jax_hough_voting
from posecnn_torch.ops.hough_voting import hough_voting
from tests.test_hough import C, _scene
from tests.torch_parity import check_hough_golden, goldens, hough_on_golden_frame, load_npz, path_vote_inputs, t

torch.set_num_threads(1)


def _compare(out, ref):
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    assert int(out.num_rois) == int(ref.num_rois)
    rois, ref_rois = out.rois.numpy(), np.asarray(ref.rois)
    np.testing.assert_array_equal(rois[:, :2], ref_rois[:, :2])  # batch, class
    np.testing.assert_array_equal(rois[:, 6], ref_rois[:, 6])  # votes
    np.testing.assert_allclose(rois, ref_rois, atol=1e-3)
    np.testing.assert_allclose(out.poses_init.numpy(), np.asarray(ref.poses_init), atol=1e-4)
    np.testing.assert_array_equal(out.poses_target.numpy(), np.asarray(ref.poses_target))
    np.testing.assert_array_equal(out.poses_weight.numpy(), np.asarray(ref.poses_weight))
    np.testing.assert_array_equal(out.domains.numpy(), np.asarray(ref.domains))


def _scene_args():
    label, vertex, extents, meta, _, _ = _scene()
    return label[None], vertex[None], extents, meta[None], np.zeros((2, 13), np.float32)


@pytest.mark.parametrize("sampler", ["exact", "approx"])
@pytest.mark.parametrize("stride,skip", [(1, 1), (4, 1), (4, 3)])
def test_hough_matches_jax_on_scene(sampler, stride, skip):
    args = _scene_args()
    kw = dict(num_classes=C, is_train=False, skip_pixels=skip, label_threshold=10, class_slots=3,
              max_samples=64, center_stride=stride, refine_window=8, sampler=sampler)
    ref = jax_hough_voting(*[jnp.asarray(a) for a in args], sample_chunk=32, use_pallas=False, **kw)
    out = hough_voting(*[t(a) for a in args], **kw)
    assert int(out.num_rois) == 2
    _compare(out, ref)


def test_hough_matches_jax_with_gt_rows():
    """GT quaternion targets matched by projected-box IoU > 0.2 (first match
    wins), with rows of another class, another image and padding."""
    label, vertex, extents, meta, centers, depths = _scene()
    # near-identity rotations keep the projected boxes on the blobs; the two
    # class-1 rows both match, and the first must win
    rng = np.random.RandomState(5)
    gt = np.zeros((5, 13), np.float32)
    for row, (cls, batch) in enumerate(((2, 0), (1, 0), (1, 0), (3, 0), (2, 1))):
        cx, cy = centers.get(cls, (16.0, 12.0))
        z = depths.get(cls, 1.0)
        q = np.array([1.0, 0, 0, 0]) + 0.1 * rng.randn(4)
        gt[row, :2] = batch, cls
        gt[row, 6:10] = q / np.linalg.norm(q)
        gt[row, 10:13] = (cx - meta[2]) / meta[0] * z, (cy - meta[5]) / meta[4] * z, z
    args = (label[None], vertex[None], extents, meta[None], gt)
    kw = dict(num_classes=C, is_train=False, skip_pixels=1, label_threshold=10, class_slots=3,
              max_samples=64, center_stride=4, refine_window=8)
    ref = jax_hough_voting(*[jnp.asarray(a) for a in args], sample_chunk=32, use_pallas=False, **kw)
    out = hough_voting(*[t(a) for a in args], **kw)
    assert out.poses_weight.sum() == 8  # both detections matched, 4 weights each
    np.testing.assert_array_equal(out.poses_target[0, 4:8].numpy(), gt[1, 6:10])  # first class-1 row
    _compare(out, ref)


def test_hough_matches_jax_pallas_front_end():
    """The JAX package's packed Pallas front end (interpret-mode kernel, as in
    tests/test_hough.py) against the port's plain path."""
    import posecnn_tpu.ops.pallas.voting as V

    args = _scene_args()
    kw = dict(num_classes=C, is_train=False, skip_pixels=1, label_threshold=10, class_slots=2,
              max_samples=256, center_stride=4, refine_window=8)
    orig = V._votes_pallas
    try:
        V._votes_pallas = lambda s, c, block, interpret: orig(s, c, block, True)
        ref = jax_hough_voting(*[jnp.asarray(a) for a in args], sample_chunk=64, use_pallas=True, **kw)
    finally:
        V._votes_pallas = orig
    _compare(hough_voting(*[t(a) for a in args], **kw), ref)


def test_hough_matches_jax_golden_on_frozen_frame():
    """Flagship settings on frame v4/000000's ground truth (the input of
    chip_smoke.py phase 4), against the committed JAX golden."""
    err = check_hough_golden(hough_on_golden_frame("cpu"))
    assert err["detections"] == 5


def test_hough_golden_is_current():
    """Regenerating the golden with the JAX package gives the committed file."""
    G = goldens()
    fresh = G.hough_golden()
    g = load_npz(G.HOUGH_GOLDEN)
    assert set(fresh) == set(g)
    for k in g:
        if g[k].dtype.kind in "fc":
            np.testing.assert_allclose(fresh[k], g[k], rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(fresh[k], g[k], err_msg=k)


def test_hough_training_is_not_ported():
    """Training was refused before slice B; it is ported now, so this holds
    the training outputs (9 jittered rows a detection) to JAX on the scene."""
    args = _scene_args()
    kw = dict(num_classes=C, is_train=True, skip_pixels=1, label_threshold=10, class_slots=3,
              max_samples=64, center_stride=4, refine_window=8)
    ref = jax_hough_voting(*[jnp.asarray(a) for a in args], sample_chunk=32, use_pallas=False, **kw)
    out = hough_voting(*[t(a) for a in args], **kw)
    assert out.rois.shape == (3 * 9, 7) and int(out.num_rois) == 2 * 9
    _compare(out, ref)


@pytest.mark.parametrize("frame,P", [("000000", 512), ("000005", 1024)], ids=["inference", "training"])
def test_factored_vote_inputs_are_what_hough_voting_votes_on(monkeypatch, frame, P):
    """`path_vote_inputs` (the sample packing, coarse grid and refine window
    that `hough_voting` calls) gives exactly the two vote calls' inputs of
    `hough_voting` on a frozen frame's ground truth, and its winners; at the
    golden's settings `hough_voting` still matches the JAX golden."""
    import posecnn_torch.ops.hough_voting as HV

    calls = []

    def spy(samples, centers, grid_w=0):
        calls.append((samples, centers, grid_w))
        return HV_accumulate(samples, centers, grid_w)

    HV_accumulate = HV.accumulate_votes
    monkeypatch.setattr(HV, "accumulate_votes", spy)
    G = goldens()
    s = dict(G.HOUGH_SETTINGS, max_samples=P)
    label, vert, extents, meta = G.hough_inputs(f"data/lov_syn_val_v4/{frame}.npz")
    out = HV.hough_voting(
        t(label[None]), t(vert[None]), t(extents), t(meta[None]), torch.zeros((1, 13)),
        num_classes=s["num_classes"], is_train=False, skip_pixels=s["skip_pixels"],
        label_threshold=s["label_threshold"], class_slots=s["class_slots"], max_samples=P,
        center_stride=s["center_stride"], refine_window=s["refine_window"],
        pixel_grid_stride=s["pixel_grid_stride"], sampler=s["sampler"],
    )
    d = path_vote_inputs(f"data/lov_syn_val_v4/{frame}.npz", P)
    (s1, c1, g1), (s2, c2, g2) = calls
    assert torch.equal(s1, d["samples"]) and torch.equal(s2, d["samples"])
    assert torch.equal(c1, d["coarse"]) and g1 == d["grid_w"] == 160 and d["coarse"].shape == (1, 2, 160 * 120)
    assert torch.equal(c2, d["window"]) and g2 == 0 and d["window"].shape == (8, 2, 256)
    # the refine window's winners are hough_voting's: votes, centre, depth
    v2, d2 = HV_accumulate(d["samples"], d["window"])
    j = torch.argmax(v2, dim=1)
    slots = torch.arange(8)
    cx, cy = d["window"][slots, 0, j], d["window"][slots, 1, j]
    valid = out.valid
    assert int(valid.sum()) >= 3 and torch.equal(valid, d["samples"][:, 7].sum(dim=1) > 0)
    assert torch.equal(out.rois[valid, 6], v2[slots, j][valid])
    torch.testing.assert_close(0.5 * (out.rois[valid, 2] + out.rois[valid, 4]), cx[valid], rtol=0, atol=1e-3)
    torch.testing.assert_close(0.5 * (out.rois[valid, 3] + out.rois[valid, 5]), cy[valid], rtol=0, atol=1e-3)
    torch.testing.assert_close(out.poses_init[valid, 6], (d2[slots, j] / v2[slots, j])[valid], rtol=1e-6, atol=0)
    if P == 512 and frame == "000000":
        assert check_hough_golden(hough_on_golden_frame("cpu"))["detections"] == 5
