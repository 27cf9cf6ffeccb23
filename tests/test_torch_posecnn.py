"""The whole inference slice of the port against the JAX package, at a small
config (trunk_scale 0.125, C=4, fc_dim 64, 96x128): the committed golden
(tools/make_torch_goldens.py), the inference engine with host NMS, and one
bf16 case.

Tolerances (float32, `tests/torch_parity.check_slice_golden`): score and
vertex_pred within 1e-5 of the golden's largest magnitude; label_2d, valid
rows and classes exact; rois atol 1e-3, poses_init atol 1e-4, poses_tanh
atol 1e-5. The bf16 case's limits are in its docstring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.engine.test import make_inference_fn as jax_make_inference_fn
from posecnn_tpu.engine.test import postprocess_detections as jax_postprocess
from posecnn_tpu.models.posecnn import posecnn_forward as jax_posecnn_forward
from posecnn_torch.config import PIXEL_MEANS, PoseCNNConfig
from posecnn_torch.core.convert import make_model
from posecnn_torch.engine.test import make_inference_fn, postprocess_detections
from posecnn_torch.models.posecnn import PoseCNN, posecnn_forward
from tests.torch_parity import (
    check_slice_golden, golden_weights, goldens, load_npz, slice_cfgs, small_slice_on_golden, t,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return load_npz(goldens().SLICE_GOLDEN)


def _port(golden, dtype=torch.float32):
    jcfg, cfg = slice_cfgs(golden, jnp.float32, dtype)
    return cfg, make_model(cfg, golden_weights(golden), "cpu")


def _data(raw):
    return t(raw).float() - torch.tensor(PIXEL_MEANS).reshape(1, 1, 1, 3)


def test_small_slice_matches_jax_golden(golden):
    out, _ = small_slice_on_golden("cpu")
    check_slice_golden(out, golden)
    assert golden["out/rois"][golden["out/rois_valid"], 6].max() > 0  # a real detection
    # no GT rows at inference: zero pose weights, so poses_pred is zero (as in JAX)
    assert not out["poses_weight"].any() and not out["poses_pred"].any()


def test_small_slice_golden_is_current(golden):
    """Regenerating the golden with the JAX package gives the committed file."""
    fresh = goldens().small_slice_golden()
    assert set(fresh) == set(golden)
    for k in golden:
        if golden[k].dtype.kind in "fc":
            np.testing.assert_allclose(fresh[k], golden[k], rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(fresh[k], golden[k], err_msg=k)


@pytest.mark.parametrize("reference_nms_bug", [False, True])
def test_inference_engine_matches_jax(golden, reference_nms_bug):
    """make_inference_fn + postprocess_detections against the JAX engine."""
    jcfg, _ = slice_cfgs(golden, jnp.float32, torch.float32)
    cfg, model = _port(golden)
    jparams = jax.tree_util.tree_map(np.asarray, _jax_nested(golden_weights(golden)))
    # jit off: jitted, XLA moves the last RoI bin's edge (ROADMAP Queue 3)
    with jax.disable_jit():
        ref = jax_make_inference_fn(jcfg, PIXEL_MEANS)(
            jparams, jnp.asarray(golden["raw"]), jnp.asarray(golden["meta"]), jnp.asarray(golden["extents"])
        )
    out = make_inference_fn(cfg, PIXEL_MEANS, "cpu")(model, t(golden["raw"]), t(golden["meta"]), t(golden["extents"]))
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["label_2d"].numpy(), np.asarray(ref["label_2d"]))
    rois, poses = postprocess_detections(out, reference_nms_bug=reference_nms_bug)
    ref_rois, ref_poses = jax_postprocess(
        {k: np.asarray(v) for k, v in ref.items()}, reference_nms_bug=reference_nms_bug
    )
    assert rois.shape == ref_rois.shape and rois.shape[0] >= 1
    np.testing.assert_allclose(rois, ref_rois, atol=1e-3)
    np.testing.assert_allclose(poses, ref_poses, atol=1e-4)


def _jax_nested(flat):
    """Flat `['params']['layer']['leaf']` keys -> the JAX params pytree."""
    import re

    out = {}
    for k, v in flat.items():
        _, layer, leaf = re.findall(r"\['([^']*)'\]", k)
        out.setdefault(layer, {})[leaf] = jnp.asarray(v)
    return out


def test_small_slice_bf16_label_agreement(golden):
    """bf16 at 128x160 against the JAX bf16 forward (op by op, as in
    test_inference_engine_matches_jax). Labels agree on >= 99% of pixels
    (bf16 rounding can flip argmax ties) and rois match. score, vertex_pred
    and poses_tanh are held to bf16 rounding: their mean |err| must be at
    most 0.6x the mean gap between JAX's own bf16 and f32 runs. A port with
    the same cast points reads 0.14-0.40 of that gap; one that ran in f32,
    or cast in other places, reads about 1.0."""
    jcfg, cfg = slice_cfgs(golden, jnp.bfloat16, torch.bfloat16)
    jcfg32, _ = slice_cfgs(golden, jnp.float32, torch.float32)
    weights = golden_weights(golden)
    raw = np.random.RandomState(0).randint(0, 256, (1, 128, 160, 3)).astype(np.uint8)
    raw[0, 32:96, 40:120] = golden["raw"][0, 10:74, 20:100]
    meta, extents = golden["meta"], golden["extents"]
    means = jnp.asarray(PIXEL_MEANS, jnp.float32).reshape(1, 1, 1, 3)
    keys = ("label_2d", "rois", "rois_valid", "score", "vertex_pred", "poses_tanh")

    def jax_run(c):
        with jax.disable_jit():
            o = jax_posecnn_forward(_jax_nested(weights), c, jnp.asarray(raw).astype(jnp.float32) - means,
                                    jnp.asarray(extents), jnp.asarray(meta))
        return {k: np.asarray(o[k].astype(jnp.float32) if k != "label_2d" else o[k]) for k in keys}

    ref, ref32 = jax_run(jcfg), jax_run(jcfg32)
    model = make_model(cfg, weights, "cpu")
    with torch.no_grad():
        o = posecnn_forward(model, cfg, _data(raw), t(extents), t(meta))
    out = {k: (o[k].float() if k != "label_2d" else o[k]).numpy() for k in keys}
    agree = float((out["label_2d"] == ref["label_2d"]).mean())
    assert agree >= 0.99, agree
    np.testing.assert_array_equal(out["rois_valid"], ref["rois_valid"])
    np.testing.assert_allclose(out["rois"], ref["rois"], atol=1e-3)
    assert out["rois_valid"].any()
    for k in ("score", "vertex_pred", "poses_tanh"):
        err, gap = np.abs(out[k] - ref[k]).mean(), np.abs(ref32[k] - ref[k]).mean()
        assert err <= 0.6 * gap, (k, err, gap)


@pytest.mark.parametrize(
    "over", [dict(is_train=True, vote_threshold=0.5), dict(adaptation=True, is_train=True, vote_threshold=0.5),
             dict(vote_threshold=0.5), dict(vertex_reg_3d=True, vote_threshold=0.5)]
)
def test_unported_configs_raise(over):
    """VOTE_THRESHOLD > 0 (Hough's multi-instance voting) was refused until
    it was ported (tests/test_torch_hough_multi.py): the model now builds
    in training and at inference, with the 3D head and the domain head too,
    with the parameters of the same config at vote_threshold -1 (the mode
    adds none), where it raised NotImplementedError. (hough_from_gt:
    tests/test_torch_toy_train.py; the RGBD dual tower:
    tests/test_torch_input_modes.py; the 3D head:
    tests/test_torch_vertex3d.py; the domain head:
    tests/test_torch_adapt.py; training with the exact roi_pool, no crop
    pool: tests/test_torch_train.py::test_small_step_matches_jax[roi_pool_gt_mix1].)"""
    base = {**dict(num_classes=4, is_train=False, trunk_scale=0.125, fc_dim=64), **over}
    shapes = {k: tuple(p.shape) for k, p in PoseCNN(PoseCNNConfig(**base)).named_parameters()}
    single = PoseCNN(PoseCNNConfig(**{**base, "vote_threshold": -1.0}))
    assert shapes == {k: tuple(p.shape) for k, p in single.named_parameters()}
