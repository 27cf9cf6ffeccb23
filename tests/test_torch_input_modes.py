"""The depth inputs of the port (INPUT DEPTH, NORMAL and RGBD) against the
JAX package.

The host path: the HLS conversions of `utils/blob.py` against cv2 on every
input, the jitter and the noise against the JAX package's draw for draw,
the bilateral filter (`csrc/bilateral.cc`) against cv2, the depth and
normal images, and `get_minibatch` for the three inputs with the jitter and
the noise on (bit-equal batches; NORMAL's image within the filter's
limits). The network: DEPTH, NORMAL and RGBD PoseCNN in float32 against
JAX's (1e-5 of the largest magnitude, exact labels), one RGBD training step
against the JAX golden (`tests/golden/torch_port_input_modes.npz`, at the
limits of the small training step), RGBD snapshots in both packages, and
`test_net` without the pose head. Three faults of the JAX package decide
what the port does, and are held here by calling it: its test_net builds
the COLOR model whatever INPUT says (an RGBD snapshot fails there in the
forward, and raises ValueError naming the shape in the port), and its
test_net on PoseCNN without the vertex head raises KeyError.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.core import checkpoint as JCK
from posecnn_tpu.data import minibatch as JM
from posecnn_tpu.engine import test as JT
from posecnn_tpu.engine.train import TrainHParams as JaxHP
from posecnn_tpu.engine.train import create_train_state as jax_create_train_state
from posecnn_tpu.models.posecnn import PoseCNNConfig as JaxCfg
from posecnn_tpu.models.posecnn import posecnn_forward as jax_forward
from posecnn_tpu.utils import blob as JB
from posecnn_torch.config import PIXEL_MEANS, PoseCNNConfig
from posecnn_torch.core import checkpoint as CK
from posecnn_torch.core.convert import init_params_numpy, make_model, param_shapes, params_to_numpy
from posecnn_torch.data import minibatch as M
from posecnn_torch.data.lov_syn import LovSynVal
from posecnn_torch.engine import test as PT
from posecnn_torch.engine import train as T
from posecnn_torch.models.posecnn import posecnn_forward
from posecnn_torch.native import bilateral_filter
from posecnn_torch.utils import blob
from tests.torch_parity import (
    check_bilateral, check_host_images, check_slice_golden, check_train_golden, goldens, load_npz, port_host_images,
    rgbd_train_on_golden,
)

G = goldens()
FRAMES_DIR = os.path.join(G.ROOT, "data", "lov_syn_val_v4")
# a small model of the inputs' forward: the trunk at 1/4 width, fc 64
SMALL = dict(num_classes=22, num_units=8, trunk_scale=0.25, fc_dim=64, hough_class_slots=4, hough_max_samples=64,
             hough_refine_window=8, label_threshold=10, hough_sampler="approx", skip_pixels=1, is_train=False)


def _frame(i: int):
    return M.load_frozen_frame(os.path.join(FRAMES_DIR, f"{i:06d}.npz"))


def _jax_frame(f) -> JM.Frame:
    return JM.Frame(color=f.color, label=f.label, cls_indexes=f.cls_indexes, poses=f.poses, center=f.center,
                    intrinsic_matrix=f.intrinsic_matrix, depth=f.depth, factor_depth=f.factor_depth)


# ------------------------------------------------------------------ host images


def _all_colours() -> np.ndarray:
    code = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([code >> 16, (code >> 8) & 255, code & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)


def test_bgr_to_hls_equals_cv2_on_every_colour():
    """The BGR -> HLS table (built from `bgr_to_hls`) against cv2 on all 2^24
    colours, and the function itself on a frame."""
    to_hls, _ = blob.hls_tables()
    im = _all_colours()
    np.testing.assert_array_equal(to_hls.reshape(4096, 4096, 3), cv2.cvtColor(im, cv2.COLOR_BGR2HLS))
    color = _frame(3).color
    np.testing.assert_array_equal(blob.bgr_to_hls(color), cv2.cvtColor(color, cv2.COLOR_BGR2HLS))


def test_hls_to_bgr_equals_cv2_on_every_triple():
    """The HLS -> BGR table (built from `hls_to_bgr`) against cv2 on all
    180 x 256 x 256 triples."""
    _, to_bgr = blob.hls_tables()
    h, l, s = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hls = np.stack([h, l, s], -1).astype(np.uint8).reshape(180 * 256, 256, 3)
    np.testing.assert_array_equal(to_bgr.reshape(180 * 256, 256, 3), cv2.cvtColor(hls, cv2.COLOR_HLS2BGR))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chromatic_transform_matches_jax(seed):
    """Draw for draw against JAX's (cv2) on a frame; a float image is
    rounded first; with a label the foreground keeps its colour. The
    streams stay in step."""
    f = _frame(seed)
    ra, rb = np.random.RandomState(seed), np.random.RandomState(seed)
    for im, label in ((f.color, None), (f.color.astype(np.float32) + 0.4, None), (f.color, f.label)):
        np.testing.assert_array_equal(blob.chromatic_transform(im, label=label, rng=rb),
                                      JB.chromatic_transform(im, label=label, rng=ra))
    assert ra.randint(1 << 30) == rb.randint(1 << 30)


def test_add_noise_matches_jax():
    """`add_noise` against JAX's over 40 draws on a uint8 frame and on its
    float32 depth image: the Gaussian branch exactly, the blur exactly on
    uint8, and on float32 exactly for sizes 3-11 and within 1e-4 for 15
    (cv2's DFT path). The streams stay in step."""
    f = _frame(5)
    images = (f.color, M.depth_input_image(f.depth))
    ra, rb = np.random.RandomState(11), np.random.RandomState(11)
    seen = set()
    for n in range(40):
        im = images[n % 2]
        probe = copy.deepcopy(rb)
        size = M.BLUR_SIZES[int(probe.randint(6))] if probe.rand(1) >= 0.9 else 0
        got, ref = blob.add_noise(im, rng=rb), JB.add_noise(im, rng=ra)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        if size == 15 and im.dtype == np.float32:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(got, ref)
        seen.add((size > 0, im.dtype.name))
    assert seen == {(False, "uint8"), (True, "uint8"), (False, "float32"), (True, "float32")}
    assert ra.randint(1 << 30) == rb.randint(1 << 30)


@pytest.mark.parametrize("size", M.BLUR_SIZES)
def test_motion_blur_of_a_float_image_matches_cv2(size):
    """The blur's float32 sums against cv2.filter2D along both axes: equal
    for sizes 3-11, within 1e-4 at 15 (where cv2 convolves by DFT)."""
    im = M.depth_input_image(_frame(6).depth)
    for axis in (1, 0):
        kernel = np.zeros((size, size))
        if axis == 1:
            kernel[(size - 1) // 2, :] = 1
        else:
            kernel[:, (size - 1) // 2] = 1
        ref = cv2.filter2D(im, -1, kernel / size)

        class Fixed:  # the draws of one blur: this size, this axis
            def randint(self, n):
                return M.BLUR_SIZES.index(size)

            def rand(self, n):
                return np.array([0.25 if axis == 1 else 0.75])

        got = M.motion_blur(im, Fixed())
        if size == 15:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(got, ref)


def _normal_u8(i: int) -> np.ndarray:
    f = _frame(i)
    n = M.normals_np(f.depth.astype(np.float32) / f.factor_depth, f.intrinsic_matrix)
    return np.ascontiguousarray((127.5 * n + 127.5).astype(np.uint8)[:, :, (2, 1, 0)])


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_bilateral_filter_matches_cv2(i):
    """The filter of a frame's 640x480 normal image against cv2 as the
    wheels call it (with IPP): >= 99.9% of values exact and none off by
    more than 1; against OpenCV's own code (IPP off), every value."""
    im = _normal_u8(i)
    got = bilateral_filter(im, 9, 75, 75)
    err = check_bilateral(got, cv2.bilateralFilter(im, 9, 75, 75))
    assert err["exact"] >= 0.999
    use = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        np.testing.assert_array_equal(got, cv2.bilateralFilter(im, 9, 75, 75))
    finally:
        cv2.ipp.setUseIPP(use)


def test_bilateral_filter_edges():
    """Odd and tiny sizes (the reflect-101 border of 1- and 2-pixel sides),
    other diameters and sigmas, against OpenCV's own code; bad inputs
    raise."""
    rng = np.random.RandomState(0)
    use = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        for (h, w), d, sc, ss in (((97, 131), 9, 75, 75), ((1, 1), 9, 75, 75), ((2, 3), 9, 75, 75),
                                  ((5, 40), 5, 20, 3), ((33, 17), 0, 30, 4)):
            im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            np.testing.assert_array_equal(bilateral_filter(im, d, sc, ss), cv2.bilateralFilter(im, d, sc, ss))
    finally:
        cv2.ipp.setUseIPP(use)
    with pytest.raises(ValueError):
        bilateral_filter(np.zeros((4, 4, 3), np.float32), 9, 75, 75)
    with pytest.raises(ValueError):
        bilateral_filter(np.zeros((4, 4), np.uint8), 9, 75, 75)


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_depth_and_normal_images_match_jax(i):
    """`depth_input_image` and `normals_np` equal to JAX's; the normal image
    within the bilateral filter's limits of JAX's (cv2) and its float32
    layout."""
    f = _frame(i)
    np.testing.assert_array_equal(M.depth_input_image(f.depth), JM.depth_input_image(f.depth))
    depth_m = f.depth.astype(np.float32) / f.factor_depth
    np.testing.assert_array_equal(M.normals_np(depth_m, f.intrinsic_matrix), JM.normals_np(depth_m, f.intrinsic_matrix))
    got = M.normal_input_image(f.depth, f.factor_depth, f.intrinsic_matrix)
    ref = JM.normal_input_image(f.depth, f.factor_depth, f.intrinsic_matrix)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    check_bilateral(got.astype(np.uint8), ref.astype(np.uint8))
    zeros = np.zeros((32, 48), np.float32)
    np.testing.assert_array_equal(M.depth_input_image(zeros), JM.depth_input_image(zeros))


def test_input_modes_golden_is_current_and_the_port_matches_it():
    """tools/make_torch_goldens.py regenerates the input-modes golden from
    the JAX package bit for bit, and the port's host images match it (the
    check `chip_smoke.py` makes on the card's host)."""
    g = load_npz(G.INPUT_MODES_GOLDEN)
    new = G.input_modes_golden()
    assert sorted(new) == sorted(g)
    for k, v in new.items():
        np.testing.assert_array_equal(np.asarray(v), g[k], err_msg=k)
    for i, path in enumerate(G.TRAIN_FRAMES):
        err = check_host_images(port_host_images(path), g, i)
        assert err["exact"] >= 0.999


# ------------------------------------------------------------------ host batches


@pytest.mark.parametrize("fmt", ["DEPTH", "NORMAL", "RGBD"])
def test_get_minibatch_matches_jax(fmt):
    """Host batches of 640x480 frames (one without depth) with the jitter
    and the noise on, against JAX's over 6 batches of 2: every key
    bit-equal, but NORMAL's image, within the bilateral filter's limits;
    no chroma or noise rows (the host applied them); the streams in step."""
    dataset = LovSynVal()
    frames = [dataset.load_frame(i) for i in range(5)]
    frames.append(dataclasses.replace(frames[0], depth=None))
    kw = dict(num_classes=22, chromatic=True, add_noise=True, device_targets=True, input_format=fmt)
    ra, rb = np.random.RandomState(7), np.random.RandomState(7)
    for n in range(6):
        pick = [frames[(2 * n) % 6], frames[(2 * n + 1) % 6]]
        ref = JM.get_minibatch([_jax_frame(f) for f in pick], JM.MinibatchConfig(**kw), dataset._extents, None, None,
                               rng=ra)
        got = M.get_minibatch(pick, M.MinibatchConfig(**kw), rb)
        assert sorted(got) == sorted(ref) and ("data_p" in got) == (fmt == "RGBD")
        assert "chroma_dhls" not in got and "noise_sigma" not in got
        for k, v in ref.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            if fmt == "NORMAL" and k == "data":
                check_bilateral(got[k], v)
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=f"batch {n} {k}")
    assert ra.randint(1 << 30) == rb.randint(1 << 30)


# ------------------------------------------------------------------ the network


def _small_batch(fmt: str) -> dict:
    """The 64x80 frames v4/000000 and 000001 (with depth) as a host batch of
    `fmt`, no jitter or noise."""
    mcfg = M.MinibatchConfig(num_classes=22, chromatic=False, add_noise=False, device_targets=True,
                             input_format=fmt)
    return M.get_minibatch(G.train_frames(depth=True), mcfg, np.random.RandomState(0))


@pytest.mark.parametrize("fmt", ["DEPTH", "NORMAL", "RGBD"])
def test_posecnn_forward_matches_jax(fmt):
    """The inference network in float32 on a batch of the input (64x80,
    the trunk at 1/4 width, C=22) against unjitted JAX on the same weights:
    score and vertex_pred within 1e-5 of the largest magnitude, labels,
    valid rows and classes exact, rois, poses_init and poses_tanh at the
    small slice's limits."""
    cfg = PoseCNNConfig(compute_dtype=torch.float32, input_format=fmt, **SMALL)
    jcfg = JaxCfg(compute_dtype=jnp.float32, input_format=fmt, **SMALL)
    params = init_params_numpy(3, cfg)
    batch = _small_batch(fmt)
    means = np.asarray(PIXEL_MEANS, np.float32).reshape(1, 1, 1, 3)
    data = batch["data"].astype(np.float32) - means
    data_p = batch["data_p"].astype(np.float32) - means if fmt == "RGBD" else None
    ext = np.full((22, 3), 0.1, np.float32)
    model = make_model(cfg, params, "cpu")
    with torch.inference_mode():
        out = posecnn_forward(model, cfg, torch.from_numpy(data), torch.from_numpy(ext),
                              torch.from_numpy(batch["meta_data"]),
                              data_p=None if data_p is None else torch.from_numpy(data_p))
    with jax.disable_jit():
        ref = jax_forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg, jnp.asarray(data), jnp.asarray(ext),
                          jnp.asarray(batch["meta_data"]), data_p=None if data_p is None else jnp.asarray(data_p))
    check_slice_golden(out, {f"out/{k}": np.asarray(v) for k, v in ref.items()})
    assert (fmt == "RGBD") == hasattr(model, "trunk_p")
    if fmt == "RGBD":
        assert model.score_conv5.weight.shape[1] == 2 * model.score_conv5_vertex.weight.shape[1]
        with pytest.raises(ValueError, match="data_p"):
            posecnn_forward(model, cfg, torch.from_numpy(data), torch.from_numpy(ext),
                            torch.from_numpy(batch["meta_data"]))


def test_rgbd_train_step_matches_jax_golden():
    """One RGBD training step with the vertex and pose heads (the dual
    tower at 1/16 width, the depth images as data_p, crop pool, GT mix 1,
    clipping) against the JAX golden at the small training step's limits:
    every loss term and the gradient norm 1e-5 relative, each gradient 5e-5
    of its largest magnitude, the update; both trunks have gradients."""
    losses, grads, after, lr, g_norm, before, g = rgbd_train_on_golden()
    check_train_golden(losses, grads, after, lr, g_norm, before, g)
    assert losses["loss_pose"] > 0 and losses["loss_vertex"] > 0
    assert float(grads["trunk_p.conv1_2.weight"].abs().max()) > 0 and float(grads["trunk.conv1_2.weight"].abs().max()) > 0


def test_rgbd_host_fed_step_runs_on_a_host_batch():
    """`make_train_step` on an RGBD host batch (uint8 data and data_p): the
    step subtracts the pixel means from both, as `compute_losses` with the
    batch's floats does."""
    cfg = PoseCNNConfig(compute_dtype=torch.float32, input_format="RGBD", **{**SMALL, "is_train": True,
                                                                              "use_crop_pool": True})
    params = init_params_numpy(3, cfg)
    batch = T.to_device(_small_batch("RGBD"), "cpu")
    pts = torch.zeros((22, 16, 3))
    sym, ext = torch.zeros(22), torch.full((22, 3), 0.1)
    hp = T.TrainHParams()
    means = torch.tensor(PIXEL_MEANS).reshape(1, 1, 1, 3)
    floats = {**batch, "data": batch["data"].float() - means, "data_p": batch["data_p"].float() - means}
    _, ref = T.compute_losses(make_model(cfg, params, "cpu"), cfg, hp, floats, pts, sym, ext)
    out = T.make_train_step(cfg, hp, pts, sym, ext)(T.create_train_state(make_model(cfg, params, "cpu"), hp), batch,
                                                     T.Draws())
    for k in ("loss", "loss_cls", "loss_vertex", "loss_regu"):
        assert float(out[k]) == float(ref[k]), k


# ------------------------------------------------------------------ snapshots


def _rgbd_cfgs():
    kw = dict(SMALL, is_train=True, use_crop_pool=True, input_format="RGBD")
    return PoseCNNConfig(compute_dtype=torch.float32, **kw), JaxCfg(compute_dtype=jnp.float32, **kw)


def test_rgbd_snapshot_loads_in_jax_and_back(tmp_path):
    """A port RGBD snapshot (with its trace, clipping on) restores into
    JAX's RGBD train state key for key and bit for bit, the `_p` trunk and
    the 2x wide score_conv5 included; JAX's snapshot of that state restores
    into a fresh port state bit for bit."""
    cfg, jcfg = _rgbd_cfgs()
    hp = T.TrainHParams(clip_grad_norm=10.0)
    state = T.create_train_state(make_model(cfg, init_params_numpy(5, cfg), "cpu"), hp)
    gen = torch.Generator().manual_seed(0)
    for p, t in zip(state.optimizer.params, state.optimizer.trace):
        t.copy_(torch.randn(p.shape, generator=gen))
    state.step = 7
    path = CK.save_checkpoint(str(tmp_path / "port"), state, 7, prefix="rgbd")
    jstate = jax_create_train_state(jcfg, JaxHP(clip_grad_norm=10.0), jax.random.PRNGKey(0))
    restored = JCK.restore_checkpoint(path, jstate)
    flat = JCK._flatten_state({"params": restored[0], "opt_state": restored[1], "step": restored[2]})
    with np.load(path) as d:
        files = {k: d[k] for k in d.files}
    assert set(files) == set(flat) and int(restored[2]) == 7
    assert "['params']['conv1_1_p']['weights']" in files and files["['params']['score_conv5']['weights']"].shape[2] == 256
    for k, v in files.items():
        assert np.array_equal(np.asarray(flat[k]), v), k
    jpath = JCK.save_checkpoint(str(tmp_path / "jax"), restored, 7, prefix="rgbd")
    fresh = T.create_train_state(make_model(cfg, init_params_numpy(6, cfg), "cpu"), hp)
    CK.restore_checkpoint(jpath, fresh)
    assert fresh.step == 7
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.trace, fresh.optimizer.trace):
        assert torch.equal(a, b)


def test_jax_test_net_builds_color_so_an_rgbd_snapshot_fails_in_its_forward(tmp_path):
    """A fault of the JAX package, called: tools/test_net.py builds its
    model config without input_format (COLOR), and `restore_checkpoint`
    puts an RGBD snapshot's 128-wide score_conv5 into the 64-wide slot
    without a check, so the forward fails on the shape. A DEPTH snapshot
    loads (the shapes are COLOR's) and is scored on colour frames. The
    port's `restore_params` raises ValueError naming the shape instead, and
    reads a DEPTH snapshot."""
    cfg, jcfg = _rgbd_cfgs()
    state = T.create_train_state(make_model(cfg, init_params_numpy(5, cfg), "cpu"), T.TrainHParams())
    path = CK.save_checkpoint(str(tmp_path), state, 1, prefix="rgbd", include_opt_state=False)
    color = dataclasses.replace(jcfg, input_format="COLOR", is_train=False)
    assert JaxCfg().input_format == "COLOR"
    jstate = jax_create_train_state(color, JaxHP(), jax.random.PRNGKey(0))
    params = JCK.restore_checkpoint(path, jstate)[0]
    assert params["score_conv5"]["weights"].shape[2] == 256 and "conv1_1_p" not in params
    raw = np.zeros((1, 64, 80, 3), np.float32)
    meta = _small_batch("COLOR")["meta_data"][:1]
    with pytest.raises(ValueError, match="feature dimension"):
        jax_forward(params, color, jnp.asarray(raw), jnp.ones((22, 3)) * 0.1, jnp.asarray(meta))
    port_color = dataclasses.replace(cfg, input_format="COLOR", is_train=False)
    with pytest.raises(ValueError, match=r"\['score_conv5'\]\['weights'\] has shape \(1, 1, 256, 8\)"):
        CK.restore_params(path, param_shapes(port_color))
    # a DEPTH snapshot has COLOR's shapes: both packages read it
    depth_cfg = dataclasses.replace(cfg, input_format="DEPTH")
    dstate = T.create_train_state(make_model(depth_cfg, init_params_numpy(8, depth_cfg), "cpu"), T.TrainHParams())
    dpath = CK.save_checkpoint(str(tmp_path / "depth"), dstate, 1, prefix="depth", include_opt_state=False)
    got = CK.restore_params(dpath, param_shapes(port_color))
    ref = JCK.restore_checkpoint(dpath, jstate)[0]
    for layer, leaves in got.items():
        for leaf, a in leaves.items():
            np.testing.assert_array_equal(a, np.asarray(ref[layer][leaf]), err_msg=f"{layer}/{leaf}")


@pytest.mark.parametrize("fmt", ["COLOR", "DEPTH", "RGBD"])
@pytest.mark.parametrize("pose_reg", [False, True])
def test_param_shapes_are_the_init_shapes_and_a_missing_leaf_raises(tmp_path, fmt, pose_reg):
    """`param_shapes` gives the JAX-layout shape of every parameter that
    `init_params_numpy` draws (the upscore filters aside), and a snapshot
    that lacks one of the model's parameters is refused by name rather than
    scored with random weights in that layer."""
    cfg = dataclasses.replace(_rgbd_cfgs()[0], input_format=fmt, pose_reg=pose_reg, is_train=False)
    init = init_params_numpy(3, cfg)
    want = {k: {f: a.shape for f, a in v.items()} for k, v in init.items() if not k.startswith("upscore")}
    assert param_shapes(cfg) == want
    path = str(tmp_path / "p.npz")
    np.savez(path, **{f"['{k}']['{f}']": a for k, v in init.items() for f, a in v.items()})
    got = CK.restore_params(path, param_shapes(cfg))
    assert all(np.array_equal(got[k][f], init[k][f]) for k in want for f in want[k])
    np.savez(path, **{f"['{k}']['{f}']": a for k, v in init.items() for f, a in v.items() if k != "score"})
    with pytest.raises(ValueError, match=r"lacks 2 of the model's \d+ parameter tensors: \['score'\]\['weights'\]"):
        CK.restore_params(path, param_shapes(cfg))


class _SmallDepthFrames(LovSynVal):
    """v4 frames 0-3 at 64x80 (`make_torch_goldens.train_frames`)."""

    def load_frame(self, i):
        return G.train_frames((f"data/lov_syn_val_v4/{i:06d}.npz",), depth=True)[0]


def _no_pose_head_cfgs():
    kw = dict(SMALL, pose_reg=False)
    return PoseCNNConfig(compute_dtype=torch.float32, **kw), JaxCfg(compute_dtype=jnp.float32, **kw)


def test_test_net_without_the_pose_head_matches_jax():
    """test_net with the vertex head and no pose head (lov_single_depth's
    TEST section) against JAX's on 3 small frames: each frame's rois and
    poses (Hough's poses_init), and the evaluator's summary."""
    from posecnn_torch.data.imdb import PoseEvaluator
    from posecnn_tpu.data.imdb import PoseEvaluator as JaxEvaluator

    cfg, jcfg = _no_pose_head_cfgs()
    params = init_params_numpy(3, cfg)
    data = _SmallDepthFrames()
    ev = PoseEvaluator(data.classes, data._extents, data._points, [])
    jev = JaxEvaluator(data.classes, data._extents, data._points, [])
    res = PT.test_net(make_model(cfg, params, "cpu"), cfg, data, PIXEL_MEANS, evaluator=ev, max_frames=3,
                      nms_threshold=0.3, log=None)
    ref = JT.test_net(jax.tree_util.tree_map(jnp.asarray, params), jcfg, data, PIXEL_MEANS, evaluator=jev,
                      max_frames=3, nms_threshold=0.3, log=None)
    assert sum(r["rois"].shape[0] for r in res) > 0
    for r, j in zip(res, ref):
        np.testing.assert_array_equal(r["rois"][:, :2], j["rois"][:, :2])
        np.testing.assert_allclose(r["rois"], j["rois"], atol=1e-3)
        np.testing.assert_allclose(r["poses"], j["poses"], atol=1e-4)
    s, js = ev.summary(), jev.summary()
    assert s["seg_iou"] == js["seg_iou"] and s["mean_iou"] == js["mean_iou"]


def test_jax_test_net_without_the_vertex_head_raises_key_error():
    """A fault of the JAX package, called: its test_net on PoseCNN without
    the vertex head (TEST.VERTEX_REG_2D False, the scene cfgs) reads rois
    that its inference function never returns. The port refuses the config
    (`core.config.unsupported`) and its test_net raises ValueError."""
    from posecnn_torch.core import config as C

    cfg, jcfg = _no_pose_head_cfgs()
    cfg, jcfg = dataclasses.replace(cfg, vertex_reg=False), dataclasses.replace(jcfg, vertex_reg=False)
    params = init_params_numpy(3, cfg)
    with pytest.raises(KeyError, match="rois"):
        JT.test_net(jax.tree_util.tree_map(jnp.asarray, params), jcfg, _SmallDepthFrames(), PIXEL_MEANS, max_frames=1,
                    log=None)
    with pytest.raises(ValueError, match="VERTEX_REG_2D"):
        PT.test_net(make_model(cfg, params, "cpu"), cfg, _SmallDepthFrames(), PIXEL_MEANS, max_frames=1, log=None)
    scene = C.cfg_from_file(os.path.join(G.ROOT, "experiments", "cfgs", "rgbd_scene_single_rgbd.yml"))
    assert C.unsupported(scene, train=True) == [] and C.unsupported(scene, train=False) == [
        "TEST.VERTEX_REG_2D: False"]


def test_converter_round_trips_the_dual_tower():
    """`params_to_numpy` inverts the converter on an RGBD model: every layer
    of the JAX layout, the `_p` trunk under its own names, back equal."""
    cfg, _ = _rgbd_cfgs()
    params = init_params_numpy(2, cfg)
    back = params_to_numpy(make_model(cfg, params, "cpu").state_dict())
    assert sorted(back) == sorted(params) and "conv5_3_p" in back
    for layer, leaves in params.items():
        for leaf, a in leaves.items():
            np.testing.assert_array_equal(back[layer][leaf], a)


# ------------------------------------------------------------------ the CLIs

NARROW = dict(trunk_scale=0.125, fc_dim=64)
CFGS = os.path.join(G.ROOT, "experiments", "cfgs")


def _narrow(monkeypatch):
    """The CLIs' model configs at narrow widths (the trunk at 1/8, fc 64)."""
    from posecnn_torch.core import config as C

    for name in ("train_model_cfg", "test_model_cfg"):
        orig = getattr(C, name)
        monkeypatch.setattr(C, name, lambda cfg, n, _f=orig: dataclasses.replace(_f(cfg, n), **NARROW))


def test_train_net_rgbd_and_depth_clis_on_cpu(tmp_path, monkeypatch, capsys):
    """train_net --cfg rgbd_scene_single_rgbd.yml --imdb lov_syn_val_v4
    --iters 2 --device cpu (the dual tower at narrow widths, the host
    jitter and noise): finite losses, a snapshot with the `_p` trunk; then
    lov_single_depth.yml (DEPTH, the vertex head and Hough, no pose head)
    for 2 steps, and test_net --cfg on its snapshot (the COLOR model of the
    JAX CLI, no pose head); test_net --model of the RGBD snapshot raises
    ValueError naming the shape."""
    from posecnn_torch import test_net, train_net

    _narrow(monkeypatch)
    rgbd = tmp_path / "rgbd"
    assert train_net.main(["--cfg", os.path.join(CFGS, "rgbd_scene_single_rgbd.yml"), "--imdb", "lov_syn_val_v4",
                           "--iters", "2", "--device", "cpu", "--output", str(rgbd)]) == 0
    first = [ln for ln in capsys.readouterr().out.splitlines() if "iter 1/2" in ln][0]
    assert np.isfinite(float(first.split(" loss: ")[1].split()[0])) and "loss_vertex" not in first
    snap = rgbd / "vgg16_fcn_rgbd_single_iter_2.npz"
    with np.load(snap) as d:
        assert "['params']['conv5_3_p']['weights']" in d.files
    depth = tmp_path / "depth"
    cfg = os.path.join(CFGS, "lov_single_depth.yml")
    assert train_net.main(["--cfg", cfg, "--imdb", "lov_syn_val_v4", "--iters", "2", "--device", "cpu", "--output",
                           str(depth)]) == 0
    first = [ln for ln in capsys.readouterr().out.splitlines() if "iter 1/2" in ln][0]
    assert np.isfinite(float(first.split("loss_vertex: ")[1].split()[0])) and "loss_pose" not in first
    timing = json.loads((depth / "train_timing.json").read_text())
    assert timing["end_step"] == 2
    ev = tmp_path / "eval"
    assert test_net.main(["--cfg", cfg, "--imdb", "lov_syn_val_v4", "--max_frames", "2", "--device", "cpu",
                          "--model", str(depth / "vgg16_fcn_depth_single_iter_2.npz"), "--output", str(ev)]) == 0
    summary = json.loads((ev / "eval_summary.json").read_text())
    assert 0 <= summary["mean_iou"] <= 1 and json.loads((ev / "eval_timing.json").read_text())["frames"] == 2
    with pytest.raises(ValueError, match="score_conv5"):
        test_net.main(["--cfg", cfg, "--imdb", "lov_syn_val_v4", "--max_frames", "1", "--device", "cpu", "--model",
                       str(snap), "--output", str(tmp_path / "eval_rgbd")])


def test_device_bank_refuses_a_depth_input(tmp_path):
    """TPU.DEVICE_BANK holds raw COLOR frames: with another INPUT, train_net
    refuses, as the JAX CLI's assertion does (tools/train_net.py:331-336)."""
    from posecnn_torch import train_net

    cfg = tmp_path / "bank_depth.yml"
    cfg.write_text("INPUT: DEPTH\nTRAIN:\n  USE_FLIPPED: False\nTPU:\n  DEVICE_BANK: True\n")
    with pytest.raises(ValueError, match="COLOR"):
        train_net.main(["--cfg", str(cfg), "--imdb", "lov_syn_val_v4", "--iters", "1", "--device", "cpu",
                        "--output", str(tmp_path / "out")])
