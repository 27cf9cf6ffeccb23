"""The video models of the port against the JAX package: the voxel ops
(`ops/backproject.py`), the flow warp (`ops/compute_flow.py`), the GRU
cells (`models/gru.py`), `video_forward` and `video3d_forward`
(`models/video.py`), one `make_video_train_step`, the weights carried both
ways (`core/convert.py`), `Voxelizer` and the video data layer
(`data/video_layer.py`), and the video golden (`tests/golden/
torch_port_video.npz`, which `chip_smoke.py` phase 18 holds the card to).

Inputs come from numpy seeds. Tolerances: the voxel ops and the cast rule
exactly; the flow warp within 1e-6 of the state's largest magnitude and
its gradients within 1e-5 of theirs; the cells within 1e-6 relative; the
models at float32 and the full trunk width (32x32 frames, T=3, 8 units,
grid 6) within 1e-5 of each output's largest magnitude, labels equal away
from ties; the step's parameters within 1e-3 of their largest move (JAX
at float32, the same lr); batches and the voxelizer bit-equal.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.models import gru as JG
from posecnn_tpu.models import video as JV
from posecnn_tpu.ops import backproject as JB
from posecnn_tpu.ops.compute_flow import compute_flow as jax_compute_flow
from posecnn_torch.core import convert as CV
from posecnn_torch.engine.test import set_float32_precision
from posecnn_torch.models import gru as PG
from posecnn_torch.models import video as PV
from posecnn_torch.ops import backproject as PB
from posecnn_torch.ops import compute_flow as CF
from posecnn_torch.ops.compute_flow import compute_flow
from tests.torch_parity import (FLOW_CASES, FLOW_KERNEL, FLOW_THRESHOLD, check_video_golden, flow_warp_case,
                                flow_warp_indices, goldens, kfusion_on_golden, load_npz, mask_words, video_on_golden,
                                video_step_on_golden)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _f32_precision():
    set_float32_precision()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pose(a: float, t) -> np.ndarray:
    """[R|t] with R a rotation of `a` rad about (1, 2, 3)/|.|."""
    k = np.array([1.0, 2.0, 3.0]) / np.sqrt(14.0)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx
    return np.hstack([R, np.asarray(t, np.float64)[:, None]])


def _meta(B: int, K: np.ndarray, poses, grid=None) -> np.ndarray:
    """(B,48): K, K^-1, world2live = poses[b], live2world its inverse, the grid."""
    meta = np.zeros((B, 48), np.float32)
    for b in range(B):
        w2l = poses[b]
        R, t = w2l[:, :3], w2l[:, 3]
        meta[b, 0:9], meta[b, 9:18] = K.ravel(), np.linalg.inv(K).ravel()
        meta[b, 18:30] = w2l.ravel()
        meta[b, 30:42] = np.hstack([R.T, (-R.T @ t)[:, None]]).ravel()
        if grid is not None:
            meta[b, 42:45], meta[b, 45:48] = grid
    return meta


H, W = 12, 16
KMAT = np.array([[20.0, 0, 8.0], [0, 20.0, 6.0], [0, 0, 1.0]])


def _voxel_case(seed=0):
    """Two images: the first with the identity pose and a grid whose voxel
    (2, 2, 2) sits at the camera's centre (0/0 = NaN pixel: read at pixel
    0 by XLA's cast) and a plane of voxels at z = 0 (+-inf), depth 0 at
    pixel (0, 0); the second a rotated, moved camera with voxels behind it.
    Pixels without depth at a stride of (3, 4)."""
    rng = np.random.RandomState(seed)
    poses = [np.hstack([np.eye(3), np.zeros((3, 1))]), _pose(0.3, (0.05, -0.02, 0.1))]
    grid = (np.full(3, 0.25, np.float32), np.full(3, -0.5, np.float32))
    meta = _meta(2, KMAT, poses, grid)
    depth = rng.uniform(0.0, 0.8, (2, H, W)).astype(np.float32)
    depth[:, ::3, ::4] = 0.0
    depth[0, 0, 0] = 0.0
    return rng, meta, depth


@pytest.mark.parametrize("k", [1, 2, 3])
def test_backproject_matches_jax(k):
    """Voxels on the camera plane, behind the camera and out of the image,
    pixels without depth: top_data, top_label and top_flag exactly."""
    G, C = 6, 5
    rng, meta, depth = _voxel_case(k)
    data = rng.rand(2, H, W, C).astype(np.float32)
    lab3 = rng.rand(2, G, G, G, C).astype(np.float32)
    ref = JB.backproject(jnp.asarray(data), jnp.asarray(data), jnp.asarray(depth), jnp.asarray(meta),
                         jnp.asarray(lab3), G, k, 0.1)
    got = PB.backproject(torch.tensor(data), torch.tensor(data), torch.tensor(depth), torch.tensor(meta),
                         torch.tensor(lab3), G, k, 0.1)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    # the NaN voxel (camera centre) read pixel (0, 0)'s window: observed
    assert float(np.asarray(ref[2])[0, 2, 2, 2, 0]) == 1.0 == float(got[2][0, 2, 2, 2, 0])


def test_cast_rule_matches_xla():
    """NaN -> 0 and saturation, as XLA converts float32 to int32; a plain
    torch cast gives INT_MIN for every one of the first five."""
    x = np.array([np.nan, 1e10, -1e10, np.inf, -np.inf, 2.5, -2.5, 3.7, -3.7, 2147483520.0], np.float32)
    assert np.array_equal(PB.xla_int32(torch.tensor(x)).numpy(), np.asarray(jnp.asarray(x).astype(jnp.int32)))


def test_project_and_compute_label_match_jax():
    G, C = 6, 5
    rng, meta, depth = _voxel_case(4)
    vox = rng.rand(2, G, G, G, C).astype(np.float32)
    vox[0, :2] = 0.0  # ties at zero: the first class wins
    args = (jnp.asarray(vox), jnp.asarray(depth), jnp.asarray(meta), G)
    targs = (torch.tensor(vox), torch.tensor(depth), torch.tensor(meta), G)
    assert np.array_equal(np.asarray(JB.project(*args)), PB.project(*targs).numpy())
    assert np.array_equal(np.asarray(JB.compute_label(*args)), PB.compute_label(*targs).numpy())


@pytest.mark.parametrize("k", [1, 2, 3])
def test_compute_flow_matches_jax(k):
    """A moved, rotated camera; previous points NaN on a third of the
    pixels; current pixels without depth. Outputs, and the gradients of a
    weighted sum of both outputs with respect to the state and weights
    (the cotangent through the window's scatter), against JAX's vjp."""
    B, C = 2, 4
    rng = np.random.RandomState(10 + k)
    meta = _meta(B, KMAT, [_pose(0.02, (0.01, 0.0, 0.0)), _pose(-0.03, (0.0, 0.01, -0.01))])
    data = rng.randn(B, H, W, C).astype(np.float32)
    weights = rng.uniform(0.5, 80.0, (B, H, W, C)).astype(np.float32)  # some past max_weight 50
    depth = rng.uniform(0.9, 1.0, (B, H, W)).astype(np.float32)
    depth[:, ::3, ::2] = 0.0
    points = np.concatenate([rng.randn(B, H, W, 2), rng.uniform(0.9, 1.0, (B, H, W, 1))], -1).astype(np.float32)
    points[:, ::3] = np.nan
    g1, g2 = rng.randn(B, H, W, C).astype(np.float32), rng.randn(B, H, W, C).astype(np.float32)

    def jf(d, w):
        return jax_compute_flow(d, w, jnp.asarray(points), jnp.asarray(depth), jnp.asarray(meta), k, 0.05, 50.0)

    ref, vjp = jax.vjp(lambda d, w: jf(d, w)[:2], jnp.asarray(data), jnp.asarray(weights))
    ref_pts = jf(jnp.asarray(data), jnp.asarray(weights))[2]
    dd, dw = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    td, tw = torch.tensor(data, requires_grad=True), torch.tensor(weights, requires_grad=True)
    got = compute_flow(td, tw, torch.tensor(points), torch.tensor(depth), torch.tensor(meta), k, 0.05, 50.0)
    for a, b in zip(ref, got[:2]):
        a = np.asarray(a)
        assert float(np.abs(a - b.detach().numpy()).max()) <= 1e-6 * float(np.abs(a).max())
    p_ref, p_got = np.asarray(ref_pts), got[2].numpy()
    assert np.array_equal(np.isnan(p_ref), np.isnan(p_got)) and np.allclose(p_ref, p_got, atol=1e-6, equal_nan=True)
    matched = (np.asarray(ref[1]) != 1.0).any(-1)
    assert 0.2 < matched.mean() < 1.0  # some pixels matched, some did not
    (got[0] * torch.tensor(g1) + got[1] * torch.tensor(g2)).sum().backward()
    for a, b in ((dd, td.grad), (dw, tw.grad)):
        a = np.asarray(a)
        assert float(np.abs(a - b.numpy()).max()) <= 1e-5 * float(np.abs(a).max())


@pytest.mark.parametrize("case", FLOW_CASES)
def test_flow_warp_cases_reach_their_regimes(case):
    """`flow_warp_case`'s inputs, which the card tests and chip_smoke.py
    time and hold the kernels to, through the plain match: "all_match"
    matches every in-bound tap of every pixel, "identity" (the DA-RNN
    cell's, unrelated depths) a few, "rigid" many, with the pixels moved."""
    B, H, W, k = 2, 24, 32, FLOW_KERNEL
    v = flow_warp_indices(flow_warp_case(case, B, H, W, 4, seed=1))
    match = CF.match_plain(v["px"], v["py"], v["z1"], v["has_depth"], v["points"][..., 2].reshape(-1), k,
                           FLOW_THRESHOLD)
    inb = torch.stack([(v["px"] + dx >= 0) & (v["px"] + dx < W) & (v["py"] + dy >= 0) & (v["py"] + dy < H)
                       & v["has_depth"] for dx in range(-k, k + 1) for dy in range(-k, k + 1)])
    share = float(match.sum()) / float(inb.sum())
    moved = float((v["px"] != torch.arange(W))[v["has_depth"]].float().mean())
    if case == "all_match":
        assert torch.equal(match, inb) and bool(v["has_depth"].all()) and moved == 0.0
    elif case == "identity":
        assert share < 0.2 and moved == 0.0
    else:
        assert 0.3 < share < 1.0 and moved > 0.5 and not bool(v["has_depth"].all())
    words = mask_words(match)
    assert torch.equal((words >> 3) & 1, match[3].long()) and int(words.max()) < 2 ** (2 * k + 1) ** 2


def test_window_mean_backward_node_and_plain_dispatch():
    """What the benchmark's attribution reads: compute_flow's outputs come
    from autograd's `_WindowMeanBackward` node (`device_ms.flow_warp` owns
    its kernels, `device_ms.backward` leaves them out). A CPU tensor takes
    the plain version and launches no kernel."""
    x = flow_warp_case("rigid", 1, 12, 16, 4, seed=2)
    data = torch.from_numpy(x["data"]).requires_grad_(True)
    weights = torch.from_numpy(x["weights"]).requires_grad_(True)
    before = CF.FLOW_WARP_LAUNCHES
    d, w, _ = compute_flow(data, weights, torch.from_numpy(x["points"]), torch.from_numpy(x["depth"]),
                           torch.from_numpy(x["meta"]), FLOW_KERNEL, FLOW_THRESHOLD, 50.0)
    assert type(d.grad_fn).__name__ == "_WindowMeanBackward" and d.grad_fn is w.grad_fn
    (d.sum() + w.sum()).backward()
    assert data.grad is not None and weights.grad is not None and float(data.grad.abs().sum()) > 0
    assert CF.FLOW_WARP_LAUNCHES == before


def test_video_step_calls_compute_flow_through_its_module():
    """`models/video.py:video_step` reads `compute_flow` from its module at
    each call, so the benchmark's `bench:flow_warp` span, which patches
    `posecnn_torch.models.video:compute_flow`, wraps every frame's warp."""
    G = goldens()
    cfg = PV.VideoConfig(compute_dtype=torch.float32, **G.VIDEO_CFG)
    model = PV.make_video_model(cfg, G.video_params(), "cpu")
    x = {k: torch.from_numpy(v) for k, v in G.video_inputs().items()}
    calls, orig = [], PV.compute_flow

    def wrapped(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    PV.compute_flow = wrapped
    try:
        with torch.no_grad():
            PV.video_forward(model, cfg, x["data"], x["depth"], x["meta_data"])
    finally:
        PV.compute_flow = orig
    assert len(calls) == x["data"].shape[0] == cfg.num_steps


def _golden_video_model(three_d: bool, batch: int = 1):
    """(cfg, model, inputs) of the video golden at float32; `batch` > 1
    tiles its one video with mirrored copies of the frames."""
    G = goldens()
    cfg = (PV.Video3DConfig(compute_dtype=torch.float32, **G.VIDEO3D_CFG) if three_d
           else PV.VideoConfig(compute_dtype=torch.float32, **G.VIDEO_CFG))
    model = PV.make_video_model(cfg, G.video_params(three_d=three_d), "cpu")
    x = {k: torch.from_numpy(v) for k, v in G.video_inputs(three_d=three_d).items()}
    if batch > 1:
        flips = [x["data"]] + [x["data"].flip(3 if b % 2 else 2) for b in range(1, batch)]
        x = {k: torch.cat(flips, 1) if k == "data" else torch.cat([v] * batch, 1) for k, v in x.items()}
    return cfg, model, x


def _per_frame_forward(model, cfg, x):
    """The window frame by frame, each frame's trunk run by its own step
    (`upscore=None`, as the online eval runs them): (outputs stacked over T,
    the final state)."""
    T, B, H, W, _ = x["data"].shape
    if isinstance(cfg, PV.Video3DConfig):
        step, state = PV.video3d_step, PV.init_video3d_state(B, cfg.grid_size, cfg.num_classes)
    else:
        step, state = PV.video_step, PV.init_video_state(B, H, W, cfg.num_units)
    outs = []
    for t in range(T):
        out, state = step(model, cfg, x["data"][t], x["depth"][t], x["meta_data"][t], state)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}, state


def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """|got - ref| / |ref| in L2, NaN where both hold one left out."""
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    got, ref = torch.nan_to_num(got.double()), torch.nan_to_num(ref.double())
    return float(torch.linalg.vector_norm(got - ref)) / max(float(torch.linalg.vector_norm(ref)), 1e-30)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("three_d", [False, True], ids=["VideoNet", "Video3DNet"])
def test_window_trunk_pass_equals_per_frame_steps(three_d, batch):
    """`video_forward` and `video3d_forward` run the trunk once over the
    window's T·B frames; each frame's score, its probabilities and the
    final state equal those of the frames run one by one through their
    own steps, within 1e-5 in relative L2 (batched float32 convolutions sum
    in another order than one frame's), with one video and with two (the
    second mirrored, so a frame handed the wrong slice shows)."""
    cfg, model, x = _golden_video_model(three_d, batch)
    fwd = PV.video3d_forward if three_d else PV.video_forward
    with torch.no_grad():
        outs, state = fwd(model, cfg, x["data"], x["depth"], x["meta_data"])
        ref_outs, ref_state = _per_frame_forward(model, cfg, x)
    keys = ("score", "prob_normalized") if three_d else ("score", "prob")
    states = (state,) if three_d else state
    ref_states = (ref_state,) if three_d else ref_state
    gaps = {k: _rel_l2(outs[k], ref_outs[k]) for k in keys}
    gaps.update({f"state{i}": _rel_l2(a, b) for i, (a, b) in enumerate(zip(states, ref_states))})
    assert max(gaps.values()) <= 1e-5, gaps
    assert outs["score"].shape == ref_outs["score"].shape == (cfg.num_steps, batch, 32, 32, cfg.num_classes)
    assert float(outs["score"].abs().max()) > 0


@pytest.mark.parametrize("batch", [1, 2])
def test_window_trunk_step_gradients_equal_per_frame_steps(batch, monkeypatch):
    """One `make_video_train_step` with the window's one trunk pass and one
    with the frames run one by one: every parameter's gradient within 1e-5
    in relative L2, and the same loss terms within 1e-5."""
    from posecnn_torch.engine import train as T

    G = goldens()
    hp = T.TrainHParams(**G.VIDEO_HP)
    results = []
    for per_frame in (False, True):
        cfg, model, x = _golden_video_model(False, batch)
        if per_frame:
            monkeypatch.setattr(PV, "video_forward", lambda m, c, d, z, md: _per_frame_forward(m, c, dict(
                data=d, depth=z, meta_data=md)))
        state = T.create_train_state(model, hp)
        m = T.make_video_train_step(cfg, hp)(state, x)
        results.append(({k: float(v) for k, v in m.items()},
                         {n: p.grad.clone() for n, p in model.named_parameters()}))
    (m, grads), (m_ref, grads_ref) = results
    assert set(grads) == set(grads_ref) and len(grads) > 20
    gaps = {n: _rel_l2(grads[n], grads_ref[n]) for n in grads}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1e-5, (worst, gaps[worst])
    assert float(grads["trunk.conv1_1.weight"].abs().max()) > 0
    for k in ("loss", "loss_cls", "loss_regu", "grad_norm"):
        assert abs(m[k] - m_ref[k]) <= 1e-5 * abs(m_ref[k]), (k, m[k], m_ref[k])


@pytest.mark.parametrize("alone", [False, True], ids=["window", "one_frame"])
@pytest.mark.parametrize("three_d", [False, True], ids=["VideoNet", "Video3DNet"])
def test_window_runs_the_trunk_once_and_each_frame_through_its_step(three_d, alone, monkeypatch):
    """What the benchmark's probes read: `VGGTrunk.forward`, patched on its
    class as the `bench:trunk` span map patches it, runs once a window over
    its T·B frames; the step function, looked up in its module, is reached
    T times, and each frame's score it returns is the window's and takes a
    gradient hook (the DA-RNN benchmark cell's frame probe). A frame given
    alone to the step with no `upscore`, as `engine/test.py:test_net_video`
    gives them, runs the trunk itself over that frame's B rows."""
    from posecnn_torch.models.backbone import VGGTrunk

    B = 2
    cfg, model, x = _golden_video_model(three_d, batch=B)
    rows, scores, hooked = [], [], []
    orig_trunk = VGGTrunk.forward

    def trunk(self, data, *a, **k):
        rows.append(data.shape[0])
        return orig_trunk(self, data, *a, **k)

    name = "video3d_step" if three_d else "video_step"
    orig_step = getattr(PV, name)

    def frame_probe(*a, **k):
        out, state = orig_step(*a, **k)
        t = len(scores)
        out["score"].register_hook(lambda g: hooked.append(t))
        scores.append(out["score"].detach().clone())
        return out, state

    monkeypatch.setattr(VGGTrunk, "forward", trunk)
    monkeypatch.setattr(PV, name, frame_probe)
    if alone:
        state = (PV.init_video3d_state(B, cfg.grid_size, cfg.num_classes) if three_d
                 else PV.init_video_state(B, 32, 32, cfg.num_units))
        out, _ = getattr(PV, name)(model, cfg, x["data"][0], x["depth"][0], x["meta_data"][0], state)
        outs, T = {"score": out["score"][None]}, 1
    else:
        fwd = PV.video3d_forward if three_d else PV.video_forward
        outs, _ = fwd(model, cfg, x["data"], x["depth"], x["meta_data"])
        T = cfg.num_steps
    assert rows == [T * B]
    assert len(scores) == T and all(torch.equal(s, outs["score"][t]) for t, s in enumerate(scores))
    outs["score"].sum().backward()
    assert sorted(hooked) == list(range(T))


@pytest.mark.parametrize("fault", ["kernel_size", "dtype", "pixels", "shape", "devices"])
def test_flow_warp_kernel_inputs_are_checked(fault):
    """What the kernels cannot take raises before a launch (the wrapper
    falls back to nothing): a window past 7x7 (a pixel's 64-bit mask),
    other than float32 state, other than int32 pixels, mismatched shapes,
    inputs on more than one device."""
    v = flow_warp_indices(flow_warp_case("all_match", 1, 8, 8, 4))
    args = dict(v, kernel_size=FLOW_KERNEL)
    if fault == "kernel_size":
        args["kernel_size"] = CF.MAX_KERNEL_SIZE + 1
    elif fault == "dtype":
        args["data"] = args["data"].double()
    elif fault == "pixels":
        args["px"] = args["px"].long()
    elif fault == "shape":
        args["points"] = args["points"][..., :2]
    else:
        args["z1"] = args["z1"].to("meta")
    CF.check_kernel_inputs(**dict(v, kernel_size=FLOW_KERNEL))
    with pytest.raises((ValueError, TypeError)):
        CF.check_kernel_inputs(**args)


def _cell_inputs(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(2)] + [rng.uniform(1, 3, shape).astype(np.float32)]


@pytest.mark.parametrize("cell", ["gru2d", "gru2d_original", "vanilla2d", "add2d", "gru3d"])
def test_gru_cells_match_jax(cell):
    """Each cell from JAX's init (random gates for GRU2D and GRU3D, whose
    init is zero: checked separately) against JAX's function."""
    U = C = 4
    key = jax.random.PRNGKey(3)
    rng = np.random.RandomState(5)
    x, h, w = _cell_inputs(1, (2, 6, 7, U))
    tx, th, tw = torch.tensor(x), torch.tensor(h), torch.tensor(w)
    if cell == "add2d":
        ref, got = JG.add2d(jnp.asarray(x), jnp.asarray(h), 3), PG.add2d(tx, th, 3)
    elif cell == "gru3d":
        x, h, _ = _cell_inputs(2, (1, 3, 3, 3, U))
        flag = (rng.rand(1, 3, 3, 3, 1) > 0.5).astype(np.float32)
        p = _np(JG.init_gru3d(key, U, C))
        assert not p["Gates"]["weights"].any()
        p["Gates"]["weights"] = rng.randn(2 * U, U).astype(np.float32)
        p["Gates"]["biases"] = rng.randn(U).astype(np.float32)
        m = PG.GRU3D(U, C)
        m.load_state_dict({k.split(".", 1)[1]: v for k, v in CV.params_from_numpy({"gru3d": p}).items()})
        ref = JG.gru3d(p, jnp.asarray(x), jnp.asarray(flag), jnp.asarray(h))
        got = PG.gru3d(m, torch.tensor(x), torch.tensor(flag), torch.tensor(h))
    else:
        init = {"gru2d": JG.init_gru2d, "gru2d_original": JG.init_gru2d_original, "vanilla2d": JG.init_vanilla2d}
        p = _np(init[cell](key, U, C))
        if cell == "gru2d":
            assert not p["Gates"]["weights"].any()
            p["Gates"]["weights"] = rng.randn(1, 1, 2 * U, U).astype(np.float32)
            p["Gates"]["biases"] = rng.randn(U).astype(np.float32)
        mod = {"gru2d": PG.GRU2D, "gru2d_original": PG.GRU2DOriginal, "vanilla2d": PG.Vanilla2D}[cell](U, C)
        sd = {}
        for sub, leaves in p.items():
            for leaf, a in leaves.items():
                a = np.asarray(a)
                sd[f"{sub}.{'weight' if leaf == 'weights' else 'bias'}"] = torch.tensor(a.transpose(3, 2, 0, 1).copy()
                                                                                       if a.ndim == 4 else a)
        mod.load_state_dict(sd)
        fn = {"gru2d": JG.gru2d, "gru2d_original": JG.gru2d_original, "vanilla2d": JG.vanilla2d}[cell]
        pfn = {"gru2d": PG.gru2d, "gru2d_original": PG.gru2d_original, "vanilla2d": PG.vanilla2d}[cell]
        jargs = (jnp.asarray(x), jnp.asarray(h)) + ((jnp.asarray(w),) if cell == "gru2d" else ())
        ref = fn(p, *jargs)
        got = pfn(mod, tx, th, *((tw,) if cell == "gru2d" else ()))
    for a, b in zip(ref, got):
        a = np.asarray(a)
        assert float(np.abs(a - b.detach().numpy()).max()) <= 1e-6 * max(float(np.abs(a).max()), 1.0), cell


def test_cell_inits_and_zero_gates():
    """Each cell's init has JAX's tree and shapes (GRU2D's and GRU3D's
    exactly: zeros); the zero gates give u = 0.5."""
    key, rng = jax.random.PRNGKey(0), np.random.default_rng(0)
    for ours, theirs in ((PG.init_gru2d_numpy(4, 6), JG.init_gru2d(key, 4, 6)),
                         (PG.init_gru3d_numpy(4, 6), JG.init_gru3d(key, 4, 6)),
                         (PG.init_gru2d_original_numpy(rng, 4, 6), JG.init_gru2d_original(key, 4, 6)),
                         (PG.init_vanilla2d_numpy(rng, 4, 6), JG.init_vanilla2d(key, 4, 6))):
        assert jax.tree_util.tree_map(np.shape, ours) == jax.tree_util.tree_map(np.shape, _np(theirs))
    for zero in (PG.init_gru2d_numpy(4, 6), PG.init_gru3d_numpy(4, 6)):
        assert not any(a.any() for a in jax.tree_util.tree_leaves(zero))
    cell = PG.GRU3D(2, 2)
    cell.load_state_dict({k.split(".", 1)[1]: v for k, v in
                          CV.params_from_numpy({"gru3d": PG.init_gru3d_numpy(2, 2)}).items()})
    x, h = torch.rand(1, 2, 2, 2, 2), torch.rand(1, 2, 2, 2, 2)
    out, _ = PG.gru3d(cell, x, torch.ones(1, 2, 2, 2, 1), h)
    assert torch.allclose(out, 0.5 * (x + h))


def test_video_params_round_trip_jax_trees():
    """JAX's init_video_params and init_video3d_params trees (three-level
    cell keys, upscore filters) load into the port's models, nested and as
    flat npz key paths with `['params']`, and come back equal leaf for
    leaf; param_shapes gives their shapes."""
    for jcfg, pcfg, init in ((JV.VideoConfig(num_classes=5, num_units=8), PV.VideoConfig(num_classes=5, num_units=8),
                              JV.init_video_params),
                             (JV.Video3DConfig(num_classes=4, num_units=8), PV.Video3DConfig(num_classes=4, num_units=8),
                              JV.init_video3d_params)):
        tree = _np(init(jax.random.PRNGKey(2), jcfg))
        flat = {"['params']" + "".join(f"['{p.key}']" for p in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        flat["['step']"] = np.asarray(5)
        for src in (tree, flat):
            model = PV.make_video_model(pcfg, src, "cpu")
            back = CV.params_to_numpy(model.state_dict())
            assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
            for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree_util.tree_leaves(back)):
                assert a.shape == b.shape and np.array_equal(a, b), path
        shapes = CV.param_shapes(pcfg, "vgg16_3d" if isinstance(pcfg, PV.Video3DConfig) else "vgg16")
        want = {k: jax.tree_util.tree_map(np.shape, v) for k, v in tree.items() if not k.startswith("upscore")}
        assert shapes == want
    with pytest.raises(ValueError, match="unexpected parameter key"):
        CV.params_from_numpy({"['params']['score']['a']['b']": np.zeros(1)})


def test_video_forward_matches_jax_golden_and_jax():
    """video_forward, video3d_forward, one make_video_train_step and the
    KinectFusion track against the committed golden (`check_video_golden`'s
    limits); and video_forward against JAX run now (the golden is current)."""
    G = goldens()
    g = load_npz(G.VIDEO_GOLDEN)
    video, video3d = video_on_golden(), video_on_golden(three_d=True)
    err = check_video_golden(video, video3d, video_step_on_golden(), kfusion_on_golden(), g)
    assert err["video/score"] <= 1e-5 and err["video3d/score"] <= 1e-5
    assert g["video3d/flag_3d"].mean() > 0.05 and len(np.unique(g["video/label_2d"])) > 1
    cfg = JV.VideoConfig(compute_dtype=jnp.float32, **G.VIDEO_CFG)
    x = G.video_inputs()
    outs, _ = JV.video_forward(jax.tree_util.tree_map(jnp.asarray, G.video_params()), cfg, jnp.asarray(x["data"]),
                               jnp.asarray(x["depth"]), jnp.asarray(x["meta_data"]))
    np.testing.assert_allclose(np.asarray(outs["score"]), g["video/score"], rtol=1e-6, atol=1e-7)


def test_video_step_decays_lr_as_jax():
    """Two video steps across STEPSIZE: the lr of each and the ratio of the
    second update to the first as JAX's (`tests/test_train.py:459`), and
    the parameters after both within 1e-3 of JAX's largest move."""
    from posecnn_tpu.engine.train import TrainHParams as JHP
    from posecnn_tpu.engine.train import make_optimizer, make_video_train_step as jax_step
    from posecnn_tpu.parallel.mesh import MeshSpec, make_mesh
    from posecnn_torch.engine import train as T

    G = goldens()
    hp_kw = dict(G.VIDEO_HP, stepsize=1)
    x = G.video_inputs()
    jcfg = JV.VideoConfig(compute_dtype=jnp.float32, **G.VIDEO_CFG)
    step = jax_step(jcfg, JHP(**hp_kw), make_mesh(MeshSpec(data=1, model=1)))
    p = jax.tree_util.tree_map(jnp.asarray, G.video_params())
    st = (p, make_optimizer(JHP(**hp_kw)).init(p), jnp.asarray(0, jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in x.items()}
    ref_lr, ref_p = [], []
    for _ in range(2):
        st, m = step(st, jb)
        ref_lr.append(float(m["lr"]))
        ref_p.append(_np(st[0]))
    pcfg = PV.VideoConfig(compute_dtype=torch.float32, **G.VIDEO_CFG)
    hp = T.TrainHParams(**hp_kw)
    state = T.create_train_state(PV.make_video_model(pcfg, G.video_params(), "cpu"), hp)
    pstep = T.make_video_train_step(pcfg, hp)
    tb = {k: torch.from_numpy(v) for k, v in x.items()}
    lrs, after = [], []
    for _ in range(2):
        lrs.append(float(pstep(state, tb)["lr"]))
        after.append(CV.params_to_numpy(state.model.state_dict()))
    assert lrs == pytest.approx(ref_lr, rel=1e-6) and lrs[1] == pytest.approx(0.1 * lrs[0])
    p0 = G.video_params()
    for name in ("score", "gru2d", "conv3_1"):
        a0 = jax.tree_util.tree_leaves(p0[name])[-1]
        r1, r2 = (jax.tree_util.tree_leaves(r[name])[-1] for r in ref_p)
        g1, g2 = (jax.tree_util.tree_leaves(r[name])[-1] for r in after)
        move = float(np.abs(r2 - a0).max())
        assert float(np.abs(g2 - r2).max()) <= 1e-3 * move, name
        # the second update is 0.1 x the lr on top of the momentum trace
        assert float(np.abs((g2 - g1) - (r2 - r1)).max()) <= 1e-3 * float(np.abs(r2 - r1).max()) + 1e-12, name


def test_voxelizer_matches_jax():
    from posecnn_tpu.utils.voxelizer import Voxelizer as JVox
    from posecnn_torch.utils.voxelizer import Voxelizer

    rng = np.random.RandomState(0)
    pts = rng.randn(100, 3)
    pts[5] = np.nan
    a, b = JVox(grid_size=32, margin=0.05), Voxelizer(grid_size=32, margin=0.05)
    a.voxelize(pts)
    b.voxelize(pts)
    b.voxelize(pts + 10)  # a fitted grid stays
    assert np.array_equal(a.meta_fields(), b.meta_fields())
    depth = rng.uniform(0, 2, (6, 8)).astype(np.float32)
    RT = _pose(0.2, (0.1, 0.2, 0.3))
    assert np.array_equal(a.backproject_camera(depth, KMAT, 1000.0), b.backproject_camera(depth, KMAT, 1000.0))
    assert np.array_equal(a.backproject_world(depth, KMAT, RT), b.backproject_world(depth, KMAT, RT))


@pytest.fixture(scope="module")
def lov_tree(tmp_path_factory):
    """A YCB-Video tree of v4 frames 0-9: video 0000 of 8 frames, 0001 of 2
    (shorter than a window: the draw retries)."""
    from tests.torch_parity import write_lov_tree

    root = str(tmp_path_factory.mktemp("video_data"))
    write_lov_tree(root, frames=range(10), syn_frames=range(0))
    return root


def test_gt_data_layer_matches_jax(lov_tree, monkeypatch):
    """GtDataLayer's first 3 batches (T=5, two videos a batch) bit-equal to
    JAX's, the RandomState left in step; group_by_video as JAX's."""
    from posecnn_tpu.data import factory as JF
    from posecnn_tpu.data import minibatch as JM
    from posecnn_tpu.data.video_layer import GtDataLayer as JLayer
    from posecnn_tpu.data.video_layer import group_by_video as jax_group
    from posecnn_torch.data import factory as F
    from posecnn_torch.data import minibatch as M
    from posecnn_torch.data.video_layer import GtDataLayer, group_by_video

    monkeypatch.setenv("POSECNN_DATA", lov_tree)
    a, b = JF.get_imdb("lov_train"), F.get_imdb("lov_train")
    assert group_by_video(b.image_index) == jax_group(a.image_index) and len(group_by_video(b.image_index)) == 2
    assert group_by_video(["x", "y"]) == {"all": [0, 1]}
    ja = JLayer(a, JM.MinibatchConfig(num_classes=22), num_steps=5, ims_per_batch=2, seed=3)
    pb = GtDataLayer(b, M.MinibatchConfig(num_classes=22), num_steps=5, ims_per_batch=2, seed=3)
    for _ in range(3):
        x, y = ja.forward(), next(iter(pb))
        assert sorted(x) == sorted(y) == ["data", "depth", "gt_label_2d", "meta_data"]
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and np.array_equal(x[k], y[k]), k
    assert y["data"].shape == (5, 2, 480, 640, 3)
    eye = np.hstack([np.eye(3), np.zeros((3, 1))]).ravel()
    assert np.array_equal(y["meta_data"][..., 18:30], np.broadcast_to(eye, (5, 2, 12)))  # no camera_pose
    assert ja.rng.randint(1 << 30) == pb.rng.randint(1 << 30)
    with pytest.raises(RuntimeError, match="long enough"):
        GtDataLayer(b, M.MinibatchConfig(num_classes=22), num_steps=9).forward()
