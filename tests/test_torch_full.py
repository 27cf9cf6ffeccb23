"""VGG16FULL (`posecnn_torch/models/posecnn_full.py`) against the JAX
package's `posecnn_tpu/models/posecnn_full.py`.

The inference function against the FULL golden (float32: the dense maps
within 1e-5 of their largest magnitude, labels and valid rows exact, rois
1e-3, poses_init 1e-4, poses_tanh 1e-5: `tests/torch_parity.py:
check_full_golden`); the training forward (keep 0.5 with JAX's dropout
draws replayed, the 0.7 hard-label gate, Hough's training rows through
JAX's Pallas vote kernel in interpret mode); one `make_train_step` step
against JAX's `make_train_step(forward_fn=posecnn_full_forward,
ce_threshold=0.7)` (losses 1e-5 relative, every parameter's update within
5e-5 of its largest move); snapshots in the JAX layout both ways; the
refusals of what JAX's step cannot run; and `train_net` / `test_net --cfg
lov_color_2d_full.yml` on the CPU at narrow widths.

Frames: v4/000000 and 000001 at 64x80 (`make_torch_goldens.train_frames`:
unpadded, so no flat regions whose 2x2 max-pool ties break on rounding),
22 classes, NUM_UNITS 8, the trunk at 1/4 width, fc 64. The GT pose rows
are placed at the network's own detections (class and translation), so
that Hough assigns pose targets and the pose branch trains.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.models.posecnn_full as JF
import posecnn_tpu.ops.pallas.voting as JV
from posecnn_tpu.core import checkpoint as JCK
from posecnn_tpu.engine.train import TrainHParams as JaxHP
from posecnn_tpu.engine.train import compute_losses as jax_compute_losses
from posecnn_tpu.engine.train import make_optimizer
from posecnn_tpu.engine.train import make_train_step as jax_make_train_step
from posecnn_tpu.models.posecnn import PoseCNNConfig as JaxCfg
from posecnn_tpu.ops.hough_voting import hough_voting as jax_hough_voting
from posecnn_tpu.parallel.mesh import MeshSpec, make_mesh
from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.core import checkpoint as CK
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import init_params_numpy, make_model, param_shapes, params_to_numpy
from posecnn_torch.engine import train as T
from posecnn_torch.engine.test import set_float32_precision
from posecnn_torch.models import posecnn_full as PF
from posecnn_torch.models.posecnn import posecnn_forward
from posecnn_torch.ops.hard_label import hard_label
from tests.torch_parity import check_full_golden, full_on_golden, goldens, gt_rows_at_detections, load_npz, t

G = goldens()
FULL_CFG = os.path.join(G.ROOT, "experiments", "cfgs", "lov_color_2d_full.yml")
# the training config: FULL_CFG of the golden, in training, dropout at 0.5
TRAIN_KW = {**G.FULL_CFG, "is_train": True, "keep_prob": 0.5}
HP = dict(learning_rate=1.0, momentum=0.9, gamma=0.1, stepsize=80000, weight_reg=0.0001)


@pytest.fixture(autouse=True)
def _f32_precision():
    set_float32_precision()


def _cfg(**over) -> PoseCNNConfig:
    return PoseCNNConfig(compute_dtype=torch.float32, **{**TRAIN_KW, **over})


def _jax(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _draws(rng, units: int, shape=(2, 64, 80)) -> dict:
    """JAX's two dropout draws of posecnn_full_forward under `rng`, as the
    port's named uniforms (`bernoulli(key, p, s)` is `uniform(key, s) < p`)."""
    r1, r2 = jax.random.split(rng)
    return {"dropout/fused": torch.from_numpy(np.array(jax.random.uniform(r1, shape + (units,)))),
            "dropout/fused_vertex": torch.from_numpy(np.array(jax.random.uniform(r2, shape + (units,))))}


def _batch_with_gt_at_detections(params, draws):
    """(batch, points, symmetry, extents): the small training batch
    (chroma deltas, no noise), its GT pose rows replaced by one a
    detection of the training forward (its image, class and Hough's
    translation; a seeded rotation), so that Hough matches them."""
    batch, points, symmetry, extents = G.train_inputs()
    cfg = _cfg()
    bt = T.to_device(batch, "cpu")
    with torch.no_grad():
        data = T.preprocess(bt["data"], T.TrainHParams(), bt, None)
        out = PF.posecnn_full_forward(PF.make_full_model(cfg, params, "cpu"), cfg, data, t(extents), bt["meta_data"],
                                      gt_poses=bt["poses"], gt_label_2d=bt["gt_label_2d"], draws=T.Draws(replay=draws))
    batch["poses"] = gt_rows_at_detections(out, batch["poses"])
    return batch, points, symmetry, extents


@pytest.mark.parametrize("net", ["full", "adapt"])
def test_gt_rows_at_detections_train_the_pose_branch(net):
    """chip_smoke.py phase 14 (b)'s batch, at the golden's small widths:
    one training forward with its draws recorded, the GT pose rows put at
    its detections (`gt_rows_at_detections`), then the step on that batch
    with the draws replayed. VGG16FULL and PoseCNN with the domain head
    (TRAIN.ADAPT): loss_pose 0 on the batch as drawn, > 0 on the new one,
    and the gradients of fc6, fc7, fc8 (FULL's `poses_pred_unnormalized`)
    and conv5_3 (read through the crop pool) non-zero."""
    full = net == "full"
    cfg = _cfg(adaptation=not full)
    params = (PF.init_posecnn_full_params_numpy if full else init_params_numpy)(G.FULL_SEED, cfg)
    make = PF.make_full_model if full else make_model
    forward = PF.posecnn_full_forward if full else posecnn_forward
    kw = dict(forward_fn=forward, ce_threshold=PF.CE_THRESHOLD if full else None)
    batch, points, symmetry, extents = G.train_inputs()
    consts = (t(points), t(symmetry), t(extents))
    hp = T.TrainHParams(**HP)
    outs = []

    def recording(*a, **k):
        outs.append(forward(*a, **k))
        return outs[-1]

    gen = torch.Generator()
    gen.manual_seed(0)
    draws = T.Draws(gen, record=True)
    with torch.no_grad():
        _, drawn = T.compute_losses(make(cfg, params, "cpu"), cfg, hp, T.to_device(batch, "cpu"), *consts, draws,
                                    recording, kw["ce_threshold"])
    assert float(drawn["loss_pose"]) == 0.0
    batch["poses"] = gt_rows_at_detections(outs[0], batch["poses"])
    assert batch["poses"][:, 1].astype(bool).sum() >= 2
    state = T.create_train_state(make(cfg, params, "cpu"), hp)
    got = T.make_train_step(cfg, hp, *consts, **kw)(state, T.to_device(batch, "cpu"), T.Draws(replay=draws.recorded))
    assert float(got["loss_pose"]) > 0
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    for k in ("fc6.weight", "fc7.weight", "poses_pred_unnormalized.weight" if full else "fc8.weight",
              "trunk.conv5_3.weight"):
        assert float(grads[k].abs().max()) > 0, k


def test_full_golden_is_current():
    """The committed FULL golden equals JAX run again now."""
    g, ref = G.full_golden(), load_npz(G.FULL_GOLDEN)
    assert sorted(g) == sorted(ref)
    for k in g:
        if np.asarray(g[k]).dtype.kind == "f":
            np.testing.assert_allclose(g[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            assert np.array_equal(np.asarray(g[k]), ref[k]), k
    assert ref["out/rois_valid"].sum() >= 2 and os.path.getsize(G.FULL_GOLDEN) < 4 << 20


def test_full_inference_matches_jax_golden():
    """`make_inference_fn` with `posecnn_full_forward` (the crop-pooled pose
    branch at inference) against JAX's on the golden's inputs and weights,
    at `check_full_golden`'s limits."""
    err = check_full_golden(*full_on_golden("cpu"))
    assert err["rois"] <= 1e-3


def test_full_training_forward_matches_jax(monkeypatch):
    """The training forward (keep 0.5, JAX's draws replayed, GT rows) on
    the same float data: score, vertex_pred and poses_pred within 1e-5 of
    their largest magnitude; label_2d and gt_label_weight (the 0.7 gate,
    not threshold_label) exact; Hough's valid rows, classes, targets and
    weights exact, rois within 1e-3, poses_init within 1e-4 (its vote
    kernel in Pallas interpret mode on the JAX side)."""
    params = PF.init_posecnn_full_params_numpy(G.FULL_SEED, _cfg())
    rng = jax.random.PRNGKey(5)
    draws = _draws(rng, _cfg().num_units)
    batch, _, _, extents = _batch_with_gt_at_detections(params, draws)
    bt = T.to_device(batch, "cpu")
    data = T.preprocess(bt["data"], T.TrainHParams(), bt, None)
    cfg = _cfg(threshold_label=0.01)  # the gate must stay 0.7 whatever this says
    with torch.no_grad():
        got = PF.posecnn_full_forward(PF.make_full_model(cfg, params, "cpu"), cfg, data, t(extents),
                                      bt["meta_data"], gt_poses=bt["poses"], gt_label_2d=bt["gt_label_2d"],
                                      draws=T.Draws(replay=draws))
    orig = JV._votes_pallas
    monkeypatch.setattr(JV, "_votes_pallas", lambda s, c, block, interpret: orig(s, c, block, True))
    monkeypatch.setattr(JF, "hough_voting", functools.partial(jax_hough_voting, use_pallas=True))
    jcfg = JaxCfg(compute_dtype=jnp.float32, **{**TRAIN_KW, "threshold_label": 0.01})
    fwd = jax.jit(lambda p, d, e, m, g, lab, r: JF.posecnn_full_forward(p, jcfg, d, e, m, g, lab, r))
    ref = fwd(_jax(params), jnp.asarray(data.numpy()), jnp.asarray(extents), jnp.asarray(batch["meta_data"]),
              jnp.asarray(batch["poses"]), jnp.asarray(batch["gt_label_2d"]), rng)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    for k in ("score", "vertex_pred", "poses_pred"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=1e-5 * np.abs(ref[k]).max(), err_msg=k)
    for k in ("label_2d", "gt_label_weight", "rois_valid", "poses_target", "poses_weight"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_array_equal(got["rois"][:, :2].numpy(), ref["rois"][:, :2])
    np.testing.assert_allclose(got["rois"].numpy(), ref["rois"], atol=1e-3)
    np.testing.assert_allclose(got["poses_init"].numpy(), ref["poses_init"], atol=1e-4)
    assert ref["poses_weight"].sum() > 0 and got["rois"].shape[0] == 2 * 4 * 9
    prob, gt = got["prob_normalized"], bt["gt_label_2d"]
    assert torch.equal(got["gt_label_weight"], hard_label(prob, gt, 0.7))
    assert not torch.equal(got["gt_label_weight"], hard_label(prob, gt, cfg.threshold_label))


def test_full_train_step_matches_jax():
    """One step of `make_train_step(forward_fn=posecnn_full_forward,
    ce_threshold=0.7)` in both packages (keep 0.5 from JAX's draws, device
    chroma, no clipping, lr 1 so that an update is the gradient): every
    loss term within 1e-5 relative, loss_pose > 0, the lr exactly, each
    parameter after the update within 5e-5 of its largest move (plus two
    float32 ulps of the parameter)."""
    params = PF.init_posecnn_full_params_numpy(G.FULL_SEED, _cfg())
    rng = jax.random.PRNGKey(5)
    draws = _draws(rng, _cfg().num_units)
    batch, points, symmetry, extents = _batch_with_gt_at_detections(params, draws)
    jcfg, jhp = JaxCfg(compute_dtype=jnp.float32, **TRAIN_KW), JaxHP(**HP)
    step = jax_make_train_step(jcfg, jhp, make_mesh(MeshSpec(data=1, model=1)), jnp.asarray(points),
                               jnp.asarray(symmetry), jnp.asarray(extents), donate=False,
                               forward_fn=JF.posecnn_full_forward, ce_threshold=0.7)
    p = _jax(params)
    jstate, m = step((p, make_optimizer(jhp).init(p), jnp.asarray(0, jnp.int32)),
                     {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    ref = {k: float(v) for k, v in m.items()}
    hp = T.TrainHParams(**HP)
    state = T.create_train_state(PF.make_full_model(_cfg(), params, "cpu"), hp)
    pstep = T.make_train_step(_cfg(), hp, t(points), t(symmetry), t(extents), forward_fn=PF.posecnn_full_forward,
                              ce_threshold=PF.CE_THRESHOLD)
    got = {k: float(v) for k, v in pstep(state, T.to_device(batch, "cpu"), T.Draws(replay=draws)).items()}
    for k in ("loss", "loss_regu", "loss_cls", "loss_vertex", "loss_pose"):
        assert abs(got[k] - ref[k]) <= 1e-5 * abs(ref[k]), (k, got[k], ref[k])
    assert ref["loss_pose"] > 0 and got["lr"] == ref["lr"] == 1.0
    after, ref_after = params_to_numpy(state.model.state_dict()), jax.tree_util.tree_map(np.asarray, jstate[0])
    assert sorted(after) == sorted(ref_after)
    for layer, leaves in ref_after.items():
        for leaf, r in leaves.items():
            move = np.abs(r - params[layer][leaf]).max()
            err = np.abs(after[layer][leaf] - r).max()
            assert err <= 5e-5 * move + 2.4e-7 * np.abs(params[layer][leaf]).max(), (layer, leaf, err, move)


def test_full_params_and_snapshots_in_both_layouts(tmp_path):
    """`init_posecnn_full_params_numpy` has the names and shapes of JAX's
    `init_posecnn_full_params` (the bilinear upscore_conv* filters equal),
    `param_shapes(cfg, "vgg16_full")` gives them without drawing weights,
    and a port snapshot (with its momentum trace) restores into JAX's
    VGG16FULL train state key for key and bit for bit; JAX's snapshot of
    that state restores into a fresh port state bit for bit, and
    `restore_params` reads every parameter of it."""
    cfg = _cfg()
    params = PF.init_posecnn_full_params_numpy(1, cfg)
    jparams = jax.tree_util.tree_map(np.asarray, JF.init_posecnn_full_params(
        jax.random.PRNGKey(0), JaxCfg(compute_dtype=jnp.float32, **TRAIN_KW)))
    assert sorted(params) == sorted(jparams)
    for layer, leaves in jparams.items():
        assert sorted(leaves) == sorted(params[layer]), layer
        for leaf, a in leaves.items():
            assert params[layer][leaf].shape == a.shape, (layer, leaf)
            if layer.startswith("upscore"):
                np.testing.assert_array_equal(params[layer][leaf], a)
    shapes = param_shapes(cfg, "vgg16_full")
    assert shapes == {k: {f: a.shape for f, a in v.items()} for k, v in params.items() if not k.startswith("upscore")}
    state = T.create_train_state(PF.make_full_model(cfg, params, "cpu"), T.TrainHParams())
    gen = torch.Generator().manual_seed(0)
    for tr in state.optimizer.trace:
        tr.copy_(torch.randn(tr.shape, generator=gen))
    state.step = 3
    path = CK.save_checkpoint(str(tmp_path / "port"), state, 3, prefix="vgg16_fcn_full_color_2d_pose")
    jp = _jax(PF.init_posecnn_full_params_numpy(2, cfg))
    restored = JCK.restore_checkpoint(path, (jp, make_optimizer(JaxHP()).init(jp), jnp.asarray(0, jnp.int32)))
    flat = JCK._flatten_state({"params": restored[0], "opt_state": restored[1], "step": restored[2]})
    with np.load(path) as d:
        files = {k: d[k] for k in d.files}
    assert set(files) == set(flat) and int(restored[2]) == 3 and "['params']['upscore_conv2_vertex']['weights']" in files
    for k, v in files.items():
        assert np.array_equal(np.asarray(flat[k]), v), k
    jpath = JCK.save_checkpoint(str(tmp_path / "jax"), restored, 3, prefix="vgg16_fcn_full_color_2d_pose")
    fresh = T.create_train_state(PF.make_full_model(cfg, PF.init_posecnn_full_params_numpy(4, cfg), "cpu"),
                                 T.TrainHParams())
    CK.restore_checkpoint(jpath, fresh)
    assert fresh.step == 3
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.trace, fresh.optimizer.trace):
        assert torch.equal(a, b)
    read = CK.restore_params(jpath, shapes)
    for layer, leaves in read.items():
        for leaf, a in leaves.items():
            np.testing.assert_array_equal(a, params[layer][leaf], err_msg=f"{layer}/{leaf}")


def test_what_jax_cannot_run_on_vgg16_full_is_refused(tmp_path):
    """JAX's step hands vgg16_full the GT centre table under
    TPU.HOUGH_GT_MIX (or HOUGH_FROM_GT), which it does not take
    (TypeError), and reads a domain_score it never returns under
    TRAIN.ADAPT: the port's builders refuse both settings on VGG16FULL (and
    its model the domain head); the shipped file builds."""
    batch, points, symmetry, extents = G.train_inputs()
    jcfg = JaxCfg(compute_dtype=jnp.float32, **{**TRAIN_KW, "hough_gt_mix": 0.5})
    params = _jax(PF.init_posecnn_full_params_numpy(1, _cfg()))
    with pytest.raises(TypeError, match="gt_centers"):
        jax_compute_losses(params, jcfg, JaxHP(), {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(points),
                           jnp.asarray(symmetry), jnp.asarray(extents), jax.random.PRNGKey(0),
                           forward_fn=JF.posecnn_full_forward, ce_threshold=0.7)
    text = open(FULL_CFG).read()
    assert C.unsupported(C.cfg_from_file(FULL_CFG)) == [] and C.unsupported(C.cfg_from_file(FULL_CFG), False) == []
    for extra, key in (("TPU:\n  HOUGH_GT_MIX: 0.5\n", "TPU.HOUGH_GT_MIX"), ("TPU:\n  HOUGH_FROM_GT: True\n",
                                                                             "TPU.HOUGH_FROM_GT")):
        p = tmp_path / "c.yml"
        p.write_text(text + extra)
        assert [r.split(":")[0] for r in C.unsupported(C.cfg_from_file(str(p)))] == [key]
    p.write_text(text.replace("  POSE_REG: True\n", "  POSE_REG: True\n  ADAPT: True\n", 1))
    assert [r.split(":")[0] for r in C.unsupported(C.cfg_from_file(str(p)))] == ["TRAIN.ADAPT"]
    with pytest.raises(NotImplementedError, match="domain head"):
        PF.PoseCNNFull(_cfg(adaptation=True), device="meta")


def _narrow(monkeypatch):
    """The CLIs' model configs at narrow widths (the trunk at 1/8, fc 64,
    NUM_UNITS 8: vgg16_full's fused branches run at the frame's size)."""
    for name in ("train_model_cfg", "test_model_cfg"):
        orig = getattr(C, name)
        monkeypatch.setattr(C, name, lambda cfg, n, _f=orig: dataclasses.replace(
            _f(cfg, n), trunk_scale=0.125, fc_dim=64, num_units=8))


def test_train_net_and_test_net_full_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """train_net --cfg lov_color_2d_full.yml --imdb lov_syn_val_v4 --iters 2
    --device cpu (VGG16FULL at narrow widths, B=2, 640x480, device chroma
    and host noise): finite losses, its snapshot restores key for key into
    JAX's VGG16FULL train state; --resume --iters 3 starts from it; then
    test_net --cfg with that snapshot reads every parameter at VGG16FULL's
    shapes and scores 2 frames."""
    from posecnn_torch import test_net, train_net

    _narrow(monkeypatch)
    out = tmp_path / "train"
    args = ["--cfg", FULL_CFG, "--imdb", "lov_syn_val_v4", "--device", "cpu", "--output", str(out)]
    assert train_net.main(args + ["--iters", "2"]) == 0
    snap = out / "vgg16_fcn_full_color_2d_pose_iter_2.npz"
    first = [ln for ln in capsys.readouterr().out.splitlines() if "iter 1/2" in ln][0]
    assert np.isfinite(float(first.split("loss_cls: ")[1].split()[0])) and "loss_pose" in first
    jcfg = JaxCfg(compute_dtype=jnp.float32, num_classes=22, num_units=8, trunk_scale=0.125, fc_dim=64)
    jp = JF.init_posecnn_full_params(jax.random.PRNGKey(0), jcfg)
    restored = JCK.restore_checkpoint(str(snap), (jp, make_optimizer(JaxHP()).init(jp), jnp.asarray(0, jnp.int32)))
    flat = JCK._flatten_state({"params": restored[0], "opt_state": restored[1], "step": restored[2]})
    with np.load(snap) as d:
        assert set(d.files) == set(flat) and int(restored[2]) == 2
    assert train_net.main(args + ["--iters", "3", "--resume"]) == 0
    timing = json.loads((out / "train_timing.json").read_text())
    assert timing["start_step"] == 2 and timing["end_step"] == 3
    ev = tmp_path / "eval"
    assert test_net.main(["--cfg", FULL_CFG, "--imdb", "lov_syn_val_v4", "--max_frames", "2", "--device", "cpu",
                          "--model", str(out / "vgg16_fcn_full_color_2d_pose_iter_3.npz"), "--output", str(ev)]) == 0
    summary = json.loads((ev / "eval_summary.json").read_text())
    assert 0 <= summary["mean_iou"] <= 1 and json.loads((ev / "eval_timing.json").read_text())["frames"] == 2
