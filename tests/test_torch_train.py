"""The port's training step (`posecnn_torch/engine/train.py`) against the JAX
package's (`posecnn_tpu/engine/train.py`), the training golden, the lr rule
(ROADMAP queue 3, hazard 7), the bank and the flagship training config.

The small step: trunk_scale 0.125, C=22, 64x80 frames (v4/000000 and 000001
resampled), P=64 ADD points, float32, keep_prob 1, hough_gt_mix 0 or 1,
the crop pool or RoI max pooling (JAX unjitted there), chroma deltas
given, no noise: every random choice is fixed, so both
packages see the same step. The port's own draws are tested by distribution
and by replay (hazard 9).

Tolerances: loss terms and the gradient norm within 1e-5 relative; each
gradient within 2e-5 of its largest magnitude (f32 sums in other orders;
the port reads ~2e-6); parameters after two updates within 2e-5 of their
largest move plus two f32 ulps of the parameter.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.data import device_bank as JB
from posecnn_tpu.data.minibatch import Frame as JaxFrame
from posecnn_tpu.engine import train as JT
from posecnn_torch.config import PoseCNNConfig, flagship_train_cfg
from posecnn_torch.core.convert import init_params_numpy, make_model, params_from_numpy
from posecnn_torch.data.device_bank import pack_frames
from posecnn_torch.data.minibatch import load_frozen_frame
from posecnn_torch.engine import train as T
from tests.torch_parity import check_train_golden, goldens, load_npz, small_train_on_golden, t

torch.set_num_threads(1)

CASES = {
    # the training golden's config
    "gt_mix1_fc64": (dict(hough_gt_mix=1.0, fc_dim=64), {}),
    # Hough on the network's own labels, wider fc
    "gt_mix0_fc256": (dict(hough_gt_mix=0.0, fc_dim=256), {}),
    # RoI max pooling in place of the crop pool (TPU.USE_CROP_POOL False):
    # the doubling table's backward; JAX unjitted (its jitted roi pool moves
    # the last bin's edge, ROADMAP Queue 3 item 11)
    "roi_pool_gt_mix1": (dict(hough_gt_mix=1.0, fc_dim=64, use_crop_pool=False), {}),
}
_JAX = {}


def _case(name):
    """(cfg kw, hp kw, weights, batch, points, symmetry, extents, JAX results
    of two steps), the JAX side computed once per case."""
    G = goldens()
    cfg_over, hp_over = CASES[name]
    cfg_kw, hp_kw = {**G.TRAIN_CFG, **cfg_over}, {**G.TRAIN_HP, **hp_over}
    params = init_params_numpy(G.TRAIN_SEED, PoseCNNConfig(**cfg_kw))
    batch, points, symmetry, extents = G.train_inputs()
    if name not in _JAX:
        with jax.disable_jit(not cfg_kw["use_crop_pool"]):
            _JAX[name] = G.jax_train_steps(cfg_kw, hp_kw, params, batch, points, symmetry, extents, n_steps=2)
    return cfg_kw, hp_kw, params, batch, points, symmetry, extents, _JAX[name]


def _port_steps(cfg_kw, hp_kw, params, batch, points, symmetry, extents, n_steps=2):
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **cfg_kw)
    hp = T.TrainHParams(**hp_kw)
    model = make_model(cfg, params, "cpu")
    state = T.create_train_state(model, hp)
    tb = {k: t(v) for k, v in batch.items()}
    sched = T.lr_schedule(hp)
    first = None
    for _ in range(n_steps):
        loss, losses = T.compute_losses(model, cfg, hp, tb, t(points), t(symmetry), t(extents))
        lr = sched(state.step)
        g_norm = T.train_update(state, loss, lr)
        if first is None:
            first = ({k: float(v.detach()) for k, v in losses.items()},
                     {k: p.grad.clone() for k, p in model.named_parameters()}, lr, float(g_norm))
    return (*first, {k: v.detach() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("name", list(CASES))
def test_small_step_matches_jax(name):
    """Loss terms and grads of the first step, and the parameters after two
    updates (momentum and the global-norm clip both at work)."""
    cfg_kw, hp_kw, params, batch, points, symmetry, extents, ref = _case(name)
    r_losses, r_grads, r_lr, r_norm, r_params = ref
    losses, grads, lr, g_norm, after = _port_steps(cfg_kw, hp_kw, params, batch, points, symmetry, extents)
    assert r_norm > hp_kw["clip_grad_norm"]  # the clip is active
    if cfg_kw["hough_gt_mix"] == 1.0:
        assert r_losses["loss_pose"] > 0
    for k, v in r_losses.items():
        assert abs(losses[k] - v) <= 1e-5 * max(abs(v), 1e-3), (k, losses[k], v)
    assert abs(g_norm - r_norm) <= 1e-5 * r_norm and abs(lr - r_lr) <= 1e-9
    ref_g = params_from_numpy({k: v for k, v in r_grads.items() if not k.startswith("upscore")})
    ref_p = params_from_numpy({k: v for k, v in r_params.items() if not k.startswith("upscore")})
    p0 = params_from_numpy(params)
    for k, g in ref_g.items():
        assert float((grads[k] - g).abs().max()) <= 2e-5 * float(g.abs().max()), k
        move = float((ref_p[k] - p0[k]).abs().max())
        tol = 2e-5 * move + 2.4e-7 * float(p0[k].abs().max())
        assert float((after[k] - ref_p[k]).abs().max()) <= tol, k


def test_train_golden_is_current():
    """The committed golden equals the JAX package's step run now."""
    g = load_npz(goldens().TRAIN_GOLDEN)
    *_, (r_losses, r_grads, r_lr, r_norm, _) = _case("gt_mix1_fc64")
    for k, v in r_losses.items():
        np.testing.assert_allclose(g[f"loss/{k}"], v, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g["grad_norm"], r_norm, rtol=1e-6)
    for layer, leaves in r_grads.items():
        for leaf, v in leaves.items():
            if not layer.startswith("upscore"):
                np.testing.assert_allclose(g[f"grads/['{layer}']['{leaf}']"], v, rtol=0, atol=1e-6 * np.abs(v).max())


def test_small_step_matches_train_golden():
    """The shared check that chip_smoke.py and the card test run; on the CPU
    the gradients also hold to this file's 2e-5."""
    err = check_train_golden(*small_train_on_golden("cpu"))
    assert err["grads (relative)"] < 2e-5


def test_lr_schedule_and_resume_from_the_step_counter():
    """lr across stepsize as JAX's schedule gives it, and a state resumed
    past the decay applies the decayed lr: it comes from the step counter,
    and the optimizer's state holds none (hazard 7)."""
    hp = T.TrainHParams(learning_rate=0.001, gamma=0.1, stepsize=40000)
    sched, ref = T.lr_schedule(hp), JT.lr_schedule(JT.TrainHParams(learning_rate=0.001, gamma=0.1, stepsize=40000))
    for step in (0, 1, 39999, 40000, 40001, 79999, 80000, 120000):
        assert abs(sched(step) - float(ref(step))) <= 1e-6 * float(ref(step)), step
    G = goldens()
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **G.TRAIN_CFG)
    hp = T.TrainHParams(**{**G.TRAIN_HP, "stepsize": 2})
    batch, points, symmetry, extents = G.train_inputs()
    bank = {"data": t(batch["data"]), "label": t(batch["gt_label_2d"]).to(torch.uint8),
            "meta_data": t(batch["meta_data"]), "gt_centers": t(batch["gt_centers"]),
            "pose_rows": t(np.zeros((2, 4, 13), np.float32))}
    step = T.make_bank_train_step(cfg, hp, t(points), t(symmetry), t(extents), batch_size=2, max_gt=8)
    for start, lr in ((0, 0.001), (1, 0.001), (2, 0.0001), (5, 0.00001)):
        model = make_model(cfg, init_params_numpy(G.TRAIN_SEED, cfg), "cpu")
        state = T.create_train_state(model, hp, step=start)  # a resume: fresh trace, restored counter
        p0 = model.fc8.weight.detach().clone()
        out = step(state, bank, T.Draws(torch.Generator().manual_seed(0)))
        assert abs(float(out["lr"]) - lr) <= 1e-12 and state.step == start + 1
        scale = min(1.0, hp.clip_grad_norm / float(out["grad_norm"]))
        # a fresh trace is the clipped gradient itself: the move is lr times it
        torch.testing.assert_close(p0 - model.fc8.weight.detach(), lr * scale * model.fc8.weight.grad,
                                   rtol=1e-4, atol=1e-10)
        assert set(state.optimizer.state_dict()) == {"trace"}


def test_assemble_pose_rows_matches_jax():
    rng = np.random.RandomState(7)
    rows = rng.randn(3, 4, 13).astype(np.float32)
    rows[:, :, 1] = [[2, 0, 5, 0], [0, 0, 0, 0], [1, 3, 0, 4]]
    for max_gt in (3, 5, 16):
        ref = JT._assemble_pose_rows(jnp.asarray(rows), max_gt)
        np.testing.assert_array_equal(T.assemble_pose_rows(t(rows), max_gt).numpy(), np.asarray(ref))


def test_pack_frames_matches_jax():
    """The port's numpy copies (pack_frames, pose_rows, pad_im) against
    JAX's on 4 frozen frames."""
    root = goldens().ROOT
    frames = [load_frozen_frame(f"{root}/data/lov_syn_val_v4/{i:06d}.npz") for i in range(4)]
    got = pack_frames(frames, 6)
    ref = JB.pack_frames([JaxFrame(**dataclasses.asdict(f)) for f in frames], 6)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_flagship_train_cfg_matches_train_net():
    """flagship_train_cfg() against what tools/train_net.py:107-146 builds
    from experiments/cfgs/lov_syn_capstone.yml with the JAX package's
    config loader (the same expressions, num_classes 22 from the LOV imdb)."""
    from posecnn_tpu.core.config import cfg_fresh
    from posecnn_tpu.models.posecnn import PoseCNNConfig as JaxCfg

    c = cfg_fresh(f"{goldens().ROOT}/experiments/cfgs/lov_syn_capstone.yml")
    ref_cfg = JaxCfg(
        num_classes=22, num_units=c.TRAIN.NUM_UNITS, input_format=c.INPUT if c.INPUT != "COLOR" else "COLOR",
        vertex_reg=c.TRAIN.VERTEX_REG_2D or c.TRAIN.VERTEX_REG_3D, vertex_reg_3d=c.TRAIN.VERTEX_REG_3D,
        pose_reg=c.TRAIN.POSE_REG and not c.TRAIN.VERTEX_REG_3D, adaptation=c.TRAIN.ADAPT,
        threshold_label=c.TRAIN.THRESHOLD_LABEL, vote_threshold=c.TRAIN.VOTING_THRESHOLD, is_train=True,
        keep_prob=0.5, hough_class_slots=c.TPU.HOUGH_CLASS_SLOTS, hough_max_samples=c.TPU.HOUGH_MAX_SAMPLES,
        hough_center_stride=c.TPU.HOUGH_CENTER_STRIDE, hough_sampler=c.TPU.HOUGH_SAMPLER,
        hough_pixel_stride=c.TPU.HOUGH_PIXEL_STRIDE, skip_pixels=c.TPU.HOUGH_SKIP_PIXELS,
        use_crop_pool=c.TPU.USE_CROP_POOL, hough_from_gt=c.TPU.HOUGH_FROM_GT, hough_gt_mix=c.TPU.HOUGH_GT_MIX,
    )
    ref_hp = JT.TrainHParams(
        learning_rate=c.TRAIN.LEARNING_RATE, momentum=c.TRAIN.MOMENTUM, gamma=c.TRAIN.GAMMA,
        stepsize=c.TRAIN.STEPSIZE, weight_reg=c.TRAIN.WEIGHT_REG, vertex_w=c.TRAIN.VERTEX_W, pose_w=c.TRAIN.POSE_W,
        adapt_weight=c.TRAIN.ADAPT_WEIGHT, clip_grad_norm=c.TRAIN.GRAD_CLIP, margin=c.TRAIN.POSE_MARGIN,
        pose_norm_valid=c.TRAIN.POSE_NORM_VALID, matching_w=1.0 if c.TRAIN.MATCHING else 0.0,
        quat_w=c.TPU.QUAT_AUX_W, vertex_z_obj_norm=c.TPU.VERTEX_Z_OBJ_NORM,
    )
    cfg, hp = flagship_train_cfg()
    got = dataclasses.asdict(cfg)
    for k, v in dataclasses.asdict(ref_cfg).items():
        if k == "compute_dtype":
            assert v == jnp.bfloat16 and got[k] == torch.bfloat16 and c.TPU.COMPUTE_DTYPE == "bfloat16"
        else:
            assert got[k] == v, k
    assert dataclasses.asdict(hp) == {**dataclasses.asdict(ref_hp), "pixel_means": tuple(c.PIXEL_MEANS)}
    assert c.TRAIN.IMS_PER_BATCH == 2 and c.TRAIN.CHROMATIC and c.TRAIN.ADD_NOISE and c.TPU.DEVICE_BANK
    assert c.TPU.MAX_GT == 24 and c.TPU.ADD_NUM_POINTS == 1024


def test_sample_batch_by_distribution():
    """Frame indices uniform over the bank, HLS deltas inside the reference
    ranges, noise on ~90% of the images with sigma in [0, sqrt(76.8)]."""
    n = 5
    bank = {"data": torch.zeros((n, 4, 4, 3), dtype=torch.uint8), "label": torch.zeros((n, 4, 4), dtype=torch.uint8),
            "meta_data": torch.zeros((n, 48)), "gt_centers": torch.zeros((n, 2, 4)),
            "pose_rows": torch.zeros((n, 2, 13))}
    gen = torch.Generator().manual_seed(0)
    idx, chroma, sigma = [], [], []
    for _ in range(2000):
        b = T.sample_batch(bank, 2, 4, True, True, T.Draws(gen, record=True))
        chroma.append(b["chroma_dhls"])
        sigma.append(b["noise_sigma"])
    d = T.Draws(gen, record=True)
    for _ in range(2000):
        T.sample_batch(bank, 2, 4, False, False, d)
        idx.append(d.recorded["bank/index"])
    idx, chroma, sigma = torch.cat(idx), torch.cat(chroma), torch.cat(sigma)
    counts = torch.bincount(idx, minlength=n).float() / idx.numel()
    assert idx.min() >= 0 and idx.max() < n and (counts - 1 / n).abs().max() < 0.02
    half = torch.tensor([0.02 * 180.0, 0.2 * 256.0, 0.2 * 256.0]) / 2
    assert (chroma.abs() <= half).all() and (chroma.abs().amax(dim=0) > 0.95 * half).all()
    assert abs(float((sigma > 0).float().mean()) - 0.9) < 0.02
    assert float(sigma.max()) <= (0.3 * 256.0) ** 0.5


def test_replayed_step_gives_the_same_losses():
    """A step with dropout, the GT mix and noise, recorded, then run again on
    the same weights with the recorded draws: the same losses and update."""
    G = goldens()
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **{**G.TRAIN_CFG, "keep_prob": 0.5, "hough_gt_mix": 0.5})
    hp = T.TrainHParams(**G.TRAIN_HP)
    batch, points, symmetry, extents = G.train_inputs()
    bank = {"data": t(batch["data"]), "label": t(batch["gt_label_2d"]).to(torch.uint8),
            "meta_data": t(batch["meta_data"]), "gt_centers": t(batch["gt_centers"]),
            "pose_rows": t(np.zeros((2, 4, 13), np.float32))}
    step = T.make_bank_train_step(cfg, hp, t(points), t(symmetry), t(extents), 2, 8, chromatic=True, add_noise=True)
    outs, weights = [], []
    rec = T.Draws(torch.Generator().manual_seed(5), record=True)
    for draws in (rec, T.Draws(replay=rec.recorded)):
        state = T.create_train_state(make_model(cfg, init_params_numpy(G.TRAIN_SEED, cfg), "cpu"), hp)
        outs.append(step(state, bank, draws))
        weights.append(state.model.fc7.weight.detach())
    assert {"dropout/add_score", "dropout/addv", "dropout/fc6", "dropout/fc7", "hough_gt_mix", "noise/field",
            "chroma", "bank/index"} <= set(rec.recorded)
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert torch.equal(weights[0], weights[1])


def test_solver_logs_every_step():
    G = goldens()
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **G.TRAIN_CFG)
    hp = T.TrainHParams(**G.TRAIN_HP)
    batch, points, symmetry, extents = G.train_inputs()
    bank = {"data": t(batch["data"]), "label": t(batch["gt_label_2d"]).to(torch.uint8),
            "meta_data": t(batch["meta_data"]), "gt_centers": t(batch["gt_centers"]),
            "pose_rows": t(np.zeros((2, 4, 13), np.float32))}
    step = T.make_bank_train_step(cfg, hp, t(points), t(symmetry), t(extents), 2, 8)
    state = T.create_train_state(make_model(cfg, init_params_numpy(G.TRAIN_SEED, cfg), "cpu"), hp)
    lines = []
    state, metrics = T.Solver(step, display=1).train(itertools.repeat(bank), state, 2, log=lines.append)
    assert state.step == 2 and len(lines) == 2
    assert lines[0].startswith("iter 1/2 ") and "lr: 0.001 " in lines[0] and "loss_pose: " in lines[1]
    assert all(np.isfinite(float(v)) for v in metrics.values())
