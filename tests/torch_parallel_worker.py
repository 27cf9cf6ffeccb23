"""The ranks of tests/test_torch_parallel.py, and the inputs both sides share.

Run as `python -m tests.torch_parallel_worker <mode> <out_dir>` by
`posecnn_torch.parallel.launch.run_ranks` (gloo on the CPU). It imports
torch and posecnn_torch only, never jax: it asserts so before it exits.

  steps: each case of `CASES` whose mesh covers the world, two steps on its
         batch; rank 0 writes <out_dir>/<case>.npz: the first step's loss
         terms and gradient norm and the parameters after both steps,
         gathered whole (JAX layout). Besides PoseCNN: VGG16FULL (variant
         "full": its forward and 0.7 gate, the GT pose rows put at the
         one-process forward's detections), TRAIN.MATCHING with four
         intrinsics for the four images ("intrinsics"), and the video
         model's step ("video": a (T, B, ...) batch split over B). The case `tp` then snapshots its state
         (`save_checkpoint` over the mesh: rank 0 writes tp_iter_2.npz) and
         restores it into a fresh split model on every rank, which must hold
         the same rows. The case `tp_mutant` runs g's backward as a summing
         reduce-scatter (the backward of torch.distributed.nn's all_gather).
  train: `train_net.main(argv)` at narrow widths and float32 (the argv after
         the out_dir).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

C, H, W, B = 4, 32, 32, 4
# tests/test_multihost.py's config, with the crop pool (the port trains the
# pose branch through it), f32 and Hough on the GT labels (hough_gt_mix 1)
CFG = dict(num_classes=C, num_units=8, trunk_scale=0.25, vertex_reg=True, pose_reg=True, is_train=True,
           keep_prob=1.0, hough_class_slots=2, hough_max_samples=32, hough_center_stride=4, hough_refine_window=8,
           label_threshold=5, fc_dim=64, hough_gt_mix=1.0, use_crop_pool=True)
HP = dict(stepsize=1000, learning_rate=0.01, vertex_w=1.0)
# the TP threshold of these cases: conv2_1-conv5_3, score_conv5_vertex,
# score_conv4_vertex and fc6 split over the model axis (fc7, 64x64, too)
TP_MIN = 4096
STEPS = 2
SEED = 7
FULL_CFG = {"hough_gt_mix": 0.0}
VIDEO_CFG = dict(num_classes=C, num_units=8, num_steps=2)
VIDEO_T = 2
# case: (world, mesh (data, model), cfg overrides, hp overrides, batch variant)
CASES = {
    "dp": (2, (2, 1), {}, {}, "plain"),
    "tp": (2, (1, 2), {}, {"clip_grad_norm": 10.0}, "plain"),
    "tp_mutant": (2, (1, 2), {}, {"clip_grad_norm": 10.0}, "plain"),
    # the draws with a batch axis: dropout, the noise field
    "dp_draws": (2, (2, 1), {"keep_prob": 0.9}, {}, "noise"),
    # the global max_gt cut drops image 3's GT row
    "dp_cut": (2, (2, 1), {}, {}, "cut"),
    # GT rows on rank 0's images alone: Hough's domains stay 0 on rank 1
    "dp_gtany": (2, (2, 1), {"adaptation": True}, {}, "gtany"),
    "mesh22": (4, (2, 2), {}, {"clip_grad_norm": 10.0}, "plain"),
    # VGG16FULL: Hough on the heads' maps (no gt mix), GT rows at its
    # detections; its dropout draws ("dropout/fused", "dropout/fused_vertex")
    "full_dp": (2, (2, 1), FULL_CFG, {}, "full"),
    "full_tp": (2, (1, 2), FULL_CFG, {"clip_grad_norm": 10.0}, "full"),
    "full_draws": (2, (2, 1), {**FULL_CFG, "keep_prob": 0.9}, {}, "full"),
    "full_mesh22": (4, (2, 2), FULL_CFG, {"clip_grad_norm": 10.0}, "full"),
    # TRAIN.MATCHING: rank 1's first image is not the global batch's first
    # (ROADMAP Queue 3 item 55)
    "match_dp": (2, (2, 1), {}, {"matching_w": 1.0}, "intrinsics"),
    # the video model: T=2 frames of B=4 images, 32x32, the full trunk
    "video_dp": (2, (2, 1), VIDEO_CFG, {"clip_grad_norm": 10.0}, "video"),
}


def case_inputs(name: str):
    """(cfg kw, hp kw, batch, points, symmetry, extents, params), numpy (the
    video case: its VideoConfig's kw, and no points, symmetry, extents)."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import init_params_numpy
    from posecnn_torch.utils.gate_batch import live_pose_batch

    _, _, cfg_over, hp_over, variant = CASES[name]
    hp_kw = {**HP, **hp_over}
    if variant == "video":
        return _video_case(hp_kw)
    cfg_kw = {**CFG, **cfg_over}
    rng = np.random.RandomState(SEED)
    points = (rng.randn(C, 32, 3) * 0.05).astype(np.float32)
    symmetry = np.zeros(C, np.float32)
    extents = (0.1 + 0.1 * rng.rand(C, 3)).astype(np.float32)
    batch = live_pose_batch(B, H, W, C, rng)
    valid = batch["poses"][batch["poses"][:, 1] > 0]
    if variant != "noise":
        batch["noise_sigma"] = np.zeros_like(batch["noise_sigma"])  # no draw reaches the step
    if variant == "cut":
        batch["poses"] = valid[:3]
    elif variant == "gtany":
        batch["poses"] = valid[:2]
    elif variant == "intrinsics":
        batch["meta_data"][:, 0] *= np.float32([1.0, 1.25, 0.8, 1.1])  # fx
        batch["meta_data"][:, 4] *= np.float32([1.0, 1.2, 0.9, 1.05])  # fy
    if variant == "full":
        from posecnn_torch.models.posecnn_full import init_posecnn_full_params_numpy

        params = init_posecnn_full_params_numpy(SEED, PoseCNNConfig(compute_dtype=torch.float32, **cfg_kw))
        batch["poses"] = _rows_at_detections(cfg_kw, params, batch, extents)
    else:
        params = init_params_numpy(SEED, PoseCNNConfig(compute_dtype=torch.float32, **cfg_kw))
    return cfg_kw, hp_kw, batch, points, symmetry, extents, params


def case_points_raw(name: str):
    """The metre-scale clouds of the matching loss (None where the case
    has none): C clouds of 32 points in 0.1 m boxes, the stand-in models'
    size. (In 6 cm boxes, 2 pixels wide at this scale and so narrower than
    the splat, JAX's jitted loss and its unjitted one part by 1.2e-4 of
    fc8's largest gradient; at 0.1 m the port is within 7e-6 of both.)"""
    if CASES[name][4] != "intrinsics":
        return None
    return np.random.RandomState(SEED + 1).uniform(-0.05, 0.05, (C, 32, 3)).astype(np.float32)


def _rows_at_detections(cfg_kw, params, batch, extents):
    """VGG16FULL's GT pose rows put at its own detections on the global
    batch (`tests/torch_parity.py:gt_rows_at_detections`, one forward at
    keep_prob 1): from random weights they meet no GT row otherwise."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.engine import train as T
    from posecnn_torch.models.posecnn_full import make_full_model, posecnn_full_forward
    from tests.torch_parity import gt_rows_at_detections

    cfg = PoseCNNConfig(compute_dtype=torch.float32, **{**cfg_kw, "keep_prob": 1.0})
    tb = T.to_device(batch, "cpu")
    with torch.no_grad():
        data = T.preprocess(tb["data"], T.TrainHParams(), tb, T.Draws(torch.Generator()))  # sigma 0: no noise
        out = posecnn_full_forward(make_full_model(cfg, params, "cpu"), cfg, data,
                                   torch.from_numpy(extents), tb["meta_data"], gt_poses=tb["poses"],
                                   gt_label_2d=tb["gt_label_2d"])
    return gt_rows_at_detections(out, batch["poses"])


def _video_case(hp_kw):
    """The video case's inputs: the video golden's seeded weights with
    random gates (`make_torch_goldens.video_params`, at VIDEO_CFG), a
    (T, B, H, W) batch of 50 N(0, 1) data, depth U(0.8, 1.2) m and labels,
    and the golden's camera motion (`video_meta`)."""
    from tests.torch_parity import goldens

    G = goldens()
    rng = np.random.RandomState(SEED)
    K = np.array([[30.0, 0.0, W / 2], [0.0, 30.0, H / 2], [0.0, 0.0, 1.0]])
    batch = {"data": (50.0 * rng.randn(VIDEO_T, B, H, W, 3)).astype(np.float32),
             "depth": rng.uniform(0.8, 1.2, (VIDEO_T, B, H, W)).astype(np.float32),
             "gt_label_2d": rng.randint(0, C, (VIDEO_T, B, H, W)).astype(np.int32),
             "meta_data": G.video_meta(VIDEO_T, B, K)}
    saved = G.VIDEO_CFG
    G.VIDEO_CFG = VIDEO_CFG
    try:
        params = G.video_params(SEED)
    finally:
        G.VIDEO_CFG = saved
    return VIDEO_CFG, hp_kw, batch, None, None, None, params


def _case_model(name: str, cfg_kw: dict, params: dict, mesh):
    """(model, step) of case `name`: the network its variant trains, split
    over `mesh` where it has one, and its step."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import make_model
    from posecnn_torch.engine import train as T
    from posecnn_torch.models.posecnn_full import CE_THRESHOLD, make_full_model, posecnn_full_forward
    from posecnn_torch.models.video import VideoConfig, make_video_model
    from posecnn_torch.parallel import mesh as M

    variant = CASES[name][4]
    hp = T.TrainHParams(**{**HP, **CASES[name][3]})
    if variant == "video":
        vcfg = VideoConfig(compute_dtype=torch.float32, **cfg_kw)
        return make_video_model(vcfg, params, "cpu"), lambda consts: T.make_video_train_step(vcfg, hp, mesh)
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **cfg_kw)
    model = (make_full_model if variant == "full" else make_model)(cfg, params, "cpu")
    if mesh is not None:
        M.set_tp_min_size(TP_MIN)
        M.shard_model(model, mesh)
    kw = dict(forward_fn=posecnn_full_forward, ce_threshold=CE_THRESHOLD) if variant == "full" else {}
    raw = case_points_raw(name)
    if raw is not None:
        kw["points_raw"] = torch.from_numpy(raw)
    return model, lambda consts: T.make_train_step(cfg, hp, *consts, mesh=mesh, **kw)


def run_steps(name: str, mesh=None, mutant: bool = False, snapshot_dir=None):
    """STEPS steps of case `name` on this rank's part of its global batch
    (the whole of it without a mesh). Returns (first losses, first grad
    norm, the parameters after the steps gathered whole in the JAX layout,
    the state)."""
    from posecnn_torch.core.convert import params_to_numpy
    from posecnn_torch.engine import train as T
    from posecnn_torch.parallel import mesh as M
    from posecnn_torch.parallel import tp

    cfg_kw, hp_kw, batch, points, symmetry, extents, params = case_inputs(name)
    hp = T.TrainHParams(**hp_kw)
    model, make_step = _case_model(name, cfg_kw, params, mesh)
    if mesh is not None:
        batch = (M.shard_video_batch if CASES[name][4] == "video" else M.shard_batch)(mesh, batch)
    state = T.create_train_state(model, hp)
    consts = [] if points is None else [torch.from_numpy(a) for a in (points, symmetry, extents)]
    step = make_step(consts)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    tb = T.to_device(batch, "cpu")
    saved = tp._GatherFromModel.backward
    if mutant:
        def summing(ctx, g):  # a reduce-scatter: the slice of the group's sum
            s = tp.all_reduce(g.contiguous().clone(), mesh.model_group)
            return s.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k).contiguous(), None, None, None

        tp._GatherFromModel.backward = staticmethod(summing)
    try:
        first = None
        for _ in range(STEPS):
            out = step(state, tb, T.Draws(gen))
            if first is None:
                first = {k: float(v) for k, v in out.items()}
    finally:
        tp._GatherFromModel.backward = saved
    whole = params_to_numpy({n: M.gather_rows(p) for n, p in model.named_parameters()})
    return first, first["grad_norm"], whole, state


def flat_params(tree: dict, prefix: str = "") -> dict:
    """{'layer/leaf': array} (a cell's 'layer/sub/leaf') of a JAX-layout
    tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _save(path: str, losses: dict, whole: dict) -> None:
    arrays = {f"loss/{k}": np.asarray(v) for k, v in losses.items()}
    arrays.update({f"param/{k}": a for k, a in flat_params(whole).items()})
    np.savez(path, **arrays)


def steps_mode(out_dir: str) -> None:
    from posecnn_torch.core.checkpoint import restore_checkpoint, save_checkpoint
    from posecnn_torch.parallel import launch
    from posecnn_torch.parallel import mesh as M

    world = launch.initialize(device="cpu")
    rank = torch.distributed.get_rank()
    for name, (w, (data, model), *_rest) in CASES.items():
        if w != world:
            continue
        mesh = M.make_mesh(M.MeshSpec(data=data, model=model), world)
        losses, _, whole, state = run_steps(name, mesh, mutant=name == "tp_mutant")
        if rank == 0:
            _save(os.path.join(out_dir, f"{name}.npz"), losses, whole)
        if name == "tp":
            path = save_checkpoint(out_dir, state, step=STEPS, prefix="tp", mesh=mesh)
            fresh = run_steps_state(name, mesh)
            restore_checkpoint(path, fresh)
            same = all(torch.equal(a, b) for a, b in zip(state.model.parameters(), fresh.model.parameters()))
            same &= all(torch.equal(a, b) for a, b in zip(state.optimizer.trace, fresh.optimizer.trace))
            split = [n for n, p in fresh.model.named_parameters() if M.tp_mesh(p) is not None]
            assert same and fresh.step == STEPS and split, (same, fresh.step, split)
            if rank == 0:
                with open(os.path.join(out_dir, "tp_restore.json"), "w") as f:
                    json.dump({"split": split, "step": fresh.step}, f)
    torch.distributed.destroy_process_group()


def run_steps_state(name: str, mesh):
    """A fresh split train state of case `name` (its seed weights)."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import make_model
    from posecnn_torch.engine import train as T
    from posecnn_torch.parallel import mesh as M

    cfg_kw, hp_kw, _, _, _, _, params = case_inputs(name)
    model = M.shard_model(make_model(PoseCNNConfig(compute_dtype=torch.float32, **cfg_kw), params, "cpu"), mesh)
    return T.create_train_state(model, T.TrainHParams(**hp_kw))


# train_net's model configs at narrow widths, float32
NARROW = dict(trunk_scale=0.125, fc_dim=64, compute_dtype=torch.float32)


def train_mode(argv) -> int:
    from posecnn_torch import train_net
    from posecnn_torch.core import config as Cfg

    orig = Cfg.train_model_cfg
    Cfg.train_model_cfg = lambda cfg, n: dataclasses.replace(orig(cfg, n), **NARROW)
    return train_net.main(argv)


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, out = sys.argv[1], sys.argv[2]
    if mode == "steps":
        steps_mode(out)
        rc = 0
    else:
        rc = train_mode(sys.argv[3:])
    bad = sorted(k for k in sys.modules if k == "jax" or k.startswith(("jax.", "posecnn_tpu")))
    assert not bad, bad
    sys.exit(rc)
