"""The ranks of tests/test_torch_parallel.py, and the inputs both sides share.

Run as `python -m tests.torch_parallel_worker <mode> <out_dir>` by
`posecnn_torch.parallel.launch.run_ranks` (gloo on the CPU). It imports
torch and posecnn_torch only, never jax: it asserts so before it exits.

  steps: each case of `CASES` whose mesh covers the world, two steps on its
         batch; rank 0 writes <out_dir>/<case>.npz: the first step's loss
         terms and gradient norm and the parameters after both steps,
         gathered whole (JAX layout). The case `tp` then snapshots its state
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
}


def case_inputs(name: str):
    """(cfg kw, hp kw, batch, points, symmetry, extents, params), numpy."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import init_params_numpy
    from posecnn_torch.utils.gate_batch import live_pose_batch

    _, _, cfg_over, hp_over, variant = CASES[name]
    cfg_kw, hp_kw = {**CFG, **cfg_over}, {**HP, **hp_over}
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
    params = init_params_numpy(SEED, PoseCNNConfig(compute_dtype=torch.float32, **cfg_kw))
    return cfg_kw, hp_kw, batch, points, symmetry, extents, params


def run_steps(name: str, mesh=None, mutant: bool = False, snapshot_dir=None):
    """STEPS steps of case `name` on this rank's part of its global batch
    (the whole of it without a mesh). Returns (first losses, first grad
    norm, the parameters after the steps gathered whole in the JAX layout,
    the state)."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import make_model, params_to_numpy
    from posecnn_torch.engine import train as T
    from posecnn_torch.parallel import mesh as M
    from posecnn_torch.parallel import tp

    cfg_kw, hp_kw, batch, points, symmetry, extents, params = case_inputs(name)
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **cfg_kw)
    hp = T.TrainHParams(**hp_kw)
    model = make_model(cfg, params, "cpu")
    if mesh is not None:
        M.set_tp_min_size(TP_MIN)
        M.shard_model(model, mesh)
        batch = M.shard_batch(mesh, batch)
    state = T.create_train_state(model, hp)
    step = T.make_train_step(cfg, hp, *(torch.from_numpy(a) for a in (points, symmetry, extents)), mesh=mesh)
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


def _save(path: str, losses: dict, whole: dict) -> None:
    arrays = {f"loss/{k}": np.asarray(v) for k, v in losses.items()}
    arrays.update({f"param/{layer}/{leaf}": a for layer, leaves in whole.items() for leaf, a in leaves.items()})
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
