"""One rank of the multichip dry run (`entry.dryrun_multichip`).

The port of `__graft_entry__.py:dryrun_multichip`'s body: the full
training step (every head, Hough, the crop pool, every loss) at tiny
shapes, over a (n/2, 2) mesh when the world n is even and above 1, else
(n, 1), with the TP threshold at 1 << 14 so that the narrow trunk's
conv4_1-conv5_3 and fc6, fc7 split over the model axis; one image per data
row, from `live_pose_batch`, so the ADD branch is live. One step; it
asserts loss_pose > 0, and rank 0 prints the step's terms as one JSON line
after "dryrun_multichip ok: ".

Each rank runs `python -m posecnn_torch.parallel.dryrun [device]` (device:
cpu or cuda) with the POSECNN_* variables set (`entry.dryrun_multichip`
starts them through `parallel.launch.run_ranks`).
"""

from __future__ import annotations

import json
import sys


def dryrun_config():
    """The dry run's PoseCNNConfig and TrainHParams (the JAX dry run's)."""
    import torch

    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.engine.train import TrainHParams

    cfg = PoseCNNConfig(
        num_classes=4, num_units=8, input_format="COLOR", vertex_reg=True, pose_reg=True, is_train=True,
        keep_prob=0.9, compute_dtype=torch.float32, hough_class_slots=2, hough_max_samples=32,
        hough_center_stride=4, hough_refine_window=8, label_threshold=5, fc_dim=256, trunk_scale=0.125,
        hough_sampler="approx", use_crop_pool=True, hough_gt_mix=1.0,
    )
    return cfg, TrainHParams(stepsize=100)


def run(device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.engine import train as T
    from posecnn_torch.engine.test import set_float32_precision
    from posecnn_torch.parallel import launch
    from posecnn_torch.parallel import mesh as M
    from posecnn_torch.utils.gate_batch import live_pose_batch

    device = launch.rank_device(device)
    world = launch.initialize(device=device)
    try:
        set_float32_precision()
        C, H, W = 4, 32, 32
        cfg, hp = dryrun_config()
        M.set_tp_min_size(1 << 14)
        model_par = 2 if world % 2 == 0 and world > 1 else 1
        mesh = M.make_mesh(M.MeshSpec(data=world // model_par, model=model_par), world)
        B = world // model_par  # one image per data row
        rng = np.random.RandomState(0)
        points = rng.randn(C, 32, 3).astype(np.float32) * 0.05
        symmetry = np.zeros(C, np.float32)
        extents = 0.1 + 0.1 * rng.rand(C, 3).astype(np.float32)
        batch = M.shard_batch(mesh, live_pose_batch(B, H, W, C, rng))
        model = M.shard_model(make_model(cfg, init_params_numpy(0, cfg), device), mesh)
        state = T.create_train_state(model, hp)
        step = T.make_train_step(cfg, hp, *(torch.from_numpy(a).to(device) for a in (points, symmetry, extents)),
                                 mesh=mesh)
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        metrics = {k: float(v) for k, v in step(state, T.to_device(batch, device), T.Draws(gen)).items()}
        assert metrics["loss_pose"] > 0.0, f"pose branch inert in the multichip gate: loss_pose={metrics['loss_pose']}"
        split = [n for n, p in model.named_parameters() if M.tp_mesh(p) is not None]
        return {"rank": mesh.rank, "metrics": metrics, "mesh": mesh.shape, "split": split,
                "backend": torch.distributed.get_backend() if world > 1 else None, "device": device}
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    out = run(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    if out["rank"] == 0:
        print("dryrun_multichip ok: " + json.dumps(out), flush=True)
