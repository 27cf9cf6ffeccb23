"""Entry points of the port: flagship PoseCNN inference and training.

`entry` mirrors `__graft_entry__.py:entry`: the 22-class VGG16 PoseCNN at
640x480 in bf16, weights drawn from numpy seed 0
(`core.convert.init_params_numpy`), Hough voting with 8 class slots, 512
samples, centre stride 4, pixel stride 3 and the approx sampler.

`train_entry` builds the flagship training step of
`experiments/cfgs/lov_syn_capstone.yml` (`config.flagship_train_cfg`) on the
same seed-0 weights, over a device bank of the frozen frames of
`data/lov_syn_val_v4/`. The YCB model points and extents are not in the
repository, so the extents are 0.1 m (as `entry` sets them) and the ADD
loss's points are seeded uniformly inside those boxes, as
`__graft_entry__.dryrun_multichip` seeds its own.
"""

from __future__ import annotations

import numpy as np
import torch

from posecnn_torch.config import FLAGSHIP_TRAIN_BATCH, PIXEL_MEANS, flagship_cfg, flagship_train_cfg
from posecnn_torch.core.convert import init_params_numpy, make_model
from posecnn_torch.data.device_bank import bank_to_device, build_bank
from posecnn_torch.data.lov_syn import LovSynVal, object_models
from posecnn_torch.data.minibatch import rescale_points
from posecnn_torch.engine.test import set_float32_precision
from posecnn_torch.engine.train import create_train_state, make_bank_train_step
from posecnn_torch.models.posecnn import posecnn_forward

def entry(device="cuda"):
    """Returns (fn, example_args). fn(model, raw_bgr, meta, extents) ->
    (label_2d, vertex_pred, rois, poses_init, poses_tanh), as in JAX."""
    cfg = flagship_cfg(is_train=False)
    model = make_model(cfg, init_params_numpy(0, cfg), device)
    H, W, C = 480, 640, cfg.num_classes
    means = torch.tensor(PIXEL_MEANS, dtype=torch.float32, device=device).reshape(1, 1, 1, 3)
    set_float32_precision()

    @torch.inference_mode()
    def fn(model, raw_bgr, meta, extents):
        data = raw_bgr.to(torch.float32) - means
        out = posecnn_forward(model, cfg, data, extents, meta)
        return out["label_2d"], out["vertex_pred"], out["rois"], out["poses_init"], out["poses_tanh"]

    raw = torch.zeros((1, H, W, 3), dtype=torch.uint8, device=device)
    meta = torch.zeros((1, 48), dtype=torch.float32, device=device)
    meta[0, 0], meta[0, 4], meta[0, 2], meta[0, 5] = 1066.8, 1067.5, 312.99, 241.31
    extents = torch.full((C, 3), 0.1, dtype=torch.float32, device=device)
    return fn, (model, raw, meta, extents)


def train_objects(num_classes: int, seed: int = 0):
    """(loss points (C,P,3), symmetry (C,), extents (C,3)), numpy: the
    stand-in object models of `data.lov_syn.object_models` (0.1 m extents,
    P = ADD_NUM_POINTS seeded points a class), the points rescaled for the
    loss as the JAX trainer does (`data/minibatch.py:rescale_points`)."""
    points, symmetry, extents = object_models(num_classes, seed)
    return rescale_points(points, extents, symmetry).astype(np.float32), symmetry, extents


def train_entry(device="cuda"):
    """Returns (step, state, bank). step(state, bank, draws) runs one
    flagship training step (B=2 at 640x480, bf16) and updates `state` in
    place; `state` holds the seed-0 model, the optimizer and the step
    counter; `bank` is every frozen frame on `device`.
    `engine.train.Solver` drives it."""
    cfg, hp = flagship_train_cfg()
    set_float32_precision()
    model = make_model(cfg, init_params_numpy(0, cfg), device)
    state = create_train_state(model, hp)
    points, symmetry, extents = (torch.from_numpy(a).to(device) for a in train_objects(cfg.num_classes))
    bank = bank_to_device(build_bank(LovSynVal(), FLAGSHIP_TRAIN_BATCH["max_gt"]), device)
    step = make_bank_train_step(cfg, hp, points, symmetry, extents, **FLAGSHIP_TRAIN_BATCH)
    return step, state, bank


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> dict:
    """The multichip dry run (`__graft_entry__.py:dryrun_multichip`): n
    ranks (`parallel/dryrun.py`, started by `parallel.launch.run_ranks`)
    run one full training step at tiny shapes over a (n/2, 2) mesh when n
    is even and above 1, else (n, 1), and assert loss_pose > 0. On the CPU
    the ranks meet over gloo; on CUDA over NCCL when the host has a GPU for
    each rank, else over gloo, every rank on cuda:0 (NCCL refuses two ranks
    on one GPU). Returns rank 0's record (the step's terms, the mesh, the
    split parameters, the backend); a failed rank raises."""
    import json
    import os
    import tempfile

    from posecnn_torch.parallel.launch import run_ranks

    dev = device
    backend = "gloo"
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip on CUDA: no CUDA device")
        if torch.cuda.device_count() >= n_devices:
            backend, dev = "nccl", "cuda"
        else:
            dev = "cuda:0"
    with tempfile.TemporaryDirectory() as tmp:
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(n_devices)]
        rcs = run_ranks(["-m", "posecnn_torch.parallel.dryrun", dev], n_devices, backend=backend, logs=logs,
                        timeout=timeout)
        texts = [open(p).read() for p in logs]
    if any(rcs):
        bad = next(r for r, rc in enumerate(rcs) if rc)
        raise RuntimeError(f"dryrun_multichip: rank {bad} exited {rcs[bad]}:\n{texts[bad][-3000:]}")
    line = next(ln for ln in texts[0].splitlines() if ln.startswith("dryrun_multichip ok: "))
    out = json.loads(line[len("dryrun_multichip ok: "):])
    print("dryrun_multichip ok:", out["metrics"])
    return out
