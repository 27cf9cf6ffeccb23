"""Evaluate a PoseCNN snapshot on the card.

With --cfg, the port of `tools/test_net.py` for the VGG16 PoseCNN: the
model config comes from the config's TEST section
(`core.config.test_model_cfg`), the dataset from `data.factory` (--imdb:
toy_val, the default, or lov_syn_val_v4), and TEST.NMS, TEST.POSE_REFINE,
TPU.ICP_PLANE_WEIGHT and TEST.REFERENCE_NMS_BUG from the config
(`core.config.test_settings`). The evaluator scores the YCB symmetric
classes with ADD-S where the dataset has YCB classes, and otherwise the
dataset's own symmetric classes (the last cuboid of `toy`). Without
--model, the weights are drawn from numpy seed RNG_SEED. The output
directory is output/<EXP_DIR>/<imdb>/<network> unless --output.

Without --cfg, the flagship evaluation: `config.flagship_eval_cfg` with the
capstone's test settings (`config.FLAGSHIP_TEST`: NMS 0.3, depth ICP with
the point-to-plane term at weight 1.0) on `lov_syn_val_v4`, with ADD-S for
the 3 symmetric YCB classes; without --model, the seed-0 weights of
`entry`. Its object models are stand-ins (`data/lov_syn.py`), so its ADD-S
numbers are not comparable with the paper's.

Usage: python -m posecnn_torch.test_net [--cfg FILE.yml] [--imdb NAME] [--model SNAPSHOT.npz]
           [--max_frames N] [--eval_batch B] [--icp_plane_weight W] [--output DIR] [--device cuda]

--model takes an npz snapshot of either package. Writes to the output
directory: `detections.npz` (keys `<frame:06d>_<rois|poses|poses_refined|poses_icp>`)
and `eval_summary.json`, as the JAX CLI does, and `eval_timing.json`: the
device, per-frame milliseconds by stage and the kernels' launches.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, help="an npz snapshot (train state or params) of either package")
    ap.add_argument("--cfg", default=None, help="an experiments/cfgs/*.yml config (without it: the flagship eval)")
    ap.add_argument("--imdb", default=None, choices=["toy_val", "lov_syn_val_v4"],
                    help="dataset (default toy_val with --cfg, lov_syn_val_v4 without)")
    ap.add_argument("--network", default="vgg16_convs")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--eval_batch", type=int, default=1, help="frames per inference call")
    ap.add_argument("--icp_plane_weight", type=float, default=None, help="override TPU.ICP_PLANE_WEIGHT")
    ap.add_argument("--output", default=None, help="output directory")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from posecnn_torch.config import PIXEL_MEANS
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.data.imdb import YCB_SYMMETRIC_EVAL, PoseEvaluator
    from posecnn_torch.engine import test as engine
    from posecnn_torch.ops import conv3x3, voting

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("test_net: no CUDA device (pass --device cpu to evaluate on the CPU)", file=sys.stderr)
        return 2
    if args.model and not args.model.endswith(".npz"):
        raise NotImplementedError(f"{args.model}: only npz snapshots are read (TF1 .ckpt needs tensorflow)")
    if args.network != "vgg16_convs":
        raise NotImplementedError(f"--network {args.network}: only vgg16_convs is ported")
    if args.cfg:
        from posecnn_torch.core import config as C
        from posecnn_torch.data.factory import get_imdb

        config = C.cfg_from_file(args.cfg)
        dataset = get_imdb(args.imdb or "toy_val")
        cfg = C.test_model_cfg(config, dataset.num_classes)
        test_cfg = C.test_settings(config)
        seed = config.RNG_SEED
        out_dir = args.output or C.get_output_dir(config, dataset.name, args.network)
    else:
        from posecnn_torch.config import EXP_DIR, FLAGSHIP_TEST, flagship_eval_cfg
        from posecnn_torch.data.lov_syn import LovSynVal

        if args.imdb not in (None, "lov_syn_val_v4"):
            ap.error("without --cfg the flagship eval scores lov_syn_val_v4")
        dataset, cfg, test_cfg, seed = LovSynVal(), flagship_eval_cfg(), dict(FLAGSHIP_TEST), 0
        out_dir = args.output or os.path.join(ROOT, "output", EXP_DIR, dataset.name, args.network)
    if args.icp_plane_weight is not None:
        test_cfg["icp_plane_weight"] = args.icp_plane_weight
    if args.model:
        with np.load(args.model) as d:
            weights = {k: d[k] for k in d.files if not k.startswith("['opt_state']")}  # the trace is not read
    else:
        weights = init_params_numpy(seed, cfg)
    model = make_model(cfg, weights, args.device)
    sym = [c for c in dataset.classes if c in YCB_SYMMETRIC_EVAL] or [
        dataset.classes[i] for i in range(dataset.num_classes) if dataset._symmetry[i] > 0
    ]
    evaluator = PoseEvaluator(dataset.classes, dataset._extents, dataset._points, sym)
    os.makedirs(out_dir, exist_ok=True)

    timings = {}
    voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = 0
    t0 = time.perf_counter()
    results = engine.test_net(model, cfg, dataset, PIXEL_MEANS, evaluator=evaluator, max_frames=args.max_frames,
                              log=lambda m: print(m, flush=True), eval_batch=args.eval_batch, timings=timings,
                              **test_cfg)
    wall = time.perf_counter() - t0
    launches = {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES}

    arrays = {f"{fi:06d}_{k}": np.asarray(v) for fi, r in enumerate(results) for k, v in r.items() if v is not None}
    np.savez_compressed(os.path.join(out_dir, "detections.npz"), **arrays)
    summary = evaluator.summary()
    with open(os.path.join(out_dir, "eval_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    device = torch.cuda.get_device_name(0) if args.device.startswith("cuda") else "cpu"
    with open(os.path.join(out_dir, "eval_timing.json"), "w") as f:
        json.dump({"device": device, "imdb": dataset.name, "frames": len(results), "eval_batch": args.eval_batch,
                   "wall_s": wall, "launches": launches, "ms": timings, **test_cfg}, f, indent=1)
    print(json.dumps(summary, indent=2))
    print(f"{len(results)} frames in {wall:.3f} s on {device}; launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
