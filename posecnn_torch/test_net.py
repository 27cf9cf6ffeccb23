"""Evaluate a PoseCNN snapshot on the frozen synthetic frames on the card.

The port of `tools/test_net.py` for the flagship PoseCNN
(`config.flagship_eval_cfg` with the capstone's test settings,
`config.FLAGSHIP_TEST`: NMS 0.3, depth ICP with the point-to-plane term at
weight 1.0): `engine.test.test_net` over `lov_syn_val_v4`, scored by
`data.imdb.PoseEvaluator` (ADD-S for the 3 symmetric YCB classes). The
object models are stand-ins (`data/lov_syn.py`), so the ADD-S numbers are
not comparable with the paper's.

Usage: python -m posecnn_torch.test_net [--model SNAPSHOT.npz] [--max_frames N]
           [--eval_batch B] [--icp_plane_weight W] [--output DIR] [--device cuda]

--model takes an npz snapshot of either package (without it, the seed-0
weights of `entry`). Writes to the output directory: `detections.npz`
(keys `<frame:06d>_<rois|poses|poses_refined|poses_icp>`) and
`eval_summary.json`, as the JAX CLI does, and `eval_timing.json`: the
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
    ap.add_argument("--imdb", default="lov_syn_val_v4", choices=["lov_syn_val_v4"])
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--eval_batch", type=int, default=1, help="frames per inference call")
    ap.add_argument("--icp_plane_weight", type=float, default=None, help="override the point-to-plane weight (1.0)")
    ap.add_argument("--output", default=None, help="default output/lov_syn_capstone/lov_syn_val_v4/vgg16_convs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from posecnn_torch.config import EXP_DIR, FLAGSHIP_TEST, PIXEL_MEANS, flagship_eval_cfg
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.data.imdb import YCB_SYMMETRIC_EVAL, PoseEvaluator
    from posecnn_torch.data.lov_syn import LovSynVal
    from posecnn_torch.engine import test as engine
    from posecnn_torch.ops import conv3x3, voting

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("test_net: no CUDA device (pass --device cpu to evaluate on the CPU)", file=sys.stderr)
        return 2
    if args.model and not args.model.endswith(".npz"):
        raise NotImplementedError(f"{args.model}: only npz snapshots are read (TF1 .ckpt needs tensorflow)")
    cfg = flagship_eval_cfg()
    if args.model:
        with np.load(args.model) as d:
            weights = {k: d[k] for k in d.files if not k.startswith("['opt_state']")}  # the trace is not read
    else:
        weights = init_params_numpy(0, cfg)
    model = make_model(cfg, weights, args.device)
    dataset = LovSynVal()
    sym = [c for c in dataset.classes if c in YCB_SYMMETRIC_EVAL]
    evaluator = PoseEvaluator(dataset.classes, dataset._extents, dataset._points, sym)
    out_dir = args.output or os.path.join(ROOT, "output", EXP_DIR, dataset.name, "vgg16_convs")
    os.makedirs(out_dir, exist_ok=True)
    test_cfg = dict(FLAGSHIP_TEST)
    if args.icp_plane_weight is not None:
        test_cfg["icp_plane_weight"] = args.icp_plane_weight

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
        json.dump({"device": device, "frames": len(results), "eval_batch": args.eval_batch, "wall_s": wall,
                   "launches": launches, "ms": timings, **test_cfg}, f, indent=1)
    print(json.dumps(summary, indent=2))
    print(f"{len(results)} frames in {wall:.3f} s on {device}; launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
