"""PoseCNN on the demo's RGB-D frames, on the card.

Port of `tools/demo.py`. Each `NNNNNN-color.png` under --images (default
$POSECNN_DEMO_IMAGES, else data/demo_images) runs through the model with
the demo camera's hard-coded intrinsics (`DEMO_K`, the reference's
tools/demo.py:101-103) and writes, in --output:

  NNNNNN-dets.json   [{"class", "box", "score", "pose_quat_wxyz",
                     "pose_t"}, ...], and "pose_quat_wxyz_icp", "pose_t_icp"
                     with --refine (or TEST.POSE_REFINE)
  NNNNNN-label.png   the label map in the YCB class colours
  NNNNNN-vis.png     with --visualize (or TEST.VISUALIZE): the overlay of
                     `engine.visualize.PredictionVisualizer`

The model is PoseCNN of 22 classes and 64 units with the config's class
slots, samples and centre stride (`core.config.demo_model_cfg`), the seed
weights of RNG_SEED or --model (`core.checkpoint.load_weights`: an npz or
orbax snapshot, a vgg16.npy or a TF1 checkpoint), the extents of
`get_imdb("lov_syn_train").extents` where that dataset has them, else 0.1 m
for every class (as in the JAX tool, whose datasets have none). The ICP
refinement (`engine.test.refine_poses`) reads `NNNNNN-depth.png` beside the
frame (16-bit, 1/10000 m) and the model points of lov_syn_train; without
them it is disabled with the JAX tool's message. The last line gives the
kernels' launches over the frames.

Usage: python -m posecnn_torch.tools.demo [--images DIR] [--output DIR] [--model SNAPSHOT] [--cfg FILE.yml]
           [--visualize] [--refine] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from types import SimpleNamespace

import numpy as np

DEMO_K = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]], dtype=np.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, help="npz or orbax snapshot, vgg16.npy or TF1 checkpoint")
    ap.add_argument("--cfg", dest="cfg_file", default=None)
    ap.add_argument("--images", default=os.environ.get("POSECNN_DEMO_IMAGES", "data/demo_images"),
                    help="directory with NNNNNN-color.png frames")
    ap.add_argument("--output", default="output/demo")
    ap.add_argument("--visualize", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--refine", action="store_true",
                    help="ICP pose refinement against NNNNNN-depth.png (TEST.POSE_REFINE)")
    args = ap.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("demo: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    from posecnn_torch.core import config as C
    from posecnn_torch.core.checkpoint import load_weights
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.data.lov import YCB_CLASS_COLORS, YCB_CLASSES
    from posecnn_torch.engine.test import make_inference_fn, postprocess_detections, refine_poses
    from posecnn_torch.test_net import _launches, _reset_launches
    from posecnn_torch.utils.meta import build_meta_data
    from posecnn_torch.utils.png import IMREAD_COLOR, IMREAD_UNCHANGED, imread, write_png

    cfg = C.cfg_from_file(args.cfg_file) if args.cfg_file else C.Config()
    model_cfg = C.demo_model_cfg(cfg)
    params = init_params_numpy(cfg.RNG_SEED, model_cfg)
    if args.model:
        params = load_weights(args.model, params, log=print)
    dev = torch.device(args.device)
    model = make_model(model_cfg, params, dev)
    infer = make_inference_fn(model_cfg, cfg.pixel_means(), dev)
    try:
        extents = np.asarray(get_imdb("lov_syn_train").extents, np.float32)
    except Exception:  # noqa: BLE001 - the JAX tool's fallback
        extents = np.ones((22, 3), np.float32) * 0.1
    extents_t = torch.from_numpy(extents).to(dev)
    meta = torch.from_numpy(build_meta_data(DEMO_K)[None]).to(dev)

    os.makedirs(args.output, exist_ok=True)
    visualizer = None
    if args.visualize or cfg.TEST.VISUALIZE:
        from posecnn_torch.engine.visualize import PredictionVisualizer

        visualizer = PredictionVisualizer(args.output, YCB_CLASSES, extents)
    frames = sorted(glob.glob(os.path.join(args.images, "*-color.png")))
    print(f"{len(frames)} demo frames")
    _reset_launches()
    refine = args.refine or cfg.TEST.POSE_REFINE
    points_all = None
    if refine:
        try:
            points_all = torch.from_numpy(np.asarray(get_imdb("lov_syn_train")._points_all, np.float32)).to(dev)
        except Exception:  # noqa: BLE001 - the JAX tool's message
            refine = False
            print("POSE_REFINE disabled: dataset model points unavailable")
    for fi, path in enumerate(frames):
        im = imread(path, IMREAD_COLOR)
        out = {k: v.cpu() for k, v in infer(model, torch.from_numpy(im[None]).to(dev), meta, extents_t).items()}
        rois, poses = postprocess_detections(out)
        name = os.path.basename(path).replace("-color.png", "")
        label = out["label_2d"][0].numpy()
        poses_icp = None
        depth_path = path.replace("-color.png", "-depth.png")
        if refine and rois.shape[0] and os.path.exists(depth_path):
            # the reference demo's factor_depth 10000 for the YCB 16-bit PNGs
            depth_m = imread(depth_path, IMREAD_UNCHANGED).astype(np.float32) / 10000.0
            _, poses_icp = refine_poses(rois, poses, depth_m, label, points_all, build_meta_data(DEMO_K))
        if visualizer is not None:
            visualizer(fi, SimpleNamespace(color=im, intrinsic_matrix=DEMO_K), out, rois, poses)
        vis = np.zeros(label.shape + (3,), dtype=np.uint8)
        for c, col in enumerate(YCB_CLASS_COLORS):
            vis[label == c] = col[::-1]
        write_png(os.path.join(args.output, f"{name}-label.png"), vis)
        dets = [
            {
                "class": YCB_CLASSES[int(r[1])],
                "box": [float(v) for v in r[2:6]],
                "score": float(r[6]),
                "pose_quat_wxyz": [float(v) for v in p[:4]],
                "pose_t": [float(v) for v in p[4:7]],
            }
            for r, p in zip(rois, poses)
        ]
        if poses_icp is not None:
            for d, p in zip(dets, poses_icp):
                d["pose_quat_wxyz_icp"] = [float(v) for v in p[:4]]
                d["pose_t_icp"] = [float(v) for v in p[4:7]]
        with open(os.path.join(args.output, f"{name}-dets.json"), "w") as f:
            json.dump(dets, f, indent=2)
        print(name, f"{len(dets)} detections")
    print("demo artifacts in", args.output)
    print(f"launches {json.dumps(_launches())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
