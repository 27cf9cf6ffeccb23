"""Evaluate a PoseCNN snapshot on the card.

With --cfg, the port of `tools/test_net.py` for the VGG16 PoseCNN: the
model config comes from the config's TEST section
(`core.config.test_model_cfg`), the dataset from `data.factory` (--imdb,
any of its names; default toy_val), and TEST.NMS, TEST.POSE_REFINE,
TPU.ICP_PLANE_WEIGHT, TEST.REFERENCE_NMS_BUG and TEST.SCALES_BASE from the
config (`core.config.test_settings`). The evaluator scores the YCB
symmetric classes with ADD-S where the dataset has YCB classes, and
otherwise the dataset's own symmetric classes (the last cuboid of `toy`);
a dataset with `diameters` (LINEMOD) is scored at 0.1 x its diameter, and
eggbox and glue get the reprojection metric's z-flip
(`tools/test_net.py:162-172`). Without
--model, the weights are drawn from numpy seed RNG_SEED. The output
directory is output/<EXP_DIR>/<imdb>/<network> unless --output.

With --cfg of NETWORK VGG16FULL (or --network vgg16_full), the all-scale
network (`models.posecnn_full`, its pose branch crop-pooling at inference)
through the same evaluation, its parameters built and read at its own
shapes (the JAX CLI builds PoseCNN's there, and its forward fails). A
snapshot trained with the domain head (TRAIN.ADAPT) is scored without it:
its fc9 and domain_score are not read, as JAX's `restore_checkpoint`
reads only the keys of the model it restores into.

With --cfg of NETWORK FCN8VGG (or --network fcn8_vgg), the segmentation
evaluation (`segmentation`): the colour frames through FCN-8s, scored by
the label IoU; with --network resnet50 (or NETWORK RESNET50), under any
config but VGG16DET's, as the JAX CLI picks it, the same through
ResNet-50; `eval_summary.json`, `eval_timing.json` and the mean IoU
printed. With --cfg of NETWORK VGG16DET, the detection evaluation
(`detection`): VOC AP@0.5 per class and its mean (`mAP@0.5`) in
`eval_summary.json`. With TEST.VERTEX_REG_3D, the 3D head's object
coordinates and the depth give each class's pose by RANSAC
(`engine.test.decode_poses_3d`). A PoseCNN config without the pose head
(TEST.POSE_REG False) scores Hough's poses; the model is built for the COLOR input whatever
INPUT says, as the JAX CLI builds it. --model must hold every parameter
of that model at its shape: a snapshot that lacks one, or whose
parameters do not fit (the RGBD input's), raises ValueError.

Without --cfg, the flagship evaluation: `config.flagship_eval_cfg` with the
capstone's test settings (`config.FLAGSHIP_TEST`: NMS 0.3, depth ICP with
the point-to-plane term at weight 1.0) on `lov_syn_val_v4`, with ADD-S for
the 3 symmetric YCB classes; without --model, the seed-0 weights of
`entry`. Its object models are stand-ins (`data/lov_syn.py`), so its ADD-S
numbers are not comparable with the paper's.

With TPU.DEBUG_NANS the evaluation runs under `utils.debug_nans`
(FloatingPointError at the first operation with a NaN output; with
TPU.DEBUG_DISABLE_JIT too, inside the inference calls as well).

With --vis, or TEST.VISUALIZE, the PoseCNN evaluations (VGG16FULL's too)
write each frame's overlay as <output>/vis/<frame:06d>-vis.png
(`engine.visualize.PredictionVisualizer`: the label map, each detection's
box and class name, its pose's projected 3D box, the ICP poses when ICP
ran); the segmentation and detection evaluations draw none, as in the JAX
CLI.

Usage: python -m posecnn_torch.test_net [--cfg FILE.yml] [--imdb NAME] [--model SNAPSHOT.npz]
           [--max_frames N] [--eval_batch B] [--icp_plane_weight W] [--output DIR] [--vis] [--device cuda]

--model takes an npz snapshot or an orbax directory of either package
(every parameter of the model), a vgg16.npy or a TF1 checkpoint prefix
(read without TensorFlow), whose weights replace the seed weights they
name, as in the JAX CLI. Writes to the output
directory: `detections.npz` (keys `<frame:06d>_<rois|poses|poses_refined|poses_icp>`)
and `eval_summary.json`, as the JAX CLI does, and `eval_timing.json`: the
device, per-frame milliseconds by stage, the kernels' launches, the
evaluator's ADD threshold of each class and, on a card, the peak device
memory.
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
    ap.add_argument("--model", default=None, help="an npz snapshot (train state or params) or orbax directory of "
                    "either package, a vgg16.npy or a TF1 checkpoint prefix")
    ap.add_argument("--cfg", default=None, help="an experiments/cfgs/*.yml config (without it: the flagship eval)")
    ap.add_argument("--imdb", default=None, help="dataset (default toy_val with --cfg, lov_syn_val_v4 without)")
    ap.add_argument("--network", default="vgg16_convs")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--eval_batch", type=int, default=1, help="frames per inference call")
    ap.add_argument("--icp_plane_weight", type=float, default=None, help="override TPU.ICP_PLANE_WEIGHT")
    ap.add_argument("--output", default=None, help="output directory")
    ap.add_argument("--vis", action="store_true",
                    help="write prediction overlays (TEST.VISUALIZE) under <output>/vis")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("test_net: no CUDA device (pass --device cpu to evaluate on the CPU)", file=sys.stderr)
        return 2
    from posecnn_torch.core import config as C
    from posecnn_torch.utils.debug_nans import debug_nans

    config = C.cfg_from_file(args.cfg) if args.cfg else None
    # TPU.DEBUG_NANS: the whole evaluation under the NaN check
    with debug_nans(config is not None and config.TPU.DEBUG_NANS,
                    disable_jit=config is not None and config.TPU.DEBUG_DISABLE_JIT):
        return _evaluate(args, ap, config)


def _evaluate(args, ap, config) -> int:
    """The evaluation of `main` once the config is read."""
    import numpy as np
    import torch

    from posecnn_torch.config import PIXEL_MEANS
    from posecnn_torch.core import config as C
    from posecnn_torch.core.checkpoint import load_weights, restore_params
    from posecnn_torch.core.convert import make_model, param_shapes
    from posecnn_torch.data.imdb import YCB_SYMMETRIC_EVAL, PoseEvaluator
    from posecnn_torch.engine import test as engine
    from posecnn_torch.models.factory import get_network
    from posecnn_torch.models.posecnn_full import make_full_model

    # NETWORK and --network with the JAX CLI's precedence
    # (tools/test_net.py:61-109); VGG16GAN is scored as PoseCNN; a network
    # the port does not run raises here
    name = C.pick_network(getattr(config, "NETWORK", None), args.network)
    init_fn, forward_fn = get_network(name)
    if args.cfg:
        from posecnn_torch.data.factory import get_imdb

        dataset = get_imdb(args.imdb or "toy_val")
        if name in ("fcn8_vgg", "resnet50"):
            return segmentation(args, config, dataset, name, init_fn, forward_fn)
        if name == "vgg16_det":
            return detection(args, config, dataset, init_fn)
        cfg = C.test_model_cfg(config, dataset.num_classes)
        test_cfg = C.test_settings(config)
        seed = config.RNG_SEED
        out_dir = args.output or C.get_output_dir(config, dataset.name, args.network)
    else:
        from posecnn_torch.config import EXP_DIR, FLAGSHIP_TEST, flagship_eval_cfg
        from posecnn_torch.data.lov_syn import LovSynVal

        if name != "vgg16_convs":
            ap.error("without --cfg the flagship eval runs vgg16_convs")
        if args.imdb not in (None, "lov_syn_val_v4"):
            ap.error("without --cfg the flagship eval scores lov_syn_val_v4")
        dataset, cfg, test_cfg, seed = LovSynVal(), flagship_eval_cfg(), dict(FLAGSHIP_TEST), 0
        out_dir = args.output or os.path.join(ROOT, "output", EXP_DIR, dataset.name, args.network)
    if args.icp_plane_weight is not None:
        test_cfg["icp_plane_weight"] = args.icp_plane_weight
    full = name == "vgg16_full"
    if args.model and (args.model.endswith(".npz") or os.path.isdir(args.model)):
        weights = restore_params(args.model, param_shapes(cfg, name))
    else:
        # a vgg16.npy or a TF1 checkpoint over the seed weights
        # (tools/test_net.py:146-152)
        weights = load_weights(args.model, init_fn(seed, cfg)) if args.model else init_fn(seed, cfg)
    model = (make_full_model if full else make_model)(cfg, weights, args.device)
    sym = [c for c in dataset.classes if c in YCB_SYMMETRIC_EVAL] or [
        dataset.classes[i] for i in range(dataset.num_classes) if dataset._symmetry[i] > 0
    ]
    evaluator = PoseEvaluator(dataset.classes, dataset._extents, dataset._points, sym,
                              diameters=getattr(dataset, "diameters", None),
                              flip_z_classes=[c for c in ("eggbox", "glue") if c in dataset.classes])
    os.makedirs(out_dir, exist_ok=True)
    visualizer = None
    if args.vis or (config is not None and config.TEST.VISUALIZE):
        from posecnn_torch.engine.visualize import PredictionVisualizer

        visualizer = PredictionVisualizer(os.path.join(out_dir, "vis"), dataset.classes, dataset._extents)

    timings = {}
    _reset_launches()
    t0 = time.perf_counter()
    results = engine.test_net(model, cfg, dataset, PIXEL_MEANS, evaluator=evaluator, max_frames=args.max_frames,
                              log=lambda m: print(m, flush=True), eval_batch=args.eval_batch, timings=timings,
                              forward_fn=forward_fn, visualizer=visualizer, **test_cfg)
    wall = time.perf_counter() - t0
    launches = _launches()

    arrays = {f"{fi:06d}_{k}": np.asarray(v) for fi, r in enumerate(results) for k, v in r.items() if v is not None}
    np.savez_compressed(os.path.join(out_dir, "detections.npz"), **arrays)
    summary = evaluator.summary()
    with open(os.path.join(out_dir, "eval_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    device = torch.cuda.get_device_name(0) if args.device.startswith("cuda") else "cpu"
    with open(os.path.join(out_dir, "eval_timing.json"), "w") as f:
        json.dump({"device": device, "imdb": dataset.name, "frames": len(results), "eval_batch": args.eval_batch,
                   "wall_s": wall, "launches": launches, "ms": timings, **test_cfg, **_peak(args.device),
                   "thresholds": {dataset.classes[c]: evaluator._threshold(c) for c in range(1, dataset.num_classes)}},
                  f, indent=1)
    print(json.dumps(summary, indent=2))
    print(f"{len(results)} frames in {wall:.3f} s on {device}; launches {launches}", flush=True)
    return 0


def _reset_launches() -> None:
    from posecnn_torch.ops import conv3x3, nms, voting

    voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = nms.NMS_LAUNCHES = 0


def _launches() -> dict:
    """Each kernel's launches since `_reset_launches`."""
    from posecnn_torch.ops import conv3x3, nms, voting

    return {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES, "nms": nms.NMS_LAUNCHES}


def _peak(device: str) -> dict:
    """The process's peak device memory, on a card."""
    import torch

    return {"peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20} if device.startswith("cuda") else {}


def detection(args, config, dataset, init_fn) -> int:
    """NETWORK VGG16DET (`tools/test_net.py:66-95`): the detection network
    with the TEST section's RPN settings (`core.config.det_model_cfg`), from
    numpy seed RNG_SEED or the parameters of --model (every one at its
    shape, as for PoseCNN: the JAX CLI hands `restore_checkpoint` a params
    dict there and fails); `engine.test.test_net_detection` at TEST.NMS,
    scored by `DetectionEvaluator` (VOC AP@0.5 against the boxes of the GT
    poses); `eval_summary.json` (`ap_per_class`, `mAP@0.5`) and
    `eval_timing.json`. The output directory ends in vgg16_det."""
    import torch

    from posecnn_torch.core import config as C
    from posecnn_torch.core.checkpoint import restore_params
    from posecnn_torch.core.convert import param_shapes
    from posecnn_torch.engine import test as engine
    from posecnn_torch.models.detection import make_det_model

    det_cfg = C.det_model_cfg(config, dataset.num_classes, train=False)
    params = restore_params(args.model, param_shapes(det_cfg)) if args.model else init_fn(config.RNG_SEED, det_cfg)
    model = make_det_model(det_cfg, params, args.device)
    evaluator = engine.DetectionEvaluator(dataset.classes)
    out_dir = args.output or C.get_output_dir(config, dataset.name, "vgg16_det")
    os.makedirs(out_dir, exist_ok=True)
    timings = {}
    _reset_launches()
    t0 = time.perf_counter()
    results = engine.test_net_detection(model, det_cfg, dataset, config.pixel_means(), evaluator=evaluator,
                                        max_frames=args.max_frames, nms_threshold=config.TEST.NMS,
                                        log=lambda m: print(m, flush=True), timings=timings)
    wall = time.perf_counter() - t0
    summary = evaluator.summary()
    with open(os.path.join(out_dir, "eval_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    device = torch.cuda.get_device_name(0) if args.device.startswith("cuda") else "cpu"
    launches = _launches()
    with open(os.path.join(out_dir, "eval_timing.json"), "w") as f:
        json.dump({"device": device, "imdb": dataset.name, "frames": len(results), "wall_s": wall,
                   "detections": [len(d) for d in results], "launches": launches, "ms": timings,
                   **_peak(args.device)}, f, indent=1)
    print(json.dumps(summary, indent=2))
    print(f"{len(results)} frames in {wall:.3f} s on {device}; launches {launches}", flush=True)
    return 0


def segmentation(args, config, dataset, name, init_fn, forward) -> int:
    """The segmentation networks (`tools/test_net.py:99-127`): network
    `name` (fcn8_vgg or resnet50; the factory's `init_fn`, `forward`) from
    numpy seed RNG_SEED, or the parameters of --model read as the JAX
    package's `load_params_npz` reads them, at the network's shapes (JAX's
    CLI hands `restore_checkpoint` a params dict there, and fails);
    `engine.test.test_net_segmentation` on the dataset's colour frames; the
    IoU summary in `eval_summary.json` and the mean IoU printed. The output
    directory ends in the network's name."""
    import torch

    from posecnn_torch.core import config as C
    from posecnn_torch.core.checkpoint import load_params_npz
    from posecnn_torch.data.imdb import PoseEvaluator
    from posecnn_torch.engine import test as engine
    from posecnn_torch.models.fcn8 import make_fcn8
    from posecnn_torch.models.resnet50 import make_resnet50

    n = dataset.num_classes
    params = init_fn(config.RNG_SEED, n)
    if args.model:
        params = load_params_npz(args.model, params, log=lambda m: print(m, flush=True))
    model = (make_fcn8 if name == "fcn8_vgg" else make_resnet50)(n, params, args.device)
    evaluator = PoseEvaluator(dataset.classes, dataset._extents, dataset._points, [])
    out_dir = args.output or C.get_output_dir(config, dataset.name, name)
    os.makedirs(out_dir, exist_ok=True)
    timings = {}
    _reset_launches()
    t0 = time.perf_counter()
    engine.test_net_segmentation(model, lambda m, d: forward(m, d, n), dataset, config.pixel_means(),
                                 evaluator=evaluator, max_frames=args.max_frames,
                                 log=lambda m: print(m, flush=True), timings=timings)
    wall = time.perf_counter() - t0
    summary = evaluator.summary()
    with open(os.path.join(out_dir, "eval_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    device = torch.cuda.get_device_name(0) if args.device.startswith("cuda") else "cpu"
    launches = _launches()
    with open(os.path.join(out_dir, "eval_timing.json"), "w") as f:
        json.dump({"device": device, "imdb": dataset.name, "network": name, "frames": len(timings.get("infer", [])),
                   "wall_s": wall, "launches": launches, "ms": timings, **_peak(args.device)}, f, indent=1)
    print(json.dumps({"mean_iou": summary["mean_iou"]}, indent=2))
    print(f"{len(timings.get('infer', []))} frames in {wall:.3f} s on {device}; launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
