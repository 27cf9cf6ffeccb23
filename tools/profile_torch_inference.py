"""Where a flagship inference frame, a flagship training step or a
flagship eval frame of the PyTorch port spends its time; with `--toy`, a
toy training step or eval frame.

Inference (default): `posecnn_torch` flagship inference (640x480, bf16,
seeded weights) on frozen frames. Training (`--train`): the flagship
training step of `posecnn_torch.entry.train_entry` (B=2 at 640x480, bf16,
device bank). Evaluation (`--eval`): `engine.test.test_net` as
`python -m posecnn_torch.test_net` runs it on the seed-0 weights (the eval
config, NMS 0.3, depth ICP, the evaluator). With `--toy`, the training
step and the eval frames are those of `experiments/cfgs/toy_pose.yml` (B=2
at 96x128, bf16, 4 classes, RNG_SEED weights): `--train --toy` the
host-fed step on batches of `GtSynthesizeLayer` moved to the card
beforehand (no data thread), `--eval --toy` `test_net` on `toy_val` (no
ICP). With `--det`, the detection network of
`experiments/cfgs/lov_det.yml` (640x480, bf16, 22 classes, RNG_SEED
weights): `--det` `test_net_detection`'s frames on `lov_syn_val_v4`,
`--det --train` its training step (B=1, batches of
`engine.train.det_batch_from_frame` moved to the card beforehand; `--lr`
sets its learning rate: the cfg's 0.001 diverges from the init rules
within a few steps, and NMS then keeps every NaN box). With
`--3d`, `test_net` under `experiments/cfgs/lov_color_3d.yml` on
`lov_syn_val_v4` (the 3D head, RANSAC on the card). With `--full --train`
and `--adapt --train`, the host-fed step of
`experiments/cfgs/lov_color_2d_full.yml` (VGG16FULL) or of
`lov_color_sugar_box_adapt.yml` (PoseCNN with the domain head) on
`lov_syn_val_v4` (B=2 at 640x480, bf16, RNG_SEED weights, batches of
`GtSynthesizeLayer` moved to the card beforehand), after `--warm` steps
that train the weights before the profiled ones. With `--resnet50`,
ResNet-50 (`--network resnet50` under
`experiments/cfgs/rgbd_scene_single_color_fcn8.yml`, 640x480, bf16,
RNG_SEED weights, 10 classes): `--resnet50` `test_net_segmentation`'s
frames on `lov_syn_val_v4`, `--resnet50 --train` its segmentation step
(B=2, batches of `GtSynthesizeLayer` moved to the card beforehand). With
`--video`, the video model (`VideoConfig`: 22 classes, 64 units, 640x480,
bf16, RNG_SEED weights): `--video` `test_net_video` over the first frozen
frames of `lov_syn_val_v4` as one video with KinectFusion at grid 128,
`--video --train` its step (T=5, B=1, `GtDataLayer` windows of those
frames moved to the card beforehand). Runs
under torch.profiler and
prints the device's busy share of the profiled wall window, host and device
time per stage, and the device time by kernel (the `--top` largest).

Stages are spans this tool opens around the calls into each layer. For
inference: the trunk, Hough voting, RoI pooling, the fc layers and host NMS;
"heads and the rest" is the rest of the frame. For training: batch sampling,
preprocessing (jitter, noise), the trunk's forward, Hough voting, the crop
pool, the fc layers, the loss functions and the optimizer update; "backward
and the rest" is the rest of the step (the backward runs on autograd's own
thread, outside the spans). For evaluation: the trunk, Hough voting, the
crop pool, the fc layers, host NMS, the ICP (`refine_poses`) and the
evaluator. For the detection network: the trunk, the RPN heads, the anchor
targets, the proposals (decode, top-k, NMS), the proposal targets, the crop
pool, the fc layers (fc6 to the output heads), and for evaluation the host
postprocess (per-class NMS) and the evaluator, for training the loss
functions and the update. For the 3D head: the trunk, the RANSAC decode and
the evaluator. For ResNet-50: its convolutions (cuDNN, each with its cast
and padding), its batch norms (with their ReLUs), the upscore, and for
training the loss and the update. For the video model: the trunk, the flow
warp's forward, the GRU, and for training the losses and the update (the
backward, the flow's scatter among it, is the rest), for evaluation
KinectFusion's bilateral filter, tracking, fusion and surface. Needs one
NVIDIA GPU.

Usage: python tools/profile_torch_inference.py [--train | --eval] [--toy | --det | --3d | --full | --adapt | --resnet50
           | --video] [--lr LR] [--warm 2] [--frames 6] [--top 25]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _spans(stages, record_function):
    """Wrap each (owner, attribute) of a stage in a record_function span of
    the stage's name."""

    def span(name, fn):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    for name, targets in stages.items():
        for owner, attr in targets:
            setattr(owner, attr, span(name, getattr(owner, attr)))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from posecnn_torch.config import PIXEL_MEANS, RNG_SEED, flagship_cfg
    from posecnn_torch.engine import test as engine
    from posecnn_torch.engine import train as trainer
    from posecnn_torch.entry import entry, train_entry
    from posecnn_torch.models import backbone, layers
    from posecnn_torch.models import posecnn as model_mod
    from posecnn_torch.utils.meta import build_meta_data

    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true", help="profile the flagship training step")
    ap.add_argument("--eval", action="store_true", help="profile test_net's frames (ICP on)")
    ap.add_argument("--toy", action="store_true", help="with --train or --eval: the toy_pose.yml step or frames")
    ap.add_argument("--det", action="store_true", help="the detection network's eval frames (--train: its step)")
    ap.add_argument("--3d", dest="three_d", action="store_true", help="test_net's frames with the 3D head")
    ap.add_argument("--lr", type=float, default=None,
                    help="with --det --train: the learning rate (lov_det.yml's 0.001 diverges from the init rules)")
    ap.add_argument("--full", action="store_true", help="with --train: the VGG16FULL step")
    ap.add_argument("--adapt", action="store_true", help="with --train: the step with the domain head")
    ap.add_argument("--resnet50", action="store_true", help="ResNet-50's eval frames (--train: its step)")
    ap.add_argument("--video", action="store_true",
                    help="test_net_video's frames with KinectFusion (--train: the video model's step)")
    ap.add_argument("--warm", type=int, default=2, help="with --full or --adapt: the steps before the profiled ones")
    ap.add_argument("--frames", type=int, default=6, help="frames (or training steps) to profile")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    if args.toy and not (args.train or args.eval):
        ap.error("--toy goes with --train or --eval")
    if args.toy + args.det + args.three_d + args.full + args.adapt + args.resnet50 + args.video > 1 or (
            args.three_d and args.train):
        ap.error("one of --toy, --det, --3d, --full, --adapt, --resnet50 and --video; --3d profiles evaluation")
    if (args.full or args.adapt) and not args.train:
        ap.error("--full and --adapt profile the training step: add --train")
    if args.toy:
        from posecnn_torch.core import config as C
        from posecnn_torch.core.convert import init_params_numpy, make_model
        from posecnn_torch.data.factory import get_imdb

        toy_cfg = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml"))
    if args.det or args.three_d:
        from posecnn_torch.core import config as C
        from posecnn_torch.data.lov_syn import LovSynVal
        from posecnn_torch.models import detection as det_mod
        from posecnn_torch.ops import losses as loss_mod

        data = LovSynVal()
        engine.set_float32_precision()
        det_stages = {
            "stage:trunk": [(backbone.VGGTrunk, "forward")],
            "stage:rpn_heads": [(layers, "conv2d")],
            "stage:anchor_targets": [(det_mod, "anchor_target_layer")],
            "stage:proposals_nms": [(det_mod, "proposal_layer")],
            "stage:proposal_targets": [(det_mod, "proposal_target_layer")],
            "stage:crop_pool": [(det_mod, "crop_pool_batched")],
            "stage:fc": [(layers, "fc")],
        }
    if args.det and args.train:
        cfg_file = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "lov_det.yml"))
        stages = {**det_stages,
                  "stage:losses": [(loss_mod, f) for f in ("smooth_l1_loss", "sparse_softmax_cross_entropy")]
                  + [(trainer, "average_distance_loss"), (trainer, "regularization_loss")],
                  "stage:update": [(trainer.MomentumSGD, "step")]}
        _spans(stages, record_function)
        from posecnn_torch.data.minibatch import rescale_points

        det_cfg, hp = C.det_model_cfg(cfg_file, data.num_classes, train=True), C.det_hparams(cfg_file)
        if args.lr is not None:
            import dataclasses

            hp = dataclasses.replace(hp, learning_rate=args.lr)
        sym = np.asarray(data._symmetry, np.float32)
        pts = rescale_points(np.asarray(data._points_all, np.float32), np.asarray(data._extents), sym)
        state = trainer.create_train_state(det_mod.make_det_model(
            det_cfg, det_mod.init_vgg16_det_params_numpy(cfg_file.RNG_SEED, det_cfg), dev), hp)
        step = trainer.make_det_train_step(det_cfg, hp, torch.from_numpy(pts).to(dev), torch.from_numpy(sym).to(dev))
        runs = [(trainer.to_device(trainer.det_batch_from_frame(data.load_frame(i), cfg_file.TPU.MAX_GT), dev),)
                for i in range(args.frames + 2)]
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg_file.RNG_SEED)

        def run(batch):
            with record_function("stage:frame"):
                step(state, batch, trainer.Draws(gen))

        warmup, runs = runs[:2], runs[2:]
        rest = "backward and the rest"
        unit = "step"
    elif args.det:
        cfg_file = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "lov_det.yml"))
        stages = {k: v for k, v in det_stages.items() if k not in ("stage:anchor_targets", "stage:proposal_targets")}
        stages.update({"stage:postprocess": [(engine, "postprocess_det")],
                       "stage:evaluator": [(engine.DetectionEvaluator, "add_frame")]})
        _spans(stages, record_function)
        det_cfg = C.det_model_cfg(cfg_file, data.num_classes, train=False)
        model = det_mod.make_det_model(det_cfg, det_mod.init_vgg16_det_params_numpy(cfg_file.RNG_SEED, det_cfg), dev)
        evaluator = engine.DetectionEvaluator(data.classes)

        def run(n_frames):
            with record_function("stage:frame"):
                engine.test_net_detection(model, det_cfg, data, cfg_file.pixel_means(), evaluator=evaluator,
                                          max_frames=n_frames, nms_threshold=cfg_file.TEST.NMS, log=None)

        warmup, runs = [(2,)], [(args.frames,)]  # a warm-up call of 2 frames, then the profiled one
        rest = "heads and the rest"
        unit = "frame"
    elif args.three_d:
        from posecnn_torch.core.convert import init_params_numpy, make_model
        from posecnn_torch.data.imdb import YCB_SYMMETRIC_EVAL, PoseEvaluator

        cfg_file = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "lov_color_3d.yml"))
        stages = {"stage:trunk": [(backbone.VGGTrunk, "forward")], "stage:ransac": [(engine, "decode_poses_3d")],
                  "stage:evaluator": [(PoseEvaluator, "add_frame")]}
        _spans(stages, record_function)
        cfg = C.test_model_cfg(cfg_file, data.num_classes)
        model = make_model(cfg, init_params_numpy(cfg_file.RNG_SEED, cfg), dev)
        evaluator = PoseEvaluator(data.classes, data._extents, data._points, list(YCB_SYMMETRIC_EVAL))

        def run(n_frames):
            with record_function("stage:frame"):
                engine.test_net(model, cfg, data, PIXEL_MEANS, evaluator=evaluator, max_frames=n_frames, log=None,
                                **C.test_settings(cfg_file))

        warmup, runs = [(2,)], [(args.frames,)]
        rest = "heads and the rest"
        unit = "frame"
    elif args.video:
        from posecnn_torch.data.lov_syn import LovSynVal
        from posecnn_torch.data.minibatch import MinibatchConfig
        from posecnn_torch.data.video_layer import GtDataLayer
        from posecnn_torch.engine import kfusion
        from posecnn_torch.models import video as video_mod

        data = LovSynVal()
        engine.set_float32_precision()
        cfg = video_mod.VideoConfig(num_classes=data.num_classes)
        model = video_mod.make_video_model(cfg, video_mod.init_video_params_numpy(RNG_SEED, cfg), dev)
        stages = {"stage:trunk": [(backbone.VGGTrunk, "forward")], "stage:flow": [(video_mod, "compute_flow")],
                  "stage:gru": [(video_mod, "gru2d")]}

        class Video:
            """The first n frozen frames as one video."""

            def __init__(self, n):
                self.image_index = [f"v4/{i:06d}" for i in range(n)]

            def load_frame(self, i):
                return data.load_frame(i)

        if args.train:
            stages.update({"stage:losses": [(trainer, "loss_cross_entropy_single_frame"),
                                            (trainer, "regularization_loss")],
                           "stage:update": [(trainer.MomentumSGD, "step")]})
            _spans(stages, record_function)
            state = trainer.create_train_state(model, trainer.TrainHParams())
            step = trainer.make_video_train_step(cfg, trainer.TrainHParams())
            layer = GtDataLayer(Video(16), MinibatchConfig(num_classes=data.num_classes), num_steps=cfg.num_steps,
                                seed=RNG_SEED)
            runs = [(trainer.to_device(layer.forward(), dev),) for _ in range(args.frames + 2)]

            def run(batch):
                with record_function("stage:frame"):
                    step(state, batch)

            warmup, runs = runs[:2], runs[2:]
            rest = "backward and the rest"
            unit = "step"
        else:
            stages.update({"stage:kfusion_filter": [(kfusion, "bilateral_filter")],
                           "stage:kfusion_track": [(kfusion, "solve_pose")],
                           "stage:kfusion_fuse": [(kfusion, "fuse_depth")],
                           "stage:kfusion_surface": [(kfusion, "extract_surface")]})
            _spans(stages, record_function)

            def run(n_frames):
                with record_function("stage:frame"):
                    engine.test_net_video(model, cfg, Video(n_frames), PIXEL_MEANS, kfusion=True,
                                          kfusion_grid=128, log=None)

            warmup, runs = [(2,)], [(args.frames,)]
            rest = "heads, the label map and the rest"
            unit = "frame"
    elif args.resnet50:
        from posecnn_torch.core import config as C
        from posecnn_torch.data.layer import GtSynthesizeLayer
        from posecnn_torch.data.lov_syn import LovSynVal
        from posecnn_torch.models import resnet50 as r50

        cfg_file = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "rgbd_scene_single_color_fcn8.yml"))
        stages = {"stage:convs": [(r50, "_conv")], "stage:batch_norm": [(r50, "_bn")],
                  "stage:upscore": [(layers, "deconv")]}
        if args.train:
            stages.update({"stage:losses": [(trainer, "loss_cross_entropy_single_frame")],
                           "stage:update": [(trainer.MomentumSGD, "step")]})
        _spans(stages, record_function)
        data = LovSynVal()
        n_cls = data.num_classes
        engine.set_float32_precision()
        model = r50.make_resnet50(n_cls, r50.init_resnet50_params_numpy(cfg_file.RNG_SEED, n_cls), dev)
        if args.train:
            hp, mcfg = C.seg_settings(cfg_file, n_cls)
            state = trainer.create_train_state(model, hp)
            step = trainer.make_seg_train_step(lambda m, d, dr: r50.resnet50_forward(m, d, n_cls), hp, n_cls)
            layer = GtSynthesizeLayer(data, mcfg, ims_per_batch=cfg_file.TRAIN.IMS_PER_BATCH, seed=cfg_file.RNG_SEED)
            runs = [(trainer.to_device(layer.forward(), dev),) for _ in range(args.frames + 2)]

            def run(batch):
                with record_function("stage:frame"):
                    step(state, batch, trainer.Draws())

            warmup, runs = runs[:2], runs[2:]
            rest = "backward and the rest"
            unit = "step"
        else:
            def run(n_frames):
                with record_function("stage:frame"):
                    engine.test_net_segmentation(model, lambda m, d: r50.resnet50_forward(m, d, n_cls), data,
                                                 cfg_file.pixel_means(), max_frames=n_frames, log=None)

            warmup, runs = [(2,)], [(args.frames,)]
            rest = "heads and the rest"
            unit = "frame"
    elif args.full or args.adapt:
        from posecnn_torch.core import config as C
        from posecnn_torch.core.convert import init_params_numpy, make_model
        from posecnn_torch.data.layer import GtSynthesizeLayer
        from posecnn_torch.data.lov_syn import LovSynVal
        from posecnn_torch.data.minibatch import rescale_points
        from posecnn_torch.models import posecnn_full as full_mod

        name = "lov_color_2d_full.yml" if args.full else "lov_color_sugar_box_adapt.yml"
        cfg_file = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", name))
        net = full_mod if args.full else model_mod
        stages = {
            "stage:preprocess": [(trainer, "preprocess")],
            "stage:trunk": [(backbone.VGGTrunk, "forward")],
            "stage:hough": [(net, "hough_voting")],
            "stage:crop_pool": [(net, "crop_pool_batched")],
            "stage:fc": [(layers, "fc")],
            "stage:losses": [(trainer, f) for f in ("regularization_loss", "loss_cross_entropy_hard_label_sparse",
                                                    "smooth_l1_loss_vertex_sparse", "average_distance_loss",
                                                    "sparse_softmax_cross_entropy")],
            "stage:update": [(trainer.MomentumSGD, "step")],
        }
        _spans(stages, record_function)
        data = LovSynVal()
        model_cfg, hp = C.train_model_cfg(cfg_file, data.num_classes), C.train_hparams(cfg_file)
        mcfg = C.minibatch_cfg(cfg_file, data.num_classes)
        ext, sym = np.asarray(data._extents, np.float32), np.asarray(data._symmetry, np.float32)
        consts = [torch.from_numpy(a).to(dev) for a in (rescale_points(np.asarray(data._points_all, np.float32),
                                                                       ext, sym), sym, ext)]
        engine.set_float32_precision()
        init, make = ((full_mod.init_posecnn_full_params_numpy, full_mod.make_full_model) if args.full
                      else (init_params_numpy, make_model))
        state = trainer.create_train_state(make(model_cfg, init(cfg_file.RNG_SEED, model_cfg), dev), hp)
        kw = dict(forward_fn=full_mod.posecnn_full_forward, ce_threshold=full_mod.CE_THRESHOLD) if args.full else {}
        step = trainer.make_train_step(model_cfg, hp, *consts, **kw)
        layer = GtSynthesizeLayer(data, mcfg, ims_per_batch=cfg_file.TRAIN.IMS_PER_BATCH, seed=cfg_file.RNG_SEED)
        runs = [(trainer.to_device(layer.forward(), dev),) for _ in range(args.warm + args.frames)]
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg_file.RNG_SEED)

        def run(batch):
            with record_function("stage:frame"):
                out = step(state, batch, trainer.Draws(gen))
            return out

        warmup, runs = runs[:args.warm], runs[args.warm:]
        rest = "backward and the rest"
        unit = "step"
    elif args.train and args.toy:
        from posecnn_torch.data.layer import GtSynthesizeLayer
        from posecnn_torch.data.minibatch import rescale_points

        stages = {
            "stage:preprocess": [(trainer, "preprocess")],
            "stage:trunk": [(backbone.VGGTrunk, "forward")],
            "stage:hough": [(model_mod, "hough_voting")],
            "stage:crop_pool": [(model_mod, "crop_pool_batched")],
            "stage:fc": [(layers, "fc")],
            "stage:losses": [(trainer, f) for f in ("regularization_loss", "loss_cross_entropy_hard_label_sparse",
                                                    "smooth_l1_loss_vertex_sparse", "average_distance_loss")],
            "stage:update": [(trainer.MomentumSGD, "step")],
        }
        _spans(stages, record_function)
        imdb = get_imdb("toy_train")
        imdb.append_flipped_images()
        model_cfg, hp = C.train_model_cfg(toy_cfg, imdb.num_classes), C.train_hparams(toy_cfg)
        mcfg = C.minibatch_cfg(toy_cfg, imdb.num_classes)
        ext, sym = np.asarray(imdb._extents, np.float32), np.asarray(imdb._symmetry, np.float32)
        consts = [torch.from_numpy(a).to(dev) for a in (rescale_points(imdb._points_all, ext, sym), sym, ext)]
        engine.set_float32_precision()
        state = trainer.create_train_state(
            make_model(model_cfg, init_params_numpy(toy_cfg.RNG_SEED, model_cfg), dev), hp)
        step = trainer.make_train_step(model_cfg, hp, *consts)
        layer = GtSynthesizeLayer(imdb, mcfg, ims_per_batch=toy_cfg.TRAIN.IMS_PER_BATCH, seed=toy_cfg.RNG_SEED)
        runs = [(trainer.to_device(layer.forward(), dev),) for _ in range(args.frames + 2)]
        gen = torch.Generator(device=dev)
        gen.manual_seed(toy_cfg.RNG_SEED)

        def run(batch):
            with record_function("stage:frame"):
                step(state, batch, trainer.Draws(gen))

        warmup, runs = runs[:2], runs[2:]
        rest = "backward and the rest"
        unit = "step"
    elif args.eval and args.toy:
        from posecnn_torch.data.imdb import PoseEvaluator

        stages = {
            "stage:trunk": [(backbone.VGGTrunk, "forward")],
            "stage:hough": [(model_mod, "hough_voting")],
            "stage:crop_pool": [(model_mod, "crop_pool_batched")],
            "stage:fc": [(layers, "fc")],
            "stage:host_nms": [(engine, "postprocess_detections")],
            "stage:evaluator": [(PoseEvaluator, "add_frame")],
        }
        _spans(stages, record_function)
        data = get_imdb("toy_val")
        cfg = C.test_model_cfg(toy_cfg, data.num_classes)
        model = make_model(cfg, init_params_numpy(toy_cfg.RNG_SEED, cfg), dev)
        sym = [data.classes[i] for i in range(data.num_classes) if data._symmetry[i] > 0]
        evaluator = PoseEvaluator(data.classes, data._extents, data._points, sym)

        def run(n_frames):
            with record_function("stage:frame"):
                engine.test_net(model, cfg, data, PIXEL_MEANS, evaluator=evaluator, max_frames=n_frames, log=None,
                                **C.test_settings(toy_cfg))

        warmup, runs = [(2,)], [(args.frames,)]  # a warm-up call of 2 frames, then the profiled one
        rest = "heads and the rest"
        unit = "frame"
    elif args.train:
        stages = {
            "stage:sample": [(trainer, "sample_batch")],
            "stage:preprocess": [(trainer, "preprocess")],
            "stage:trunk": [(backbone.VGGTrunk, "forward")],
            "stage:hough": [(model_mod, "hough_voting")],
            "stage:crop_pool": [(model_mod, "crop_pool_batched")],
            "stage:fc": [(layers, "fc")],
            "stage:losses": [(trainer, f) for f in ("regularization_loss", "loss_cross_entropy_hard_label_sparse",
                                                    "smooth_l1_loss_vertex_sparse", "average_distance_loss")],
            "stage:update": [(trainer.MomentumSGD, "step")],
        }
        _spans(stages, record_function)
        step, state, bank = train_entry(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(RNG_SEED)

        def run():
            with record_function("stage:frame"):
                step(state, bank, trainer.Draws(gen))

        runs = [()] * args.frames
        warmup = runs[:2]
        rest = "backward and the rest"
        unit = "step"
    elif args.eval:
        from posecnn_torch.config import FLAGSHIP_TEST, flagship_eval_cfg
        from posecnn_torch.core.convert import init_params_numpy, make_model
        from posecnn_torch.data.imdb import YCB_SYMMETRIC_EVAL, PoseEvaluator
        from posecnn_torch.data.lov_syn import LovSynVal

        stages = {
            "stage:trunk": [(backbone.VGGTrunk, "forward")],
            "stage:hough": [(model_mod, "hough_voting")],
            "stage:crop_pool": [(model_mod, "crop_pool_batched")],
            "stage:fc": [(layers, "fc")],
            "stage:host_nms": [(engine, "postprocess_detections")],
            "stage:icp": [(engine, "refine_poses")],
            "stage:evaluator": [(PoseEvaluator, "add_frame")],
        }
        _spans(stages, record_function)
        cfg = flagship_eval_cfg()
        model = make_model(cfg, init_params_numpy(0, cfg), dev)
        data = LovSynVal()
        evaluator = PoseEvaluator(data.classes, data._extents, data._points, list(YCB_SYMMETRIC_EVAL))

        def run(n_frames):
            with record_function("stage:frame"):
                engine.test_net(model, cfg, data, PIXEL_MEANS, evaluator=evaluator, max_frames=n_frames, log=None,
                                **FLAGSHIP_TEST)

        warmup, runs = [(2,)], [(args.frames,)]  # a warm-up call of 2 frames, then the profiled one
        rest = "heads and the rest"
        unit = "frame"
    else:
        stages = {
            "stage:trunk": [(backbone.VGGTrunk, "forward")],
            "stage:hough": [(model_mod, "hough_voting")],
            "stage:roi_pool": [(model_mod, "roi_pool_batched")],
            "stage:fc": [(layers, "fc")],
            "stage:host_nms": [(engine, "postprocess_detections")],
        }
        _spans(stages, record_function)
        _, (model, _, _, extents) = entry(dev)
        infer = engine.make_inference_fn(flagship_cfg(is_train=False), PIXEL_MEANS, dev)
        d = os.path.join(ROOT, "data", "lov_syn_val_v4")
        runs = []
        for name in sorted(os.listdir(d))[: args.frames]:
            with np.load(os.path.join(d, name)) as f:
                runs.append((np.ascontiguousarray(f["color"][None]), build_meta_data(f["intrinsic_matrix"])[None]))

        def run(color, meta):
            with record_function("stage:frame"):
                out = infer(model, torch.from_numpy(color).to(dev), torch.from_numpy(meta).to(dev), extents)
                return engine.postprocess_detections(out)

        warmup = runs[:2]
        rest = "heads and the rest"
        unit = "frame"

    for r in warmup:  # cuDNN plans, the kernel builds
        run(*r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        last = [run(*r) for r in runs][-1]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    avg = prof.key_averages()
    n = args.frames
    spans = {e.key: e for e in avg if e.key.startswith("stage:") and e.device_type.name == "CPU"}
    events = [e for e in avg if e.device_time_total > 0 and e.device_type.name == "CUDA" and e.key not in spans]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    total = sum(e.device_time_total for e in events)
    print(f"{'host ms/' + unit:>14} {'device ms/' + unit:>16}  stage")
    frame = spans["stage:frame"]
    rest_cpu, rest_dev = frame.cpu_time_total, total
    for name in stages:
        e = spans.get(name)
        cpu = e.cpu_time_total if e is not None else 0.0
        dv = e.device_time_total if e is not None else 0.0
        rest_cpu -= cpu
        rest_dev -= dv
        print(f"{cpu / n / 1e3:14.3f} {dv / n / 1e3:16.3f}  {name[6:]}")
    print(f"{rest_cpu / n / 1e3:14.3f} {rest_dev / n / 1e3:16.3f}  {rest}")
    print(f"{frame.cpu_time_total / n / 1e3:14.3f} {total / n / 1e3:16.3f}  {unit}")
    print(f"{torch.cuda.get_device_name(0)}; {n} {unit}s; device kernel time {total / n / 1e3:.3f} ms/{unit}; "
          f"wall {wall_us / n / 1e3:.3f} ms/{unit}; device busy {100 * total / wall_us:.1f}% of wall")
    if args.full or args.adapt:  # where the warm steps have taken the weights
        print("last step: " + " ".join(f"{k} {float(v):.6g}" for k, v in sorted(last.items())))
    print(f"{'ms/' + unit:>9} {'share':>6} {'calls/' + unit:>11}  kernel")
    for e in events[: args.top]:
        print(f"{e.device_time_total / n / 1e3:9.4f} {100 * e.device_time_total / total:5.1f}% "
              f"{e.count / n:11.1f}  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
