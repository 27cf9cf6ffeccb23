"""Pose-branch isolation probe on the card: can the quaternion head and the
ADD loss learn rotation when detection is perfect?

Port of `tools/isolate_pose.py`. Trains PoseCNN (PoseCNNConfig's defaults
for the dataset's classes, roi pooling, Hough from the ground truth unless
--from_net_hough) with `engine.train.make_train_step` on a tiny fixed
synthetic set (`data.synthetic.SyntheticDataset(lov("train"),
split="tiny")`, the first --frames scenes) and, every --report_every steps,
measures on those same frames with GT-hough inference the median and 90th
percentile rotation error (non-symmetric classes), the mean ADD(-S) on the
raw model points (rotation only), and the median z and xy translation
errors. Rotation error that collapses says the branch works; error that
stays near the uniform-random median (~126 deg) says it does not.

`lov("train")` reads the YCB-Video tree under $POSECNN_DATA (else data/):
its models and metadata (`data/LOV/models/*/points.xyz`, the keyframe and
train lists). No such tree is in the repository; one written from the
frozen frames by `tests/torch_parity.py:write_lov_tree` serves (its models
are the stand-in hulls).

Writes <out>/report.json (config and trajectory as the JAX tool writes
them, and `timing`: the device and each step's milliseconds, CUDA events
around the step on a card); its last line gives the kernels' launches of
the run (the steps and the evaluations).

Usage: python -m posecnn_torch.tools.isolate_pose [--iters 3000] [--frames 16]
           [--report_every 500] [--batch 2] [--lr 0.001] [--margin 0.0001]
           [--out output/isolate_pose] [--from_net_hough] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

import numpy as np


def evaluate(model, eval_cfg, chunks, frames, points_all, symmetry, extents, dev, pixel_means) -> dict:
    """The JAX tool's `evaluate`: GT-hough inference on the fixed chunks;
    each valid ROI matched to the frame's first GT object of its class."""
    import torch

    from posecnn_torch.models.posecnn import posecnn_forward
    from posecnn_torch.tools.diag_rot import rotation_error_deg
    from posecnn_torch.utils.quaternion_np import quat2mat

    means = torch.tensor(np.asarray(pixel_means, np.float32).reshape(-1)[:3], device=dev).reshape(1, 1, 1, 3)
    rot, adds, z, xy = [], [], [], []
    fi = 0
    for cols, labs, gcs, metas, n_real in chunks:
        with torch.inference_mode():
            out = posecnn_forward(model, eval_cfg, cols.float() - means, extents, metas, gt_label_2d=labs,
                                  gt_centers=gcs)
            out = {k: out[k].cpu().numpy() for k in ("rois", "rois_valid", "poses_init", "poses_tanh")}
        rois, valid = out["rois"], out["rois_valid"].astype(bool)
        for b in range(n_real):
            f = frames[fi]
            gt_cls = f.cls_indexes.astype(int)
            for r in np.nonzero(valid & (rois[:, 0].astype(int) == b))[0]:
                c = int(rois[r, 1])
                hits = np.nonzero(gt_cls == c)[0]
                if not len(hits):
                    continue
                j = hits[0]
                q = out["poses_tanh"][r, 4 * c:4 * c + 4]
                R_pred = quat2mat(q / max(np.linalg.norm(q), 1e-12))
                R_gt, t_gt, t_pred = f.poses[:, :3, j], f.poses[:, 3, j], out["poses_init"][r, 4:7]
                x1, x2 = points_all[c] @ R_pred.T, points_all[c] @ R_gt.T
                if symmetry[c] > 0:
                    from scipy.spatial import cKDTree

                    d = cKDTree(x2).query(x1)[0].mean()
                else:
                    d = np.linalg.norm(x1 - x2, axis=1).mean()
                    rot.append(rotation_error_deg(q, R_gt))
                adds.append(d)
                z.append(abs(t_pred[2] - t_gt[2]))
                xy.append(np.hypot(t_pred[0] - t_gt[0], t_pred[1] - t_gt[1]))
            fi += 1
    return {
        "rot_median_deg": float(np.median(rot)) if rot else None,
        "rot_p90_deg": float(np.percentile(rot, 90)) if rot else None,
        "add_mean_m": float(np.mean(adds)) if adds else None,
        "z_median_m": float(np.median(z)) if z else None,
        "xy_median_m": float(np.median(xy)) if xy else None,
        "n_dets": len(adds),
    }


def eval_chunks(frames, max_gt: int, dev, eb: int = 4):
    """The fixed eval inputs on the device, `eb` frames a chunk (the last
    padded with its last frame): (colours, labels, gt_centers, metas, the
    chunk's real frames)."""
    import torch

    from posecnn_torch.tools.diag_rot import frame_inputs

    chunks = []
    for s in range(0, len(frames), eb):
        fs = frames[s:s + eb]
        fs = fs + [frames[-1]] * (eb - len(fs))
        parts = zip(*[frame_inputs(f, max_gt) for f in fs])
        chunks.append(tuple(torch.from_numpy(np.stack(p)).to(dev) for p in parts) + (min(eb, len(frames) - s),))
    return chunks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0], epilog=(
        "It reads the YCB-Video models through lov('train'): set POSECNN_DATA to a directory holding LOV/ "
        "(models/*/points.xyz, extents.txt, train.txt, keyframe.txt), such as the tree "
        "tests/torch_parity.py:write_lov_tree writes from the frozen frames."))
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--report_every", type=int, default=500)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--margin", type=float, default=0.0001)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="output/isolate_pose")
    ap.add_argument("--from_net_hough", action="store_true",
                    help="control arm: hough from the network's own label/vertex heads")
    args = ap.parse_args(argv)

    import torch

    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.data.layer import GtSynthesizeLayer, prefetch
    from posecnn_torch.data.lov import lov
    from posecnn_torch.data.minibatch import MinibatchConfig, rescale_points
    from posecnn_torch.data.synthetic import SyntheticDataset
    from posecnn_torch.engine import train as T
    from posecnn_torch.engine.test import set_float32_precision
    from posecnn_torch.ops import conv3x3, nms, voting

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("isolate_pose: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    set_float32_precision()
    dataset = SyntheticDataset(lov("train"), split="tiny", num_images=args.frames)
    C = dataset.num_classes
    extents = np.asarray(dataset._extents, np.float32)
    symmetry = np.asarray(dataset._symmetry, np.float32)
    points_all = np.asarray(dataset._points_all, np.float32)
    loss_points = rescale_points(points_all, extents, symmetry)

    model_cfg = PoseCNNConfig(num_classes=C, is_train=True, vertex_reg=True, pose_reg=True,
                              hough_from_gt=not args.from_net_hough)
    hp = T.TrainHParams(learning_rate=args.lr, momentum=0.9, gamma=0.1, stepsize=10 ** 9, weight_reg=0.0001,
                        vertex_w=5.0, pose_w=1.0, margin=args.margin, pose_norm_valid=True, clip_grad_norm=10.0)
    mcfg = MinibatchConfig(num_classes=C, chromatic=False, add_noise=False, vertex_reg=True, device_targets=True)
    layer = GtSynthesizeLayer(dataset, mcfg, ims_per_batch=args.batch, seed=3)
    ext_d = torch.from_numpy(extents).to(dev)
    step_fn = T.make_train_step(model_cfg, hp, torch.from_numpy(loss_points).to(dev),
                                torch.from_numpy(symmetry).to(dev), ext_d)
    state = T.create_train_state(make_model(model_cfg, init_params_numpy(3, model_cfg), dev), hp)

    # GT-hough eval on the training frames themselves: an overfit probe
    eval_cfg = replace(model_cfg, is_train=False, keep_prob=1.0, hough_from_gt=True)
    frames = [dataset.load_frame(i) for i in range(args.frames)]
    chunks = eval_chunks(frames, mcfg.max_gt, dev)

    def report(it: int) -> dict:
        m = evaluate(state.model, eval_cfg, chunks, frames, points_all, symmetry, ext_d, dev, mcfg.pixel_means)
        m["iter"] = it
        return m

    os.makedirs(args.out, exist_ok=True)
    voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = nms.NMS_LAUNCHES = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    data_iter = prefetch(iter(layer), depth=2)
    trajectory, step_ms = [], []
    t0 = time.time()
    try:
        m0 = report(0)
        trajectory.append(m0)
        print(f"iter 0: {m0}", flush=True)
        for it in range(1, args.iters + 1):
            batch = T.to_device(next(data_iter), dev)
            t_step = time.perf_counter()
            if cuda:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
            metrics = step_fn(state, batch, T.Draws(gen))
            if cuda:
                e1.record()
                e1.synchronize()
                step_ms.append(e0.elapsed_time(e1))
            else:
                step_ms.append((time.perf_counter() - t_step) * 1e3)
            if it % 100 == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"iter {it}: loss {m['loss']:.4f} pose {m.get('loss_pose', 0):.4f} cls {m.get('loss_cls', 0):.4f} "
                      f"vert {m.get('loss_vertex', 0):.4f} ({time.time() - t0:.1f}s)", flush=True)
            if it % args.report_every == 0:
                m = report(it)
                m["loss_pose"] = float(metrics["loss_pose"])
                trajectory.append(m)
                print(f"eval @ {it}: {m}", flush=True)
    finally:
        close = getattr(data_iter, "close", None)
        if close is not None:
            close()
    out = {
        "config": {"iters": args.iters, "frames": args.frames, "batch": args.batch, "lr": args.lr,
                   "margin": args.margin, "hough_from_gt": not args.from_net_hough},
        "trajectory": trajectory,
        "timing": {"device": torch.cuda.get_device_name(dev) if cuda else "cpu", "step_ms": step_ms},
    }
    with open(os.path.join(args.out, "report.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    if step_ms:
        print(f"{len(step_ms)} steps, median {float(np.median(step_ms[1:] or step_ms)):.3f} ms a step "
              f"({'CUDA events' if cuda else 'wall'}, after the first)", flush=True)
    print(f"wrote {args.out}/report.json; launches hough_vote {voting.VOTE_LAUNCHES} conv3x3 "
          f"{conv3x3.CONV3X3_LAUNCHES} nms {nms.NMS_LAUNCHES}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
