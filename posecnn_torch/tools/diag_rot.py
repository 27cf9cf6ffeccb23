"""Rotation-error decomposition of a PoseCNN snapshot, on the card.

Port of `tools/diag_rot.py`. Runs the snapshot over the same frames twice,
once with `hough_from_gt` (the pose branch sees ROIs and centres voted from
the ground-truth labels and vertex targets) and once on the network's own
labels and vertex field, and reports for each arm the median and 90th
percentile rotation error over the non-symmetric classes, and the median z
and xy translation errors of `poses_init`, matching each valid ROI to the
first GT object of its class. A pose head that has not learned shows a high
GT-arm error; ROIs the head has not seen show a low GT-arm error and a high
predicted-arm one.

The model is PoseCNN at PoseCNNConfig's defaults for the dataset's classes
(the JAX tool's), its parameters read from the snapshot (npz of either
package; every parameter must be there). The report is written as JSON to
--out with the JAX tool's keys (model, imdb, frames, gt_hough, pred_hough)
and printed; then a line with each arm's kernel launches (hough_vote,
conv3x3, nms) as JSON, and its seconds.

Usage: python -m posecnn_torch.tools.diag_rot --model SNAPSHOT.npz [--frames 16]
           [--imdb lov_syn_val] [--out output/diag_rot.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

import numpy as np


def frame_inputs(f, max_gt: int):
    """(colour, label, gt_centers (max_gt, 4), meta) of a frame, as the JAX
    tool builds them: each GT object's class, centre and depth."""
    from posecnn_torch.utils.meta import build_meta_data

    g = np.zeros((max_gt, 4), np.float32)
    k = len(f.cls_indexes)
    g[:k, 0] = f.cls_indexes
    g[:k, 1:3] = f.center[:k]
    g[:k, 3] = f.poses[2, 3, :k]
    return f.color, f.label.astype(np.int32), g, build_meta_data(f.intrinsic_matrix)


def rotation_error_deg(q: np.ndarray, R_gt: np.ndarray) -> float:
    """The angle of R(q) R_gt^T in degrees (q normalised first)."""
    from posecnn_torch.utils.quaternion_np import quat2mat

    R = quat2mat(q / max(np.linalg.norm(q), 1e-12))
    return float(np.degrees(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1))))


def frame_errors(out: dict, f, symmetry: np.ndarray, rot: list, z: list, xy: list) -> None:
    """Append one frame's errors: for each valid ROI whose class is among
    the frame's GT objects, the rotation error of its class's `poses_tanh`
    quaternion (non-symmetric classes), and the z and xy errors of its
    `poses_init` translation."""
    rois = out["rois"]
    valid = out["rois_valid"].astype(bool)
    gt_cls = f.cls_indexes.astype(int)
    for r in np.nonzero(valid)[0]:
        c = int(rois[r, 1])
        hits = np.nonzero(gt_cls == c)[0]
        if not len(hits):
            continue
        j = hits[0]
        t_gt, t_pred = f.poses[:, 3, j], out["poses_init"][r, 4:7]
        if symmetry[c] == 0:
            rot.append(rotation_error_deg(out["poses_tanh"][r, 4 * c:4 * c + 4], f.poses[:, :3, j]))
        z.append(abs(float(t_pred[2] - t_gt[2])))
        xy.append(float(np.hypot(t_pred[0] - t_gt[0], t_pred[1] - t_gt[1])))


def summarize(rot: list, z: list, xy: list) -> dict:
    """The JAX tool's arm summary."""
    return {
        "rot_median_deg": float(np.median(rot)) if rot else None,
        "rot_p90_deg": float(np.percentile(rot, 90)) if rot else None,
        "z_median_m": float(np.median(z)) if z else None,
        "xy_median_m": float(np.median(xy)) if xy else None,
        "n_rot": len(rot),
    }


def make_infer(model, cfg, pixel_means, extents, dev):
    """infer(colour, meta, label, gt_centers) of one frame (numpy) -> the
    host outputs rois, rois_valid, poses_init and poses_tanh."""
    import torch

    from posecnn_torch.models.posecnn import posecnn_forward

    means = torch.tensor(np.asarray(pixel_means, np.float32).reshape(-1)[:3], device=dev).reshape(1, 1, 1, 3)

    @torch.inference_mode()
    def infer(col, meta, lab, gc):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)[None]).to(dev)  # noqa: E731
        out = posecnn_forward(model, cfg, t(col).float() - means, extents, t(meta), gt_label_2d=t(lab),
                              gt_centers=t(gc))
        return {k: out[k].cpu().numpy() for k in ("rois", "rois_valid", "poses_init", "poses_tanh")}

    return infer


def run_arm(model, cfg, frames, symmetry, extents, dev, gt_hough: bool, pixel_means, max_gt: int) -> dict:
    infer = make_infer(model, replace(cfg, hough_from_gt=gt_hough), pixel_means, extents, dev)
    rot, z, xy = [], [], []
    for f in frames:
        col, lab, gc, meta = frame_inputs(f, max_gt)
        frame_errors(infer(col, meta, lab, gc), f, symmetry, rot, z, xy)
    return summarize(rot, z, xy)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, help="an npz snapshot of either package")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--imdb", default="lov_syn_val")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="output/diag_rot.json")
    args = ap.parse_args(argv)

    import torch

    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.checkpoint import restore_params
    from posecnn_torch.core.convert import make_model, param_shapes
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.data.minibatch import MinibatchConfig
    from posecnn_torch.engine.test import set_float32_precision
    from posecnn_torch.ops import conv3x3, nms, voting

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("diag_rot: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    set_float32_precision()
    dataset = get_imdb(args.imdb)
    C = dataset.num_classes
    symmetry = np.asarray(dataset._symmetry, np.float32)
    extents = torch.from_numpy(np.asarray(dataset._extents, np.float32)).to(dev)
    mcfg = MinibatchConfig(num_classes=C)
    cfg = PoseCNNConfig(num_classes=C, is_train=False, keep_prob=1.0, vertex_reg=True, pose_reg=True)
    model = make_model(cfg, restore_params(args.model, param_shapes(cfg)), dev)
    n = min(args.frames, dataset.num_images)
    frames = [dataset.load_frame(i) for i in range(n)]
    arms, launches, seconds = {}, {}, {}
    for name, gt in (("gt_hough", True), ("pred_hough", False)):
        voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = nms.NMS_LAUNCHES = 0
        t0 = time.perf_counter()
        arms[name] = run_arm(model, cfg, frames, symmetry, extents, dev, gt, mcfg.pixel_means, mcfg.max_gt)
        seconds[name] = time.perf_counter() - t0
        launches[name] = {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES,
                          "nms": nms.NMS_LAUNCHES}
    report = {"model": args.model, "imdb": args.imdb, "frames": n, "gt_hough": arms["gt_hough"],
              "pred_hough": arms["pred_hough"]}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report, indent=1))
    print(f"launches {json.dumps(launches)}; seconds {({k: round(v, 3) for k, v in seconds.items()})} on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
