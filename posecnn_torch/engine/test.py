"""Inference and evaluation engine: raw frame bytes to ROIs and poses, and
the evaluation loop.

Port of `posecnn_tpu/engine/test.py:make_inference_fn`,
`postprocess_detections`, `refine_poses`, `test_net` and
`test_net_segmentation`. The device part
(mean subtraction, network, Hough voting, pose head) runs in one call with
no host round trip; host NMS then runs on the box columns 2:6 and score
column 6 (the reference read columns 0..4 of its 7-column rois, a latent
bug kept behind `reference_nms_bug`). Like the reference, the test-time
quaternion is `poses_tanh`. `refine_poses` runs the depth ICP of
`engine/refine.py` on a frame's detections in one batched pass on the
card.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.engine.refine import icp_refine_detections
from posecnn_torch.models.posecnn import posecnn_forward
from posecnn_torch.ops.nms import nms_np
from posecnn_torch.utils.meta import build_meta_data


def set_float32_precision() -> None:
    """Full float32 for f32 convolutions and products: cuDNN would otherwise
    run f32 convolutions in TF32 (the JAX package runs f32 at HIGHEST)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def make_inference_fn(model_cfg: PoseCNNConfig, pixel_means: Tuple[float, float, float], device):
    """Returns infer(model, raw_bgr_u8 (B,H,W,3), meta (B,48), extents (C,3))
    -> dict of label_2d, rois, poses_init, rois_valid, num_rois, poses_tanh
    (the outputs the JAX engine returns by default). `model` is a
    `models.posecnn.PoseCNN` on `device`."""
    cfg = replace(model_cfg, is_train=False, keep_prob=1.0)
    means = torch.tensor(pixel_means, dtype=torch.float32, device=device).reshape(1, 1, 1, 3)
    set_float32_precision()

    @torch.inference_mode()
    def infer(model, raw_bgr, meta, extents) -> Dict[str, torch.Tensor]:
        data = raw_bgr.to(torch.float32) - means
        out = posecnn_forward(model, cfg, data, extents, meta)
        keep = {"label_2d": out["label_2d"]}
        if cfg.vertex_reg:
            keep.update(
                rois=out["rois"],
                poses_init=out["poses_init"],
                rois_valid=out["rois_valid"],
                num_rois=out["num_rois"],
            )
            if cfg.pose_reg:
                keep["poses_tanh"] = out["poses_tanh"]
        return keep

    return infer


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def postprocess_detections(
    out: Dict[str, torch.Tensor],
    nms_threshold: float = 0.5,
    reference_nms_bug: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host NMS and pose combination. Returns (rois, poses) with pose rows
    (w,x,y,z,tx,ty,tz).

    reference_nms_bug: reproduce the reference, which fed the whole 7-column
    roi array to NMS and so read (batch, cls, x1, y1) as the box and x2 as
    the score."""
    rois = _np(out["rois"])
    valid = _np(out["rois_valid"]).astype(bool)
    poses_init = _np(out["poses_init"])
    rois = rois[valid]
    poses_init = poses_init[valid]
    poses_tanh = _np(out["poses_tanh"])[valid] if "poses_tanh" in out else None

    if rois.shape[0] == 0:
        return rois, poses_init

    if reference_nms_bug:
        dets = rois[:, 0:5].astype(np.float32)
    else:
        dets = np.concatenate([rois[:, 2:6], rois[:, 6:7]], axis=1).astype(np.float32)
    keep = nms_np(dets, nms_threshold)
    rois = rois[keep]
    poses = poses_init[keep].copy()
    if poses_tanh is not None:
        pt = poses_tanh[keep]
        for i in range(rois.shape[0]):
            cls = int(rois[i, 1])
            if cls >= 0:
                poses[i, :4] = pt[i, 4 * cls : 4 * cls + 4]
    return rois, poses


MAX_REFINE_DETS = 32  # the detection rows one ICP pass refines


@torch.no_grad()
def refine_poses(rois: np.ndarray, poses: np.ndarray, depth_m, label, points_all: torch.Tensor, meta,
                 max_det: int = MAX_REFINE_DETS, plane_weight: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Depth refinement of a frame's post-NMS detections
    (`engine/test.py:refine_poses`): the first `max_det` rows, padded with
    identity-quaternion rows, go through `icp_refine_detections` in one pass
    on the device of `points_all` (C,P,3). depth_m (H,W) in metres and the
    label map, numpy or tensors; meta (48,). Returns numpy (poses_new,
    poses_icp): the depth-median translation fix in poses_new's translation
    column, and the full ICP pose; rows past `max_det` keep their pose."""
    dev = points_all.device
    k = min(rois.shape[0], max_det)
    rois_p = np.zeros((max_det, rois.shape[1]), np.float32)
    poses_p = np.zeros((max_det, 7), np.float32)
    poses_p[:, 0] = 1.0  # identity quaternion in the padding rows
    rois_p[:k] = rois[:k]
    poses_p[:k] = poses[:k, :7]
    refined, trans_new = icp_refine_detections(
        torch.from_numpy(rois_p).to(dev), torch.from_numpy(poses_p).to(dev),
        torch.as_tensor(depth_m, dtype=torch.float32).to(dev), torch.as_tensor(label).to(dev), points_all,
        torch.as_tensor(meta, dtype=torch.float32).to(dev), plane_weight=float(plane_weight),
    )
    both = torch.cat([refined, trans_new], dim=1)[:k].cpu().numpy()
    poses_new = poses.copy()
    poses_new[:k, 4:7] = both[:, 7:]
    poses_icp = poses.copy()
    poses_icp[:k, :7] = both[:, :7]
    return poses_new, poses_icp


def _slice_batch(out: Dict[str, np.ndarray], b: int) -> Dict[str, np.ndarray]:
    """Image b's view of a batched inference output (host arrays): the label
    map by batch row, detection rows by their batch column, which is set to
    0 as a single-frame call gives it (the `reference_nms_bug` rule reads it
    as a box coordinate)."""
    o = {"label_2d": out["label_2d"][b:b + 1]}
    rois = out["rois"]
    sel = out["rois_valid"].astype(bool) & (rois[:, 0].astype(int) == b)
    rois = rois[sel].copy()
    rois[:, 0] = 0.0
    o["rois"] = rois
    o["rois_valid"] = np.ones(int(sel.sum()), bool)
    o["poses_init"] = out["poses_init"][sel]
    if "poses_tanh" in out:
        o["poses_tanh"] = out["poses_tanh"][sel]
    return o


def test_net(
    model,
    model_cfg: PoseCNNConfig,
    dataset,
    pixel_means,
    evaluator=None,
    max_frames: Optional[int] = None,
    nms_threshold: float = 0.5,
    log=print,
    pose_refine: bool = False,
    im_scale: float = 1.0,
    reference_nms_bug: bool = False,
    eval_batch: int = 1,
    icp_plane_weight: float = 0.0,
    timings: Optional[Dict[str, List[float]]] = None,
) -> List[Dict[str, Optional[np.ndarray]]]:
    """The evaluation loop (`engine/test.py:test_net`, PoseCNN with 2D vertex
    regression, with or without the pose head: without it a detection's
    pose is Hough's `poses_init`): `eval_batch` frames an inference call,
    host NMS, and with
    `pose_refine` the depth ICP of each frame's detections (`refine_poses`
    at `icp_plane_weight`); `evaluator.add_frame` scores each frame. Returns
    per-frame dicts of rois, poses, poses_refined and poses_icp (None
    without refinement or detections).

    `model` is a `models.posecnn.PoseCNN`; the work runs on its device.
    `timings`, when given, gets per-frame lists of milliseconds: `infer`
    (the inference call to its outputs on the host, shared by a batch's
    frames), `nms`, `icp` (wall, to its result on the host), `icp_device`
    (CUDA events around it, on a card), `evaluator` and `frame` (the sum)."""
    if im_scale != 1.0:
        raise NotImplementedError("TEST.SCALES_BASE != 1 is not ported (the JAX package resizes with cv2)")
    if model_cfg.vertex_reg_3d:
        raise NotImplementedError("test_net with 3D vertex regression (RANSAC) is not ported yet")
    if not model_cfg.vertex_reg:
        # the JAX package's postprocess_detections reads rois, which its
        # inference function returns only with the vertex head: a KeyError
        raise ValueError("test_net needs the 2D vertex head (TEST.VERTEX_REG_2D): without it the JAX "
                         "package's test_net raises KeyError 'rois'")
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"
    infer = make_inference_fn(model_cfg, pixel_means, dev)
    extents = torch.as_tensor(np.asarray(dataset._extents, np.float32), device=dev)
    points_all = torch.as_tensor(np.asarray(dataset._points_all, np.float32), device=dev)
    n = dataset.num_images if max_frames is None else min(max_frames, dataset.num_images)
    results = []
    for start in range(0, n, eval_batch):
        idxs = list(range(start, min(start + eval_batch, n)))
        frames = [dataset.load_frame(i) for i in idxs]
        t0 = time.perf_counter()
        raw = torch.from_numpy(np.stack([f.color for f in frames])).to(dev)
        meta = torch.from_numpy(np.stack([build_meta_data(f.intrinsic_matrix) for f in frames])).to(dev)
        out_dev = infer(model, raw, meta, extents)
        out_all = {k: v.cpu().numpy() for k, v in out_dev.items()}
        t_infer = (time.perf_counter() - t0) * 1e3
        for b, (i, frame) in enumerate(zip(idxs, frames)):
            t1 = time.perf_counter()
            out = _slice_batch(out_all, b) if eval_batch > 1 else out_all
            rois, poses = postprocess_detections(out, nms_threshold, reference_nms_bug)
            label_pred = out["label_2d"][0]
            t2 = time.perf_counter()
            poses_refined = poses_icp = None
            icp_dev = 0.0
            if pose_refine and frame.depth is not None and rois.shape[0]:
                depth_m = frame.depth.astype(np.float32) / float(frame.factor_depth)
                if cuda:
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    e0.record()
                poses_refined, poses_icp = refine_poses(
                    rois, poses, depth_m, out_dev["label_2d"][b], points_all,
                    build_meta_data(frame.intrinsic_matrix), plane_weight=icp_plane_weight,
                )
                if cuda:
                    e1.record()
                    e1.synchronize()
                    icp_dev = e0.elapsed_time(e1)
            t3 = time.perf_counter()
            results.append({"rois": rois, "poses": poses, "poses_refined": poses_refined, "poses_icp": poses_icp})
            if evaluator is not None:
                evaluator.add_frame(
                    label_pred, frame.label, rois=rois, poses=poses, gt_poses=frame.poses,
                    gt_cls_indexes=frame.cls_indexes, poses_refined=poses_refined, poses_icp=poses_icp,
                    intrinsic_matrix=np.asarray(frame.intrinsic_matrix, np.float64),
                )
            t4 = time.perf_counter()
            if timings is not None:
                ms = {"infer": t_infer, "nms": (t2 - t1) * 1e3, "icp": (t3 - t2) * 1e3, "icp_device": icp_dev,
                      "evaluator": (t4 - t3) * 1e3}
                ms["frame"] = ms["infer"] / len(idxs) + ms["nms"] + ms["icp"] + ms["evaluator"]
                for key, v in ms.items():
                    timings.setdefault(key, []).append(v)
            if log and (i + 1) % 50 == 0:
                log(f"frame {i + 1}/{n}")
    if evaluator is not None and log:
        log(str(evaluator.summary()))
    return results


def test_net_segmentation(
    model,
    apply_fn,
    dataset,
    pixel_means,
    evaluator=None,
    max_frames: Optional[int] = None,
    log=print,
    timings: Optional[Dict[str, List[float]]] = None,
) -> None:
    """The evaluation of the segmentation networks
    (`engine/test.py:test_net_segmentation`, FCN8VGG): each frame's colour
    image, its pixel means subtracted, through `apply_fn(model, data)` to
    its `label_2d`, scored by `evaluator.add_frame` (the IoU histogram). The
    colour image whatever input the network was trained on, as in the JAX
    package. `timings`, when given, gets per-frame lists of milliseconds:
    `infer` (to the label map on the host) and `evaluator`."""
    dev = next(model.parameters()).device
    means = torch.tensor(np.asarray(pixel_means, np.float32).reshape(-1)[:3], device=dev).reshape(1, 1, 1, 3)
    set_float32_precision()
    n = dataset.num_images if max_frames is None else min(max_frames, dataset.num_images)
    for i in range(n):
        frame = dataset.load_frame(i)
        t0 = time.perf_counter()
        with torch.inference_mode():
            data = torch.from_numpy(frame.color[None]).to(dev).to(torch.float32) - means
            label_pred = apply_fn(model, data)["label_2d"].cpu().numpy()[0]
        t1 = time.perf_counter()
        if evaluator is not None:
            evaluator.add_frame(label_pred, frame.label)
        if timings is not None:
            timings.setdefault("infer", []).append((t1 - t0) * 1e3)
            timings.setdefault("evaluator", []).append((time.perf_counter() - t1) * 1e3)
        if log and (i + 1) % 50 == 0:
            log(f"frame {i + 1}/{n}")
    if evaluator is not None and log:
        log(str(evaluator.summary()))
