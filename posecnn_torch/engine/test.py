"""Inference and evaluation engine: raw frame bytes to ROIs and poses, and
the evaluation loop.

Port of `posecnn_tpu/engine/test.py:make_inference_fn`,
`postprocess_detections`, `refine_poses`, `decode_poses_3d`, `test_net`,
`test_net_segmentation`, the video model's `test_net_video` (with the
KinectFusion hooks) and the detection network's evaluation
(`gt_boxes_from_poses`, `DetectionEvaluator`, `make_det_inference_fn`,
`postprocess_det`, `test_net_detection`). The device part
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
from posecnn_torch.data.minibatch import pad_im
from posecnn_torch.engine.refine import icp_refine_detections
from posecnn_torch.models.posecnn import posecnn_forward
from posecnn_torch.ops.nms import nms_np
from posecnn_torch.utils.debug_nans import jitted
from posecnn_torch.utils.meta import build_meta_data
from posecnn_torch.utils.resize import INTER_LINEAR, INTER_NEAREST, resize


def set_float32_precision() -> None:
    """Full float32 for f32 convolutions and products: cuDNN would otherwise
    run f32 convolutions in TF32 (the JAX package runs f32 at HIGHEST)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def make_inference_fn(model_cfg: PoseCNNConfig, pixel_means: Tuple[float, float, float], device, forward_fn=None):
    """Returns infer(model, raw_bgr_u8 (B,H,W,3), meta (B,48), extents (C,3))
    -> dict of label_2d, rois, poses_init, rois_valid, num_rois, poses_tanh
    (the outputs the JAX engine returns by default); with 3D vertex
    regression label_2d and vertex_pred, which the RANSAC decode reads.
    `model` is a `models.posecnn.PoseCNN` on `device`, or the model of
    `forward_fn` (`posecnn_full.posecnn_full_forward` and `PoseCNNFull` for
    VGG16FULL, whose pose branch crop-pools at inference too)."""
    cfg = replace(model_cfg, is_train=False, keep_prob=1.0)
    means = torch.tensor(pixel_means, dtype=torch.float32, device=device).reshape(1, 1, 1, 3)
    forward = posecnn_forward if forward_fn is None else forward_fn
    set_float32_precision()

    @torch.inference_mode()
    def infer(model, raw_bgr, meta, extents) -> Dict[str, torch.Tensor]:
        data = raw_bgr.to(torch.float32) - means
        out = forward(model, cfg, data, extents, meta)
        keep = {"label_2d": out["label_2d"]}
        if cfg.vertex_reg_3d:
            keep["vertex_pred"] = out["vertex_pred"]
        elif cfg.vertex_reg:
            keep.update(
                rois=out["rois"],
                poses_init=out["poses_init"],
                rois_valid=out["rois_valid"],
                num_rois=out["num_rois"],
            )
            if cfg.pose_reg:
                keep["poses_tanh"] = out["poses_tanh"]
        return keep

    return jitted(infer, "the inference function")


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


# JAX jits the ICP (`test.py:_refine_jit`): checked at its outputs under DEBUG_NANS
refine_poses = jitted(refine_poses, "the ICP")


def decode_poses_3d(
    out: Dict,
    depth_m: np.ndarray,
    meta: np.ndarray,
    extents,
    num_classes: int,
    label_threshold: int = 500,
    seed: int = 0,
    draws=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """VERTEX_REG_3D pose decoding (`engine/test.py:decode_poses_3d`
    :190-232): each class with at least `label_threshold` predicted pixels
    gets a Kabsch-RANSAC pose between its predicted (unscaled) object
    coordinates and the back-projected depth points, all such classes in
    one batched pass on the device of `out["vertex_pred"]` (1,H,W,3C);
    out["label_2d"] (1,H,W) on the host. A class with no inliers (no depth
    under it) is skipped. The triplets come from `draws`, by default a
    generator seeded with `seed` on that device (JAX: PRNGKey(seed), split
    per class). Returns numpy (rois (N,7) [0, cls, x1, y1, x2, y2,
    inliers], poses (N,7) [quat wxyz, t])."""
    from posecnn_torch.engine.ransac import ransac_from_maps
    from posecnn_torch.engine.train import Draws

    label = np.asarray(out["label_2d"][0])
    vp = out["vertex_pred"][0]
    dev = vp.device
    fx, px, fy, py = float(meta[0]), float(meta[2]), float(meta[4]), float(meta[5])
    counts = np.bincount(label.reshape(-1).clip(0), minlength=num_classes)
    classes = [c for c in range(1, num_classes) if counts[c] >= label_threshold]
    if not classes:
        return np.zeros((0, 7), np.float32), np.zeros((0, 7), np.float32)
    if draws is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        draws = Draws(gen)
    q, t, n_inl = ransac_from_maps(
        draws, vp, torch.as_tensor(label).to(dev), torch.as_tensor(depth_m, dtype=torch.float32).to(dev),
        torch.tensor(classes, device=dev), torch.as_tensor(extents, dtype=torch.float32).to(dev), fx, fy, px, py,
    )
    q, t, n_inl = q.cpu().numpy(), t.cpu().numpy(), n_inl.cpu().numpy()
    rois, poses = [], []
    for r, c in enumerate(classes):
        if n_inl[r] <= 0:
            continue
        ys, xs = np.nonzero(label == c)
        rois.append([0, c, xs.min(), ys.min(), xs.max(), ys.max(), float(n_inl[r])])
        poses.append(np.concatenate([q[r], t[r]]))
    if not rois:
        return np.zeros((0, 7), np.float32), np.zeros((0, 7), np.float32)
    return np.asarray(rois, np.float32), np.asarray(poses, np.float32)


# JAX jits RANSAC (`test.py:_ransac3d_jit`)
decode_poses_3d = jitted(decode_poses_3d, "RANSAC")


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
    forward_fn=None,
    visualizer=None,
) -> List[Dict[str, Optional[np.ndarray]]]:
    """The evaluation loop (`engine/test.py:test_net`, PoseCNN with 2D vertex
    regression, with or without the pose head: without it a detection's
    pose is Hough's `poses_init`; with 3D vertex regression the RANSAC
    decode of `decode_poses_3d`, one detection a class, in place of host
    NMS): `eval_batch` frames an inference call,
    host NMS, and with
    `pose_refine` the depth ICP of each frame's detections (`refine_poses`
    at `icp_plane_weight`); `evaluator.add_frame` scores each frame. Returns
    per-frame dicts of rois, poses, poses_refined and poses_icp (None
    without refinement or detections).

    `model` is a `models.posecnn.PoseCNN`, or the model of `forward_fn`
    (`make_inference_fn`'s; VGG16FULL); the work runs on its device.
    `timings`, when given, gets per-frame lists of milliseconds: `infer`
    (the inference call to its outputs on the host, shared by a batch's
    frames), `nms`, `icp` (wall, to its result on the host), `icp_device`
    (CUDA events around it, on a card), `evaluator` and `frame` (the sum);
    with 3D vertex regression `ransac` (wall) and `ransac_device` (CUDA
    events, on a card) in place of `nms`; with a `visualizer`, `vis`.

    `visualizer` (TEST.VISUALIZE: `engine.visualize.PredictionVisualizer`)
    is called after each frame's evaluation with (frame index, frame, the
    inference output's label map as {"label_2d": (1, H, W)}, rois, the ICP
    poses when there are any, else the poses), as the JAX loop calls it."""
    if not model_cfg.vertex_reg:
        # the JAX package's postprocess_detections reads rois, which its
        # inference function returns only with the vertex head: a KeyError
        raise ValueError("test_net needs the 2D vertex head (TEST.VERTEX_REG_2D): without it the JAX "
                         "package's test_net raises KeyError 'rois'")
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"
    infer = make_inference_fn(model_cfg, pixel_means, dev, forward_fn)
    extents = torch.as_tensor(np.asarray(dataset._extents, np.float32), device=dev)
    points_all = torch.as_tensor(np.asarray(dataset._points_all, np.float32), device=dev)
    n = dataset.num_images if max_frames is None else min(max_frames, dataset.num_images)
    results = []
    for start in range(0, n, eval_batch):
        idxs = list(range(start, min(start + eval_batch, n)))
        frames = [dataset.load_frame(i) for i in idxs]
        t0 = time.perf_counter()
        colors = [f.color if im_scale == 1.0 else pad_im(resize(f.color, None, im_scale, im_scale, INTER_LINEAR), 16)
                  for f in frames]
        raw = torch.from_numpy(np.stack(colors)).to(dev)
        meta = torch.from_numpy(np.stack([build_meta_data(f.intrinsic_matrix, im_scale) for f in frames])).to(dev)
        out_dev = infer(model, raw, meta, extents)
        # the 3D object-coordinate map stays on the device for RANSAC
        out_all = {k: v.cpu().numpy() for k, v in out_dev.items() if k != "vertex_pred"}
        t_infer = (time.perf_counter() - t0) * 1e3
        for b, (i, frame) in enumerate(zip(idxs, frames)):
            t1 = time.perf_counter()
            decode_dev = 0.0
            H0, W0 = frame.color.shape[:2]
            # the scaled frame's size, before its padding
            hs, ws = int(np.rint(H0 * im_scale)), int(np.rint(W0 * im_scale))
            if model_cfg.vertex_reg_3d:
                out = {"label_2d": out_all["label_2d"][b:b + 1]}
                vertex_pred = out_dev["vertex_pred"][b:b + 1]
                if im_scale != 1.0:
                    out = {"label_2d": resize(out["label_2d"][0, :hs, :ws].astype(np.int32), (W0, H0),
                                              interpolation=INTER_NEAREST)[None]}
                    vp = resize(vertex_pred[0, :hs, :ws].float().cpu().numpy(), (W0, H0), interpolation=INTER_LINEAR)
                    vertex_pred = torch.from_numpy(vp[None]).to(dev)
                depth3d = (frame.depth.astype(np.float32) / float(frame.factor_depth) if frame.depth is not None
                           else np.zeros(frame.label.shape, np.float32))
                if cuda:
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    e0.record()
                rois, poses = decode_poses_3d(
                    {"label_2d": out["label_2d"], "vertex_pred": vertex_pred}, depth3d,
                    build_meta_data(frame.intrinsic_matrix), extents, model_cfg.num_classes,
                    label_threshold=model_cfg.label_threshold, seed=i,
                )
                if cuda:
                    e1.record()
                    e1.synchronize()
                    decode_dev = e0.elapsed_time(e1)
            else:
                out = _slice_batch(out_all, b) if eval_batch > 1 else out_all
                rois, poses = postprocess_detections(out, nms_threshold, reference_nms_bug)
            label_pred = out["label_2d"][0]
            label_icp = out_dev["label_2d"][b]
            if im_scale != 1.0:
                if not model_cfg.vertex_reg_3d:
                    label_pred = resize(label_pred[:hs, :ws].astype(np.int32), (W0, H0), interpolation=INTER_NEAREST)
                    if rois.shape[0]:
                        rois = rois.copy()
                        rois[:, 2:6] /= im_scale
                label_icp = label_pred
            t2 = time.perf_counter()
            poses_refined = poses_icp = None
            icp_dev = 0.0
            if pose_refine and frame.depth is not None and rois.shape[0]:
                depth_m = frame.depth.astype(np.float32) / float(frame.factor_depth)
                if cuda:
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    e0.record()
                poses_refined, poses_icp = refine_poses(
                    rois, poses, depth_m, label_icp, points_all,
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
            if visualizer is not None:
                visualizer(i, frame, {"label_2d": out_all["label_2d"][b:b + 1]}, rois,
                           poses_icp if poses_icp is not None else poses)
            t5 = time.perf_counter()
            if timings is not None:
                decode = "ransac" if model_cfg.vertex_reg_3d else "nms"
                ms = {"infer": t_infer, decode: (t2 - t1) * 1e3, "icp": (t3 - t2) * 1e3, "icp_device": icp_dev,
                      "evaluator": (t4 - t3) * 1e3}
                if model_cfg.vertex_reg_3d:
                    ms["ransac_device"] = decode_dev
                if visualizer is not None:
                    ms["vis"] = (t5 - t4) * 1e3
                ms["frame"] = ms["infer"] / len(idxs) + ms[decode] + ms["icp"] + ms["evaluator"] + ms.get("vis", 0.0)
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
    forward = jitted(apply_fn, "the segmentation forward")
    for i in range(n):
        frame = dataset.load_frame(i)
        t0 = time.perf_counter()
        with torch.inference_mode():
            data = torch.from_numpy(frame.color[None]).to(dev).to(torch.float32) - means
            label_pred = forward(model, data)["label_2d"].cpu().numpy()[0]
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


# --------------------------------------------------------------- detection path


def test_net_video(model, video_cfg, dataset, pixel_means, num_steps: int = 5, evaluator=None,
                   max_videos: Optional[int] = None, kfusion: bool = False, kfusion_grid: int = 128, log=print,
                   timings: Optional[Dict[str, List[float]]] = None):
    """The video model's evaluation (`test.py:test_net_video` :428-505): per
    video of `dataset` ('<seq>/<frame>' indices, `data.video_layer.
    group_by_video`, sorted, the first `max_videos`), the recurrent state
    starts afresh and the frames go through `video_step` one at a time
    (raw BGR less the pixel means, depth in metres, K in meta_data, no
    camera motion) on the model's device; the evaluator scores each label
    map. With `kfusion` each video also runs the TSDF pipeline at grid
    `kfusion_grid` (`engine.kfusion.KinectFusion` with the model's classes:
    feed_data, solve_pose from the second frame, feed_label of the class
    probabilities exp(prob), fuse_depth) and `evaluator.surfaces` gets each
    video's extract_surface (points, labels). `num_steps` is not read, as
    in JAX. `timings`, when given, gets each frame's milliseconds of its
    reading (`load`), the network step (`video_step`) and the fusion
    (`kfusion`), the card synchronized after the last two. Returns the
    evaluator."""
    from posecnn_torch.data.video_layer import group_by_video
    from posecnn_torch.engine.kfusion import KinectFusion
    from posecnn_torch.models.video import init_video_state, video_step

    dev = next(model.parameters()).device
    means = np.asarray(pixel_means, np.float32).reshape(1, 1, 1, 3)
    step = jitted(video_step, "the video step")  # JAX jits it (test.py:453)
    videos = group_by_video(dataset.image_index)
    names = sorted(videos)[:max_videos] if max_videos is not None else sorted(videos)

    def sync_ms(t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    surfaces = []
    with torch.no_grad():
        for vi, name in enumerate(names):
            state = None
            kf = None
            if kfusion:
                kf = KinectFusion(grid_size=kfusion_grid, num_classes=video_cfg.num_classes, device=dev)
            for j, idx in enumerate(videos[name]):
                t0 = time.perf_counter()
                frame = dataset.load_frame(idx)
                data = torch.from_numpy(frame.color[None].astype(np.float32) - means).to(dev)
                if state is None:
                    state = init_video_state(1, data.shape[1], data.shape[2], video_cfg.num_units, device=dev)
                depth_np = (frame.depth.astype(np.float32) / frame.factor_depth if frame.depth is not None
                            else np.zeros(frame.label.shape, np.float32))
                if timings is not None:
                    timings.setdefault("load", []).append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                out, state = step(model, video_cfg, data, torch.from_numpy(depth_np[None]).to(dev),
                                        torch.from_numpy(build_meta_data(frame.intrinsic_matrix)[None]).to(dev), state)
                label_pred = out["label_2d"][0].cpu().numpy()
                if timings is not None:
                    timings.setdefault("video_step", []).append(sync_ms(t0))
                if kf is not None:
                    t0 = time.perf_counter()
                    kf.feed_data(depth_np, frame.intrinsic_matrix)
                    if j > 0:
                        kf.solve_pose()
                    kf.feed_label(torch.exp(out["prob"][0]))  # log-softmax -> class probabilities
                    kf.fuse_depth()
                    if timings is not None:
                        timings.setdefault("kfusion", []).append(sync_ms(t0))
                if evaluator is not None:
                    evaluator.add_frame(label_pred, frame.label)
            if kf is not None:
                surfaces.append(kf.extract_surface())
            if log:
                log(f"video {vi + 1}/{len(names)} ({name}): {len(videos[name])} frames")
    if evaluator is not None:
        evaluator.surfaces = surfaces
        if log:
            log(str(evaluator.summary()))
    return evaluator


def project_box_corners(extent: np.ndarray, quat: np.ndarray, trans: np.ndarray, K: np.ndarray) -> np.ndarray:
    """The 8 projected 2D corners (pixels) of the model-frame bounding box
    under pose (quat, trans): the port's copy of
    `posecnn_tpu/engine/visualize.py:project_box_corners` (:36), whose
    module needs cv2."""
    from posecnn_torch.utils.quaternion_np import quat2mat

    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float64)
    corners = signs * (np.asarray(extent, np.float64) / 2.0)  # (8,3)
    R = quat2mat(np.asarray(quat, np.float64))
    cam = corners @ R.T + np.asarray(trans, np.float64)
    uv = cam @ np.asarray(K, np.float64).T
    return uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)


def gt_boxes_from_poses(frame, extents) -> np.ndarray:
    """The frame's GT boxes (M,5) [cls, x1, y1, x2, y2]: each GT object's 3D
    extent box projected through its pose and clipped to the image
    (`engine/test.py:gt_boxes_from_poses` :511); objects behind the camera
    or with an empty box are left out."""
    from posecnn_torch.utils.quaternion_np import mat2quat

    H, W = frame.label.shape[:2]
    K = np.asarray(frame.intrinsic_matrix, np.float64)
    rows = []
    for j, c in enumerate(np.asarray(frame.cls_indexes).astype(int)):
        R, t = frame.poses[:, :3, j], frame.poses[:, 3, j]
        if t[2] <= 0:
            continue
        uv = project_box_corners(np.asarray(extents)[c], mat2quat(R), t, K)
        x1, y1 = uv.min(axis=0)
        x2, y2 = uv.max(axis=0)
        x1, x2 = np.clip([x1, x2], 0, W - 1)
        y1, y2 = np.clip([y1, y2], 0, H - 1)
        if x2 > x1 and y2 > y1:
            rows.append([c, x1, y1, x2, y2])
    return np.asarray(rows, np.float32).reshape(-1, 5)


class DetectionEvaluator:
    """VOC AP@0.5 over GT boxes (`engine/test.py:DetectionEvaluator` :537):
    each frame's detections, by score, match greedily the unused GT box of
    their class with the highest IoU >= 0.5; AP is the 11-point VOC
    average. GT boxes come from `gt_boxes` rows [cls, x1, y1, x2, y2], or
    from the label map's per-class extents (classes with > 10 pixels)."""

    def __init__(self, classes):
        self.classes = list(classes)
        self.records = {c: [] for c in range(1, len(self.classes))}
        self.n_gt = {c: 0 for c in range(1, len(self.classes))}

    @staticmethod
    def _gt_boxes_from_label(label, num_classes):
        rows = []
        for c in range(1, num_classes):
            ys, xs = np.nonzero(label == c)
            if len(xs) > 10:
                rows.append([c, xs.min(), ys.min(), xs.max(), ys.max()])
        return np.asarray(rows, np.float32).reshape(-1, 5)

    @staticmethod
    def _iou(bb, gb):
        ix = max(0.0, min(bb[2], gb[2]) - max(bb[0], gb[0]) + 1)
        iy = max(0.0, min(bb[3], gb[3]) - max(bb[1], gb[1]) + 1)
        inter = ix * iy
        union = (bb[2] - bb[0] + 1) * (bb[3] - bb[1] + 1) + (gb[2] - gb[0] + 1) * (gb[3] - gb[1] + 1) - inter
        return inter / max(union, 1e-9)

    def add_frame(self, detections, gt_label=None, gt_boxes=None):
        """detections (N,10) rows [cls, x1, y1, x2, y2, score, quat4];
        gt_boxes (M,5) rows [cls, x1, y1, x2, y2]."""
        if gt_boxes is None:
            if gt_label is None:
                raise ValueError("DetectionEvaluator.add_frame needs gt_boxes or gt_label")
            gt_boxes = self._gt_boxes_from_label(gt_label, len(self.classes))
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 5)
        for row in gt_boxes:
            c = int(row[0])
            if c in self.n_gt:
                self.n_gt[c] += 1
        used = set()
        order = np.argsort(-detections[:, 5]) if len(detections) else []
        for i in order:
            c = int(detections[i, 0])
            if c not in self.records:
                continue
            bb = detections[i, 1:5]
            best, best_j = 0.5, -1  # the VOC IoU threshold
            for j, row in enumerate(gt_boxes):
                if int(row[0]) != c or j in used:
                    continue
                iou = self._iou(bb, row[1:5])
                if iou >= best:
                    best, best_j = iou, j
            if best_j >= 0:
                used.add(best_j)
            self.records[c].append((float(detections[i, 5]), best_j >= 0))

    def summary(self):
        aps = {}
        for c, recs in self.records.items():
            n_gt = self.n_gt[c]
            if n_gt == 0:
                continue
            recs = sorted(recs, key=lambda r: -r[0])
            tp = np.cumsum([r[1] for r in recs]) if recs else np.zeros(0)
            fp = np.cumsum([not r[1] for r in recs]) if recs else np.zeros(0)
            recall = tp / n_gt if len(tp) else np.zeros(0)
            precision = tp / np.maximum(tp + fp, 1e-9) if len(tp) else np.zeros(0)
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                p = precision[recall >= t].max() if np.any(recall >= t) else 0.0
                ap += p / 11
            aps[self.classes[c]] = float(ap)
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        return {"ap_per_class": aps, "mAP@0.5": mean_ap}


def make_det_inference_fn(det_cfg, pixel_means, device):
    """Returns infer(model, raw_bgr_u8 (1,H,W,3)) -> dict of rois, cls_prob,
    bbox_pred and poses_tanh (`engine/test.py:make_det_inference_fn` :624).
    `model` is a `models.detection.VGG16Det` on `device`."""
    from posecnn_torch.models.detection import vgg16_det_forward

    cfg = replace(det_cfg, is_train=False, keep_prob=1.0)
    means = torch.tensor(np.asarray(pixel_means, np.float32).reshape(-1)[:3], device=device).reshape(1, 1, 1, 3)
    set_float32_precision()

    @torch.inference_mode()
    def infer(model, raw_bgr) -> Dict[str, torch.Tensor]:
        out = vgg16_det_forward(model, cfg, raw_bgr.to(torch.float32) - means)
        return {k: out[k] for k in ("rois", "cls_prob", "bbox_pred", "poses_tanh")}

    return jitted(infer, "the detection inference function")


def postprocess_det(out, num_classes: int, im_shape, nms_threshold: float = 0.3, score_threshold: float = 0.05,
                    bbox_reg: bool = True) -> np.ndarray:
    """RCNN outputs (host arrays) to detections (`engine/test.py:
    postprocess_det` :645): each roi's class boxes decoded and clipped, then
    for each class the rows scoring above `score_threshold` through host NMS
    at `nms_threshold`. Returns (N,10) rows [cls, x1, y1, x2, y2, score,
    quaternion wxyz normalized]."""
    from posecnn_torch.ops.bbox import bbox_transform_inv, clip_boxes

    rois = np.asarray(out["rois"])
    cls_prob = np.asarray(out["cls_prob"])
    boxes = rois[:, 1:5]
    if bbox_reg:
        boxes_all = clip_boxes(bbox_transform_inv(boxes, np.asarray(out["bbox_pred"])), im_shape)
    else:
        boxes_all = np.tile(boxes, (1, num_classes))
    poses_tanh = np.asarray(out["poses_tanh"])
    dets = []
    for c in range(1, num_classes):
        scores = cls_prob[:, c]
        keep = scores > score_threshold
        if not np.any(keep):
            continue
        cls_boxes = boxes_all[keep, 4 * c:4 * c + 4]
        cls_scores = scores[keep]
        quats = poses_tanh[keep, 4 * c:4 * c + 4]
        quats = quats / np.maximum(np.linalg.norm(quats, axis=1, keepdims=True), 1e-12)
        d5 = np.concatenate([cls_boxes, cls_scores[:, None]], axis=1).astype(np.float32)
        for i in nms_np(d5, nms_threshold):
            dets.append(np.concatenate([[c], cls_boxes[i], [cls_scores[i]], quats[i]]).astype(np.float32))
    return np.asarray(dets, np.float32).reshape(-1, 10)


def test_net_detection(model, det_cfg, dataset, pixel_means, evaluator=None, max_frames: Optional[int] = None,
                       nms_threshold: float = 0.3, log=print,
                       timings: Optional[Dict[str, List[float]]] = None) -> List[np.ndarray]:
    """The detection network's evaluation (`engine/test.py:test_net_detection`
    :688): each frame's colour image through `make_det_inference_fn`, then
    `postprocess_det` at `nms_threshold`; `evaluator.add_frame` scores it
    against `gt_boxes_from_poses` (the label map's extents for a frame
    without poses). Returns each frame's (N,10) detections. `timings`, when
    given, gets per-frame milliseconds: `infer` (to the outputs on the
    host), `postprocess`, `evaluator` and `frame` (the sum)."""
    dev = next(model.parameters()).device
    infer = make_det_inference_fn(det_cfg, pixel_means, dev)
    n = dataset.num_images if max_frames is None else min(max_frames, dataset.num_images)
    ext = getattr(dataset, "_extents", None)
    results = []
    for i in range(n):
        frame = dataset.load_frame(i)
        t0 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in infer(model, torch.from_numpy(frame.color[None]).to(dev)).items()}
        t1 = time.perf_counter()
        dets = postprocess_det(out, det_cfg.num_classes, frame.color.shape[:2], nms_threshold=nms_threshold)
        results.append(dets)
        t2 = time.perf_counter()
        if evaluator is not None:
            gt_boxes = None
            if getattr(frame, "poses", None) is not None and frame.poses.shape[-1] and ext is not None:
                gt_boxes = gt_boxes_from_poses(frame, ext)
            evaluator.add_frame(dets, gt_label=frame.label, gt_boxes=gt_boxes)
        t3 = time.perf_counter()
        if timings is not None:
            ms = {"infer": (t1 - t0) * 1e3, "postprocess": (t2 - t1) * 1e3, "evaluator": (t3 - t2) * 1e3}
            ms["frame"] = sum(ms.values())
            for key, v in ms.items():
                timings.setdefault(key, []).append(v)
        if log and (i + 1) % 50 == 0:
            log(f"frame {i + 1}/{n}: {len(dets)} detections")
    if evaluator is not None and log:
        log(str(evaluator.summary()))
    return results
