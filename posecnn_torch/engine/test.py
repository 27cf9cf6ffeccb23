"""Inference engine: raw frame bytes to ROIs and poses.

Port of `posecnn_tpu/engine/test.py:make_inference_fn` and
`postprocess_detections`. The device part (mean subtraction, network, Hough
voting, pose head) runs in one call with no host round trip; host NMS then
runs on the box columns 2:6 and score column 6 (the reference read columns
0..4 of its 7-column rois, a latent bug kept behind `reference_nms_bug`).
Like the reference, the test-time quaternion is `poses_tanh`.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Tuple

import numpy as np
import torch

from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.models.posecnn import posecnn_forward
from posecnn_torch.ops.nms import nms_np


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
