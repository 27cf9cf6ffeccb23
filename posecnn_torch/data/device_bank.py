"""The training data bank, held on the device.

Port of `posecnn_tpu/data/device_bank.py`: the frames of a fixed training
set are packed into fixed-shape arrays once (uint8 frames, labels and
compact annotation tables) and moved to the device; every train step
samples its batch there (`engine.train.make_bank_train_step`), so a step
needs no host work.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from posecnn_torch.data.minibatch import Frame, pad_im, pose_rows
from posecnn_torch.utils.meta import build_meta_data


def pack_frames(frames: List[Frame], g_max: int) -> Dict[str, np.ndarray]:
    """Frames -> the bank's arrays (`device_bank.py:pack_frames`):
      data       (N,H,W,3) uint8   raw BGR, padded to a multiple of 16
      label      (N,H,W)   uint8   class ids
      gt_centers (N,G,4)   float32 rows [cls, cx, cy, z]
      pose_rows  (N,G,13)  float32 GT pose rows (column 0 is set at sampling)
      meta_data  (N,48)    float32 K and its inverse
    """
    n = len(frames)
    im0 = pad_im(frames[0].color, 16)
    H, W = im0.shape[:2]
    data = np.zeros((n, H, W, 3), np.uint8)
    label = np.zeros((n, H, W), np.uint8)
    gt_centers = np.zeros((n, g_max, 4), np.float32)
    prow = np.zeros((n, g_max, 13), np.float32)
    metas = np.zeros((n, 48), np.float32)
    for i, f in enumerate(frames):
        im = pad_im(f.color, 16)
        data[i] = np.clip(np.round(im[..., :3]), 0, 255).astype(np.uint8)
        label[i] = pad_im(f.label.astype(np.int32), 16).astype(np.uint8)
        k = min(int(f.poses.shape[2]), g_max)
        gt_centers[i, :k, 0] = f.cls_indexes[:k]
        gt_centers[i, :k, 1:3] = f.center[:k]
        gt_centers[i, :k, 3] = f.poses[2, 3, :k]
        prow[i, :k] = pose_rows(0, f)[:k]
        metas[i] = build_meta_data(f.intrinsic_matrix)
    return {"data": data, "label": label, "gt_centers": gt_centers, "pose_rows": prow, "meta_data": metas}


def build_bank(dataset, max_gt: int = 24) -> Dict[str, np.ndarray]:
    """Every frame of `dataset` packed with G = the largest instance count,
    capped at `max_gt` (`device_bank.py:build_bank`)."""
    frames = [dataset.load_frame(i) for i in range(dataset.num_images)]
    g_max = min(max(1, max(int(f.poses.shape[2]) for f in frames)), max_gt)
    return pack_frames(frames, g_max)


def bank_to_device(bank: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in bank.items()}


def bank_nbytes(bank: Dict) -> int:
    """The bytes a bank's arrays (or tensors) hold (`device_bank.py:bank_nbytes`)."""
    return sum(int(v.nbytes) for v in bank.values())
