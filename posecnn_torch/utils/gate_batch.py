"""A coherent synthetic batch whose pose branch is live.

NumPy copy of `posecnn_tpu/utils/gate_batch.py:live_pose_batch`, which the
multichip dry run (`entry.dryrun_multichip`) and the parallel tests feed:
one object per image, a label blob at the principal point, its GT centre
row and a GT pose row whose projected box is the box Hough votes for when
it reads the GT labels and centres (`hough_gt_mix` 1), so the ADD loss
and its gradient are not zero. The same RandomState gives the same arrays
as the JAX function, draw for draw.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def live_pose_batch(B: int, H: int, W: int, C: int, rng: np.random.RandomState, g_slots: int = 8,
                    with_aug: bool = True) -> Dict[str, np.ndarray]:
    """Image b holds one object of class 1 + (b % (C-1)) at the principal
    point, z = 1 m, a random unit quaternion; fx = fy = 60 and the
    principal point at the image centre (the meta_data layout of
    `data/minibatch.py`). The 'poses' rows carry the image index in column
    0, one row every g_slots. With `with_aug`, the HLS jitter deltas and the
    noise sigmas of the device-side preprocessing."""
    fx = fy = 60.0
    px, py = W / 2.0, H / 2.0
    meta = np.zeros((B, 48), np.float32)
    meta[:, 0] = fx
    meta[:, 4] = fy
    meta[:, 2], meta[:, 5] = px, py

    label = np.zeros((B, H, W), np.int32)
    centers = np.zeros((B, g_slots, 4), np.float32)
    poses = np.zeros((B * g_slots, 13), np.float32)
    half = max(3, min(H, W) // 6)
    for b in range(B):
        c = 1 + (b % (C - 1))
        cy, cx = int(py), int(px)
        label[b, cy - half:cy + half, cx - half:cx + half] = c
        z = 1.0
        centers[b, 0] = [c, px, py, z]
        q = rng.randn(4).astype(np.float32)
        q /= np.linalg.norm(q)
        row = poses[b * g_slots]
        row[0] = b
        row[1] = c
        row[6:10] = q
        # t projects onto the blob's centre: x = (px - px) / fx * z = 0
        row[10:13] = [0.0, 0.0, z]

    batch = {
        "data": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
        "gt_label_2d": label,
        "gt_centers": centers,
        "meta_data": meta,
        "poses": poses,
    }
    if with_aug:
        batch["chroma_dhls"] = ((rng.rand(B, 3).astype(np.float32) - 0.5)
                                * np.asarray([3.6, 51.2, 51.2], np.float32))
        batch["noise_sigma"] = rng.rand(B).astype(np.float32) * 8.0
    return batch
