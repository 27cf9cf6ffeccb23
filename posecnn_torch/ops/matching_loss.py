"""The matching loss: render-and-compare pose supervision (TRAIN.MATCHING).

Port of `posecnn_tpu/ops/matching_loss.py`. The reference op renders the
object model under the predicted and the GT pose and compares the images;
the JAX package's differentiable counterpart, kept here formula for formula:

  * `matching_loss`: the model points under both poses, projected with the
    intrinsics; a symmetric chamfer distance between the two projected sets
    (direct differences, not the |a|^2+|b|^2-2ab expansion: pixel
    coordinates are O(100), their squares O(1e5), and float32 cancellation
    there leaves a ~1e-3 floor that never reaches zero at the GT pose) plus
    an L1 depth term;
  * `soft_render`: each point splats a Gaussian of `sigma` pixels onto a
    grid; occupancy is 1 - prod(1 - w) (in log space, w capped at 1 - 1e-6)
    and depth a softmin(-20 z)-weighted mean. Dense (rows, H, W, P) math;
  * `render_compare_loss`: the silhouette's mean squared difference plus the
    depth's L1 where both silhouettes live, on a `raster` x `raster` grid
    over the roi. The GT render carries no gradient (JAX's stop_gradient):
    it is computed under `torch.no_grad()`, the same function with less
    memory held for the backward;
  * the `_batched` forms run every Hough row at once (JAX's vmap over the
    rows): the quaternions of each row's active class slot, the Hough
    translation for both poses, the intrinsics of `meta_data_row` for every
    row; inactive rows contribute zero, and the sum is over the rows with a
    class (at least one). `total` maps that count to the global batch's (a
    data-parallel step: the sum over the data group).
  * `silhouette_iou`: the hard comparison, on the host rasterizer
    (`native.rasterize_depth`), for evaluation.

No kernel: the JAX module has no Pallas call; this is plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from posecnn_torch.utils.quaternion import quat2mat


def _project(points: torch.Tensor, quat: torch.Tensor, trans: torch.Tensor, fx, fy, px, py):
    """points (..., P, 3) under (..., 4) quaternions (normalized) and (..., 3)
    translations -> ((..., P, 2) pixels, (..., P) camera z). The pixels
    divide by z floored at 1e-6."""
    R = quat2mat(quat, normalize=True)
    cam = points @ R.transpose(-1, -2) + trans[..., None, :]
    z = torch.maximum(cam[..., 2], torch.full((), 1e-6, dtype=cam.dtype, device=cam.device))
    return torch.stack([fx * cam[..., 0] / z + px, fy * cam[..., 1] / z + py], dim=-1), cam[..., 2]


def matching_loss(quat_pred: torch.Tensor, trans_pred: torch.Tensor, quat_gt: torch.Tensor, trans_gt: torch.Tensor,
                  points: torch.Tensor, intrinsics, depth_weight: float = 1.0) -> torch.Tensor:
    """The chamfer matching loss of one object (or of (..., 4) rows of them):
    points (..., P, 3); intrinsics (fx, fy, px, py)."""
    fx, fy, px, py = intrinsics
    pp, zp = _project(points, quat_pred, trans_pred, fx, fy, px, py)
    pg, zg = _project(points, quat_gt.detach(), trans_gt.detach(), fx, fy, px, py)
    diff = pp[..., :, None, :] - pg[..., None, :, :]
    d2 = (diff * diff).sum(dim=-1)
    chamfer = d2.amin(dim=-1).mean(dim=-1) + d2.amin(dim=-2).mean(dim=-1)
    depth = (zp - zg).abs().mean(dim=-1)
    return chamfer + depth_weight * depth


def _rows(poses_pred, poses_target, poses_weight, num_classes):
    """(has a class, the class, the predicted and the GT quaternion of it) of
    each row: the first active slot of `poses_weight` (class 0 for none)."""
    w4 = poses_weight.reshape(poses_weight.shape[0], num_classes, 4)
    active = w4[:, :, 0] > 0
    has = active.any(dim=1)
    cls = torch.argmax(active.to(torch.uint8), dim=1)  # the first maximum, as jnp.argmax
    idx4 = cls[:, None] * 4 + torch.arange(4, device=cls.device)[None, :]
    return has, cls, torch.gather(poses_pred, 1, idx4), torch.gather(poses_target, 1, idx4)


def _intrinsics(meta_data_row: torch.Tensor):
    # meta_data: K row-major in 0..8 (fx at 0, px at 2, fy at 4, py at 5)
    return meta_data_row[0], meta_data_row[4], meta_data_row[2], meta_data_row[5]


def _row_mean(losses: torch.Tensor, has: torch.Tensor, total=None) -> torch.Tensor:
    zero = torch.zeros((), dtype=losses.dtype, device=losses.device)
    count = has.to(losses.dtype).sum()
    count = count if total is None else total(count)
    return torch.where(has, losses, zero).sum() / torch.clamp(count, min=1.0)


def matching_loss_batched(poses_pred: torch.Tensor, poses_target: torch.Tensor, poses_weight: torch.Tensor,
                          poses_init: torch.Tensor, points: torch.Tensor, meta_data_row: torch.Tensor,
                          num_classes: int, total=None) -> torch.Tensor:
    """`matching_loss` over the Hough rows (R, 4C): quaternions of each row's
    active class slot, the translation of `poses_init` (R, 7) for both poses;
    the mean over the rows with a class."""
    has, cls, qp, qg = _rows(poses_pred, poses_target, poses_weight, num_classes)
    t = poses_init[:, 4:7]
    losses = matching_loss(qp, t, qg, t, points[cls], _intrinsics(meta_data_row))
    return _row_mean(losses, has, total)


def soft_render(points: torch.Tensor, quat: torch.Tensor, trans: torch.Tensor, intrinsics, grid_x: torch.Tensor,
                grid_y: torch.Tensor, sigma: float = 2.0):
    """The point-splat render: points (..., P, 3), quat (..., 4), trans (...,
    3); grid_x (..., W) and grid_y (..., H) the pixel centres. Returns
    (occupancy (..., H, W) in [0, 1), depth (..., H, W) in metres)."""
    fx, fy, px, py = intrinsics
    uv, z = _project(points, quat, trans, fx, fy, px, py)
    du = grid_x[..., None, :, None] - uv[..., None, None, :, 0]  # (..., 1, W, P)
    dv = grid_y[..., :, None, None] - uv[..., None, None, :, 1]  # (..., H, 1, P)
    w = torch.exp(-(du * du + dv * dv) / (2.0 * sigma * sigma))
    cap = torch.full((), 1.0 - 1e-6, dtype=w.dtype, device=w.device)
    occ = 1.0 - torch.exp(torch.log1p(-torch.minimum(w, cap)).sum(dim=-1))
    zw = w * torch.softmax(-z * 20.0, dim=-1)[..., None, None, :]
    zb = z[..., None, None, :]
    depth = (zw * zb).sum(dim=-1) / torch.clamp(zw.sum(dim=-1), min=1e-8)
    return occ, depth


def render_compare_loss(quat_pred: torch.Tensor, trans_pred: torch.Tensor, quat_gt: torch.Tensor,
                        trans_gt: torch.Tensor, points: torch.Tensor, intrinsics, roi: torch.Tensor,
                        raster: int = 32, sigma: float = 2.0, depth_weight: float = 1.0) -> torch.Tensor:
    """Render both poses on a `raster` x `raster` grid over roi (..., 4)
    [x1, y1, x2, y2] and compare: mean squared silhouette difference plus
    depth_weight x the L1 depth difference weighted by both occupancies."""
    steps = torch.arange(raster, dtype=roi.dtype, device=roi.device) + 0.5
    x1, y1, x2, y2 = roi[..., 0:1], roi[..., 1:2], roi[..., 2:3], roi[..., 3:4]
    gx = x1 + (x2 - x1) * steps / raster
    gy = y1 + (y2 - y1) * steps / raster
    occ_p, dep_p = soft_render(points, quat_pred, trans_pred, intrinsics, gx, gy, sigma)
    with torch.no_grad():
        occ_g, dep_g = soft_render(points, quat_gt, trans_gt, intrinsics, gx, gy, sigma)
    sil = ((occ_p - occ_g) ** 2).mean(dim=(-2, -1))
    both = occ_p * occ_g
    dep = (both * (dep_p - dep_g).abs()).sum(dim=(-2, -1)) / torch.clamp(both.sum(dim=(-2, -1)), min=1e-6)
    return sil + depth_weight * dep


def render_compare_batched(poses_pred: torch.Tensor, poses_target: torch.Tensor, poses_weight: torch.Tensor,
                           poses_init: torch.Tensor, rois: torch.Tensor, points: torch.Tensor,
                           meta_data_row: torch.Tensor, num_classes: int, raster: int = 32, sigma: float = 2.0,
                           total=None) -> torch.Tensor:
    """`render_compare_loss` over the Hough rows: poses_pred, poses_target,
    poses_weight (R, 4C), poses_init (R, 7), rois (R, 7) (the box in 2:6),
    points (C, P, 3) in metres; each row renders its class's points under
    the predicted quaternion and the Hough translation, and under the GT
    quaternion and the same translation. The mean over the rows with a
    class; the intrinsics of `meta_data_row` for every row."""
    has, cls, qp, qg = _rows(poses_pred, poses_target, poses_weight, num_classes)
    t = poses_init[:, 4:7]
    losses = render_compare_loss(qp, t, qg, t, points[cls], _intrinsics(meta_data_row), rois[:, 2:6],
                                 raster=raster, sigma=sigma)
    return _row_mean(losses, has, total)


def silhouette_iou(vertices: np.ndarray, faces: np.ndarray, pose_a: np.ndarray, pose_b: np.ndarray, K: np.ndarray,
                   height: int, width: int) -> float:
    """The intersection over union of the model's silhouettes under two
    (3, 4) poses, rasterized on the host."""
    from posecnn_torch.native import rasterize_depth

    masks = []
    for pose in (pose_a, pose_b):
        d = np.zeros((height, width), np.float32)
        lab = np.zeros((height, width), np.int32)
        rasterize_depth(d, lab, vertices, faces, pose, K, 1)
        masks.append(lab > 0)
    inter = (masks[0] & masks[1]).sum()
    union = (masks[0] | masks[1]).sum()
    return float(inter) / max(float(union), 1.0)
