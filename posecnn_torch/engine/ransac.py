"""RANSAC pose estimation from per-pixel 3D object coordinates.

Port of `posecnn_tpu/engine/ransac.py` (`kabsch` :28, `ransac_pose` :48,
`ransac_from_maps` :100), batched over the classes of a frame: the
VERTEX_REG_3D head predicts, per pixel, the extent-normalized coordinate
on the object's surface; RANSAC finds the rigid transform from object
coordinates to the back-projected depth points. For each class: 256
triplets of correspondences, a closed-form Kabsch (a batched 3x3 SVD) for
each, every hypothesis scored against every correspondence at once, the
winner (the first of the highest inlier count) refined by `refine_iters`
weighted Kabsch fits on its inliers.

The triplets' indices come from a `draws` object (`engine.train.Draws.
choice`, jax.random.choice's formula with the valid points' probabilities),
so a test can replay JAX's indices.
"""

from __future__ import annotations

from typing import Tuple

import torch

from posecnn_torch.engine.refine import sample_object_cloud
from posecnn_torch.utils.quaternion import mat2quat


def kabsch(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares rigid transform src -> dst, batched: src, dst (..., N,
    3), weights (..., N) -> (R (..., 3, 3), t (..., 3)). The det-sign
    correction diag(1, 1, d) with d = 0 (a rank-deficient covariance) taken
    as +1, as in JAX."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
    mu_s = (src * w[..., None]).sum(dim=-2)
    mu_d = (dst * w[..., None]).sum(dim=-2)
    S = (src - mu_s[..., None, :]).transpose(-1, -2) @ ((dst - mu_d[..., None, :]) * w[..., None])
    U, _, Vt = torch.linalg.svd(S)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    d = torch.where(d == 0, torch.ones_like(d), d)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ D @ Ut
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return R, t


def hypothesis_index(draws, valid: torch.Tensor, num_hypotheses: int = 256) -> torch.Tensor:
    """(..., num_hypotheses, 3) indices of correspondence triplets, drawn
    ("ransac") with replacement among the valid ones (`ransac.py:60-66`:
    the probabilities valid / max(count, 1))."""
    p = valid.float()
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1.0)
    return draws.choice("ransac", p, (num_hypotheses, 3))


def ransac_pose(
    obj_coords: torch.Tensor,
    cam_points: torch.Tensor,
    valid: torch.Tensor,
    idx: torch.Tensor,
    inlier_threshold: float = 0.01,
    refine_iters: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """obj_coords, cam_points (R,N,3) correspondences of R classes; valid
    (R,N); idx (R,H,3) the hypotheses' triplets (`hypothesis_index`).
    Returns (quat wxyz (R,4), trans (R,3), inlier count (R,))."""
    Rn = obj_coords.shape[0]
    ar = torch.arange(Rn, device=idx.device)[:, None, None]
    src3, dst3 = obj_coords[ar, idx], cam_points[ar, idx]  # (R,H,3,3)
    Rs, ts = kabsch(src3, dst3)  # (R,H,3,3), (R,H,3)

    # score every hypothesis against every correspondence: residuals (R,H,N)
    pred = torch.einsum("rhij,rnj->rhni", Rs, obj_coords) + ts[:, :, None, :]
    res = torch.linalg.vector_norm(pred - cam_points[:, None], dim=-1)
    inl = (res < inlier_threshold) & valid[:, None, :]
    best = torch.argmax(inl.sum(dim=-1), dim=-1)  # the first of the highest count
    R = Rs[torch.arange(Rn, device=idx.device), best]
    t = ts[torch.arange(Rn, device=idx.device), best]

    vf = valid.float()
    for _ in range(refine_iters):
        res = torch.linalg.vector_norm(obj_coords @ R.transpose(-1, -2) + t[:, None, :] - cam_points, dim=-1)
        w = ((res < inlier_threshold) & valid).float()
        w = torch.where(w.sum(dim=-1, keepdim=True) >= 3, w, vf)
        R, t = kabsch(obj_coords, cam_points, w)
    res = torch.linalg.vector_norm(obj_coords @ R.transpose(-1, -2) + t[:, None, :] - cam_points, dim=-1)
    n_inl = ((res < inlier_threshold) & valid).sum(dim=-1)
    return mat2quat(R), t, n_inl


def ransac_from_maps(
    draws,
    vertex_pred: torch.Tensor,
    label: torch.Tensor,
    depth: torch.Tensor,
    classes: torch.Tensor,
    extents: torch.Tensor,
    fx, fy, px, py,
    max_points: int = 512,
    num_hypotheses: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Poses of the R classes `classes` (R,) from the dense prediction
    vertex_pred (H,W,3C) (each class's 3 channels), the label map and the
    depth map in metres: one sampling pass gives each class's camera points
    and their pixels, whose predicted coordinates are unscaled by the
    class's extent ((v - 0.5) * extent, the reference's _unscale_vertmap).
    extents (C,3). Returns (quat (R,4), trans (R,3), inliers (R,))."""
    H, W = label.shape
    cam, valid, idx = sample_object_cloud(depth, label, classes, fx, fy, px, py, max_points)
    ch = 3 * classes.long()[:, None] + torch.arange(3, device=classes.device)[None, :]  # (R,3)
    vp = vertex_pred.reshape(H * W, -1)
    oc = vp[idx[:, :, None], ch[:, None, :]].float()  # (R,M,3)
    oc = (oc - 0.5) * extents[classes.long()][:, None, :]
    return ransac_pose(oc, cam, valid, hypothesis_index(draws, valid, num_hypotheses))
