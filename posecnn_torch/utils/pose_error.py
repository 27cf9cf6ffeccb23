"""6-DoF pose error metrics (Hodan et al., ECCVW 2016), in numpy.

The port's copy of the numpy functions of `posecnn_tpu/utils/pose_error.py`
(`transform_pts_Rt`, `add`, `adi`, `reproj`, `re`, `te`), and the batched
tensor forms of its JAX twins (`add_jax`, `adi_jax`, `re_jax`, `te_jax`):
`add_batched`, `adi_batched`, `re_batched`, `te_batched`.
"""

from __future__ import annotations

import numpy as np
import torch


def transform_pts_Rt(pts: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    assert pts.shape[1] == 3
    return (R @ pts.T + t.reshape(3, 1)).T


def add(R_est, t_est, R_gt, t_gt, pts) -> float:
    """Average distance of model points (ADD), Hinterstoisser ACCV 2012."""
    pts_est = transform_pts_Rt(pts, R_est, t_est)
    pts_gt = transform_pts_Rt(pts, R_gt, t_gt)
    return float(np.linalg.norm(pts_est - pts_gt, axis=1).mean())


def adi(R_est, t_est, R_gt, t_gt, pts) -> float:
    """ADD-S: the symmetric variant, by nearest-neighbour matching."""
    from scipy import spatial

    pts_est = transform_pts_Rt(pts, R_est, t_est)
    pts_gt = transform_pts_Rt(pts, R_gt, t_gt)
    nn_dists, _ = spatial.cKDTree(pts_est).query(pts_gt, k=1)
    return float(nn_dists.mean())


def reproj(K, R_est, t_est, R_gt, t_gt, pts) -> float:
    """Mean 2D reprojection error in pixels."""
    pts_est = transform_pts_Rt(pts, R_est, t_est)
    pts_gt = transform_pts_Rt(pts, R_gt, t_gt)
    pe = (K @ pts_est.T).T
    pg = (K @ pts_gt.T).T
    est = pe[:, :2] / pe[:, 2:3]
    gt = pg[:, :2] / pg[:, 2:3]
    return float(np.linalg.norm(est - gt, axis=1).mean())


def re(R_est, R_gt) -> float:
    """Rotational error in degrees."""
    assert R_est.shape == R_gt.shape == (3, 3)
    error_cos = 0.5 * (np.trace(R_est @ np.linalg.inv(R_gt)) - 1.0)
    error_cos = min(1.0, max(-1.0, error_cos))
    return float(180.0 * np.arccos(error_cos) / np.pi)


def te(t_est, t_gt) -> float:
    """Translational error (L2)."""
    assert t_est.size == t_gt.size == 3
    return float(np.linalg.norm(t_gt.flatten() - t_est.flatten()))


def add_batched(R_est, t_est, R_gt, t_gt, pts):
    """ADD of (..., 3, 3) rotations, (..., 3) translations over (..., P, 3)
    points -> (...)."""
    pe = pts @ R_est.transpose(-1, -2) + t_est[..., None, :]
    pg = pts @ R_gt.transpose(-1, -2) + t_gt[..., None, :]
    return torch.linalg.vector_norm(pe - pg, dim=-1).mean(dim=-1)


def adi_batched(R_est, t_est, R_gt, t_gt, pts):
    """ADD-S, batched: each GT point's nearest estimated point by the dense
    |a|^2 + |b|^2 - 2ab pairwise squares (as `adi_jax`), floored at 0."""
    pe = pts @ R_est.transpose(-1, -2) + t_est[..., None, :]
    pg = pts @ R_gt.transpose(-1, -2) + t_gt[..., None, :]
    d2 = ((pg * pg).sum(dim=-1)[..., :, None] + (pe * pe).sum(dim=-1)[..., None, :]
          - 2.0 * torch.einsum("...ik,...jk->...ij", pg, pe))
    return torch.sqrt(torch.clamp(d2.amin(dim=-1), min=0.0)).mean(dim=-1)


def re_batched(R_est, R_gt):
    """Rotational error in degrees, batched."""
    c = 0.5 * (torch.diagonal(R_est @ R_gt.transpose(-1, -2), dim1=-2, dim2=-1).sum(dim=-1) - 1.0)
    return torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))


def te_batched(t_est, t_gt):
    """Translational error (L2), batched."""
    return torch.linalg.vector_norm(t_gt - t_est, dim=-1)
