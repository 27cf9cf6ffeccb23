"""Average-distance (ADD / ADD-S) pose loss with its saved analytic backward.

Port of `posecnn_tpu/ops/add_loss.py` (the reference CUDA op
`average_distance_loss_op_gpu.cu.cc`). For each row n with an active class
c (the first class whose weight is > 0), the model points of c are rotated
by the predicted and by the GT quaternion; a symmetric class matches each
predicted point to its nearest GT-rotated point (ADD-S), the earliest index
winning ties. The hinge is on the squared distance:
    loss_p = (|x1 - x2|^2 - margin) / (2 N P)   where |x1 - x2|^2 >= margin.
The forward also computes the gradient with respect to `prediction` through
dR/dq (`bottom_diff`), and the backward returns g * bottom_diff to
`prediction` only, as the reference op and JAX's custom_vjp do.
"""

from __future__ import annotations

import torch

from posecnn_torch.utils.quaternion import quat2mat

POSE_CHANNELS = 4


def _drot_dq(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 4, 3, 3) dR/dq, laid out as the CUDA kernel."""
    s, u, v, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

    def m(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    d_s = 2.0 * m([[s, -w, v], [w, s, -u], [-v, u, s]])
    d_u = 2.0 * m([[u, v, w], [v, -u, -s], [w, s, -u]])
    d_v = 2.0 * m([[-v, u, s], [u, v, w], [-s, w, -v]])
    d_w = 2.0 * m([[-w, -s, u], [s, -w, v], [u, v, w]])
    return torch.stack([d_s, d_u, d_v, d_w], dim=-3)


def _nearest(x1: torch.Tensor, x2: torch.Tensor, block: int) -> torch.Tensor:
    """(N,P) index of each x1 point's nearest x2 point by squared distance
    |a|^2 + |b|^2 - 2ab, taken over blocks of candidates; the earliest index
    wins ties (strict < across blocks, the first minimum within one)."""
    N, P, _ = x1.shape
    x1_sq = (x1 * x1).sum(dim=-1)  # (N,P)
    best_d = torch.full((N, P), float("inf"), dtype=x1.dtype, device=x1.device)
    best_i = torch.zeros((N, P), dtype=torch.int64, device=x1.device)
    for base in range(0, P, block):
        x2b = x2[:, base:base + block]
        d2 = x1_sq[:, :, None] + (x2b * x2b).sum(dim=-1)[:, None, :] - 2.0 * torch.einsum("npi,nqi->npq", x1, x2b)
        bmin, barg = d2.amin(dim=-1), torch.argmin(d2, dim=-1)
        take = bmin < best_d
        best_d = torch.where(take, bmin, best_d)
        best_i = torch.where(take, barg + base, best_i)
    return best_i


def add_loss_forward(prediction, target, weight, points, symmetry, margin: float, nn_block: int = 256):
    """(loss, bottom_diff): `add_loss.py:_forward_impl`.
    prediction/target/weight (N, 4C); points (C, P, 3); symmetry (C,)."""
    n_rows = prediction.shape[0]
    num_classes, num_points = points.shape[0], points.shape[1]
    w4 = weight.reshape(n_rows, num_classes, POSE_CHANNELS)
    active_cls = w4[:, :, 0] > 0  # the kernel tests weight[4c] only
    has_cls = active_cls.any(dim=1)
    cls_index = torch.argmax(active_cls.to(torch.uint8), dim=1)  # the first active class
    idx4 = cls_index[:, None] * POSE_CHANNELS + torch.arange(POSE_CHANNELS, device=prediction.device)
    q_gt = torch.gather(target, 1, idx4)
    q_pr = torch.gather(prediction, 1, idx4)
    pts = points[cls_index]  # (N,P,3)
    sym = symmetry[cls_index] > 0

    x1 = torch.einsum("nij,npj->npi", quat2mat(q_pr), pts)  # rotated by the prediction
    x2_all = torch.einsum("nij,npj->npi", quat2mat(q_gt), pts)  # rotated by the GT
    same = torch.arange(num_points, device=prediction.device)[None, :].expand(n_rows, num_points)
    match = torch.where(sym[:, None], _nearest(x1, x2_all, min(nn_block, num_points)), same)
    x2 = torch.gather(x2_all, 1, match[:, :, None].expand(n_rows, num_points, 3))

    diff = x1 - x2
    d2 = (diff * diff).sum(dim=-1)  # (N,P)
    active = (d2 >= margin) & has_cls[:, None]
    denom = float(n_rows * num_points)
    loss = torch.where(active, (d2 - margin) / (2.0 * denom), torch.zeros((), device=d2.device)).sum()

    # analytic gradient with respect to the prediction (.cu.cc:177-204)
    D = _drot_dq(q_pr)  # (N,4,3,3)
    diff_m = torch.where(active[:, :, None], diff, torch.zeros((), device=diff.device))
    bd = torch.einsum("npj,nkjm,npm->nk", diff_m, D, pts) / denom  # (N,4)
    onehot = torch.nn.functional.one_hot(cls_index, num_classes).to(prediction.dtype)
    bottom_diff = (onehot[:, :, None] * bd[:, None, :]).reshape(n_rows, num_classes * POSE_CHANNELS)
    bottom_diff = torch.where(has_cls[:, None], bottom_diff, torch.zeros((), device=bd.device))
    return loss, bottom_diff


class AverageDistanceLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prediction, target, weight, points, symmetry, margin: float):
        with torch.no_grad():
            loss, bottom_diff = add_loss_forward(prediction, target, weight, points, symmetry, margin)
        ctx.save_for_backward(bottom_diff)
        return loss

    @staticmethod
    def backward(ctx, g):
        (bottom_diff,) = ctx.saved_tensors
        return g * bottom_diff, None, None, None, None, None


def average_distance_loss(prediction, target, weight, points, symmetry, margin: float = 0.01) -> torch.Tensor:
    """Scalar ADD/ADD-S hinge loss; the gradient flows to `prediction` only."""
    return AverageDistanceLoss.apply(prediction, target, weight, points, symmetry, margin)
