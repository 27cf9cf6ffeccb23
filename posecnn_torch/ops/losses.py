"""Training losses of the flagship step and of the segmentation networks.

Port of `posecnn_tpu/ops/losses.py:loss_cross_entropy_single_frame` (line
18), the cross entropy of a log-softmax against one-hot or soft label
weights, and `loss_cross_entropy_hard_label_sparse` (lines 24-47): the
hard-label gate and the cross entropy fused on raw logits, never
materialising the dense one-hot, softmax or log-softmax; and the
detection network's `smooth_l1_loss` (:75) and
`sparse_softmax_cross_entropy` (:98); and the dense vertex loss of the
host targets, `smooth_l1_loss_vertex` (:61).
"""

from __future__ import annotations

import torch


def loss_cross_entropy_single_frame(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """scores (B,H,W,C) log-softmax; labels (B,H,W,C) one-hot or soft
    weights. The summed cross entropy over the label mass (+1e-10)."""
    cross_entropy = -(labels * scores).sum(dim=-1)
    return cross_entropy.sum() / (labels.sum() + 1e-10)


def loss_cross_entropy_hard_label_sparse(score: torch.Tensor, gt: torch.Tensor, threshold: float,
                                         total=None) -> torch.Tensor:
    """score (B,H,W,C) post-ReLU logits; gt (B,H,W) int. Equals the cross
    entropy of log_softmax(score) against hard_label(softmax(score), gt,
    threshold). The gate is detached, as JAX's stop_gradient and the
    reference op's zero gradient. `total` maps the local gate count to the
    global batch's (a data-parallel step: the sum over the data group)."""
    C = score.shape[-1]
    gt_safe = gt.long().clamp(0, C - 1)
    score_gt = torch.gather(score, -1, gt_safe[..., None])[..., 0]
    m = score.amax(dim=-1)
    lse = m + torch.log(torch.exp(score - m[..., None]).sum(dim=-1))
    logp_gt = score_gt - lse
    prob_gt = torch.exp(logp_gt)
    select = (gt != -1) & ((gt > 0) | (prob_gt < threshold))
    gate = select.to(score.dtype).detach()
    count = gate.sum() if total is None else total(gate.sum())
    return -(gate * logp_gt).sum() / (count + 1e-10)


def smooth_l1_loss_vertex(vertex_pred: torch.Tensor, vertex_targets: torch.Tensor, vertex_weights: torch.Tensor,
                          sigma: float = 1.0, total=None) -> torch.Tensor:
    """The dense vertex loss (B,H,W,3C): the smooth L1 of the weighted
    difference (quadratic below 1/sigma^2, its switch detached), summed over
    the weights' sum (+1e-10). `total` maps the local weight sum to the
    global batch's (a data-parallel step)."""
    sigma_2 = sigma ** 2
    diff = vertex_weights * (vertex_pred - vertex_targets)
    abs_diff = diff.abs()
    sign = (abs_diff < 1.0 / sigma_2).to(diff.dtype).detach()
    in_loss = diff * diff * (sigma_2 / 2.0) * sign + (abs_diff - 0.5 / sigma_2) * (1.0 - sign)
    count = vertex_weights.sum() if total is None else total(vertex_weights.sum())
    return in_loss.sum() / (count + 1e-10)


def smooth_l1_loss(bbox_pred: torch.Tensor, bbox_targets: torch.Tensor, bbox_inside_weights: torch.Tensor,
                   bbox_outside_weights: torch.Tensor, sigma: float = 1.0, dim=(1,)) -> torch.Tensor:
    """The RPN and RCNN box loss (`ops/losses.py:smooth_l1_loss` :75): the
    smooth L1 of the inside-weighted difference (quadratic below 1/sigma^2,
    its switch detached), outside-weighted, summed over `dim` and averaged
    over the rest."""
    sigma_2 = sigma ** 2
    diff = bbox_inside_weights * (bbox_pred - bbox_targets)
    abs_diff = diff.abs()
    sign = (abs_diff < 1.0 / sigma_2).to(diff.dtype).detach()
    in_loss = diff * diff * (sigma_2 / 2.0) * sign + (abs_diff - 0.5 / sigma_2) * (1.0 - sign)
    return (bbox_outside_weights * in_loss).sum(dim=dim).mean()


def sparse_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of integer labels (`ops/losses.py:98`)."""
    from posecnn_torch.models.layers import log_softmax_hd

    return -torch.gather(log_softmax_hd(logits), -1, labels.long()[..., None])[..., 0].mean()
