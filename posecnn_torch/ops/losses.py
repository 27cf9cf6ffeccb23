"""Training losses of the flagship step and of the segmentation networks.

Port of `posecnn_tpu/ops/losses.py:loss_cross_entropy_single_frame` (line
18), the cross entropy of a log-softmax against one-hot or soft label
weights, and `loss_cross_entropy_hard_label_sparse` (lines 24-47): the
hard-label gate and the cross entropy fused on raw logits, never
materialising the dense one-hot, softmax or log-softmax; and the
detection network's `smooth_l1_loss` (:75) and
`sparse_softmax_cross_entropy` (:98); and the dense vertex loss of the
host targets, `smooth_l1_loss_vertex` (:61). Besides, the losses the JAX
package defines and no step of either package calls:
`loss_cross_entropy_steps` (:50, the multi-frame cross entropy),
`loss_quaternion` (:92) and the pixel-embedding metric losses
`triplet_loss_embedding` (:111) and `lifted_structured_loss` (:140).
"""

from __future__ import annotations

import torch


def loss_cross_entropy_single_frame(scores: torch.Tensor, labels: torch.Tensor, total=None) -> torch.Tensor:
    """scores (B,H,W,C) log-softmax; labels (B,H,W,C) one-hot or soft
    weights. The summed cross entropy over the label mass (+1e-10).
    `total` maps the local label mass to the global batch's (a
    data-parallel step: the sum over the data group)."""
    cross_entropy = -(labels * scores).sum(dim=-1)
    count = labels.sum() if total is None else total(labels.sum())
    return cross_entropy.sum() / (count + 1e-10)


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


def loss_cross_entropy_steps(scores_list, labels_list) -> torch.Tensor:
    """The multi-frame cross entropy (`losses.py:50`): each step's summed
    cross entropy over its label mass (+1e-10, so a step with no labelled
    pixel gives 0), averaged over the steps."""
    loss = 0.0
    for score, label in zip(scores_list, labels_list):
        loss = loss + (-(label * score).sum(dim=-1)).sum() / (label.sum() + 1e-10)
    return loss / len(scores_list)


def loss_quaternion(pose_pred: torch.Tensor, pose_targets: torch.Tensor, pose_weights: torch.Tensor) -> torch.Tensor:
    """1 - <q_pred, q_target>^2 per row, weighted by the row's mean weight,
    over the weights' sum (+1e-10) (`losses.py:92`)."""
    distances = 1.0 - (pose_pred * pose_targets).sum(dim=1) ** 2
    weights = pose_weights.mean(dim=1)
    return (weights * distances).sum() / (weights.sum() + 1e-10)


def _pair_d2(embeddings: torch.Tensor) -> torch.Tensor:
    sq = (embeddings ** 2).sum(dim=1)
    return sq[:, None] + sq[None, :] - 2.0 * embeddings @ embeddings.T


def _pair_masks(labels: torch.Tensor):
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    return same & ~eye, ~same


def triplet_loss_embedding(embeddings: torch.Tensor, labels: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """Batch-hard triplet loss over (N, D) pixel embeddings with (N,) labels
    (`losses.py:111`): for each anchor with a positive and a negative,
    max(hardest positive d2 - hardest negative d2 + margin, 0); the mean
    over those anchors (+1e-10)."""
    d2 = _pair_d2(embeddings)
    pos, neg = _pair_masks(labels)
    inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
    hardest_pos = torch.where(pos, d2, -inf).amax(dim=1)
    hardest_neg = torch.where(neg, d2, inf).amin(dim=1)
    valid = pos.any(dim=1) & neg.any(dim=1)
    zero = torch.zeros((), dtype=d2.dtype, device=d2.device)
    loss = torch.maximum(hardest_pos - hardest_neg + margin, zero)
    loss = torch.where(valid, loss, zero)
    return loss.sum() / (valid.to(d2.dtype).sum() + 1e-10)


def lifted_structured_loss(embeddings: torch.Tensor, labels: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """The lifted structured embedding loss (Oh Song et al., CVPR 2016;
    `losses.py:140`): for each positive pair (i, j), J = log(sum_k exp(m -
    d_ik) + sum_l exp(m - d_jl)) + d_ij over the negatives k of i and l of
    j; the sum of max(J, 0)^2 over 2 x the positive pairs (at least 1)."""
    d = torch.sqrt(torch.clamp(_pair_d2(embeddings), min=1e-12))
    pos, neg = _pair_masks(labels)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    neg_term = torch.where(neg, torch.exp(margin - d), zero).sum(dim=1)
    J = torch.log(neg_term[:, None] + neg_term[None, :] + 1e-12) + d
    J = torch.where(pos, torch.maximum(J, zero) ** 2, zero)
    return J.sum() / (2.0 * torch.clamp(pos.sum(), min=1))
