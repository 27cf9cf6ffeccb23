"""Training losses of the flagship step and of the segmentation networks.

Port of `posecnn_tpu/ops/losses.py:loss_cross_entropy_single_frame` (line
18), the cross entropy of a log-softmax against one-hot or soft label
weights, and `loss_cross_entropy_hard_label_sparse` (lines 24-47): the
hard-label gate and the cross entropy fused on raw logits, never
materialising the dense one-hot, softmax or log-softmax.
"""

from __future__ import annotations

import torch


def loss_cross_entropy_single_frame(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """scores (B,H,W,C) log-softmax; labels (B,H,W,C) one-hot or soft
    weights. The summed cross entropy over the label mass (+1e-10)."""
    cross_entropy = -(labels * scores).sum(dim=-1)
    return cross_entropy.sum() / (labels.sum() + 1e-10)


def loss_cross_entropy_hard_label_sparse(score: torch.Tensor, gt: torch.Tensor, threshold: float) -> torch.Tensor:
    """score (B,H,W,C) post-ReLU logits; gt (B,H,W) int. Equals the cross
    entropy of log_softmax(score) against hard_label(softmax(score), gt,
    threshold). The gate is detached, as JAX's stop_gradient and the
    reference op's zero gradient."""
    C = score.shape[-1]
    gt_safe = gt.long().clamp(0, C - 1)
    score_gt = torch.gather(score, -1, gt_safe[..., None])[..., 0]
    m = score.amax(dim=-1)
    lse = m + torch.log(torch.exp(score - m[..., None]).sum(dim=-1))
    logp_gt = score_gt - lse
    prob_gt = torch.exp(logp_gt)
    select = (gt != -1) & ((gt > 0) | (prob_gt < threshold))
    gate = select.to(score.dtype).detach()
    return -(gate * logp_gt).sum() / (gate.sum() + 1e-10)
