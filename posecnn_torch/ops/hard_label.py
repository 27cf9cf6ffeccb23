"""Hard-label op: one-hot GT gating with hard-example background mining.

Port of `posecnn_tpu/ops/hard_label.py` (the reference CUDA op
`hard_label_op_gpu.cu.cc:17-29`): a pixel's one-hot GT row is kept when its
label is not -1 and it is foreground or the network's probability at the GT
class is below `threshold`. No gradient flows through it, as in the
reference op and JAX's `stop_gradient`.
"""

from __future__ import annotations

import torch


def hard_label(prob: torch.Tensor, gt: torch.Tensor, threshold: float) -> torch.Tensor:
    """prob (B,H,W,C) float; gt (B,H,W) int -> (B,H,W,C) one-hot, detached."""
    C = prob.shape[-1]
    gt_safe = gt.long().clamp(0, C - 1)
    prob_at_gt = torch.gather(prob, -1, gt_safe[..., None])[..., 0]
    select = (gt != -1) & ((gt > 0) | (prob_at_gt < threshold))
    onehot = torch.nn.functional.one_hot(gt_safe, C).to(prob.dtype)
    return torch.where(select[..., None], onehot, torch.zeros((), dtype=prob.dtype, device=prob.device)).detach()
