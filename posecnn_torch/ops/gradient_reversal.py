"""Gradient reversal layer (domain-adversarial training, Ganin & Lempitsky).

Port of `posecnn_tpu/ops/gradient_reversal.py` (the reference op
`gradient_reversal_op.cc:30-41`): the identity forward; the backward
multiplies the incoming gradient by -lambda, in the gradient's dtype.
"""

from __future__ import annotations

import torch


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, lambda_: float) -> torch.Tensor:
        ctx.lambda_ = lambda_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return torch.tensor(-ctx.lambda_, dtype=g.dtype, device=g.device) * g, None


def gradient_reversal(x: torch.Tensor, lambda_: float) -> torch.Tensor:
    """x unchanged; its gradient is -lambda_ times the incoming one."""
    return _GradientReversal.apply(x, float(lambda_))
