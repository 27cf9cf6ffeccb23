"""Model FLOPs of one detection training step (VGG16DET), counted from the
cell's shapes, as `counts/flops.py` counts the other steps: the VGG16
trunk, the RPN's 3x3 conv and its two 1x1 heads over conv5_3, then fc6,
fc7 and the class, box and quaternion heads over the sampled RoIs; 2
operations a multiply-add, forward plus the weight gradient plus the input
gradient (the first convolution's input gradient excepted). Not counted:
the anchors, the proposals and NMS, the targets, the crop pool, the losses
and the optimizer.
"""

from __future__ import annotations

from benchmark.counts.flops import _conv_macs, _train_flops, trunk_layers


def det_step_flops(H: int, W: int, num_classes: int, num_anchors: int, rois: int, fc_dim: int = 4096,
                   c5: int = 512, pool: int = 7) -> float:
    """One image (the detection trainer's batch) of H x W; `rois` RoI rows
    through the head; `c5` conv5_3's channels."""
    trunk = trunk_layers(H, W)
    h16, w16 = trunk[-1][4], trunk[-1][5]
    C, A = num_classes, num_anchors
    rpn = [("conv_rpn", 3, c5, c5, h16, w16), ("rpn_cls_score", 1, c5, 2 * A, h16, w16),
           ("rpn_bbox_pred", 1, c5, 4 * A, h16, w16)]
    fcs = [("fc6", 1, pool * pool * c5, fc_dim), ("fc7", 1, fc_dim, fc_dim), ("cls_score", 1, fc_dim, C),
           ("bbox_pred", 1, fc_dim, 4 * C), ("poses_pred_unnormalized", 1, fc_dim, 4 * C)]
    head = sum(2.0 * 3 * _conv_macs(rois, k, ci, co, 1, 1) for _, k, ci, co in fcs)
    return _train_flops(trunk + rpn, 1) + head
