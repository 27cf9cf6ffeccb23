"""vgg16_det: the Faster-R-CNN-style detection network with a pose head.

Port of `posecnn_tpu/models/detection.py` (`DetConfig` :30,
`init_vgg16_det_params` :52, `vgg16_det_forward` :74): the VGG16 trunk,
a 3x3 RPN conv, the anchor class and box heads, the anchor targets, the
proposals (decode, top-k, NMS on `csrc/nms.cu` on a card) and the proposal
targets in the graph, then a crop pool of conv5_3, fc6 and fc7, and the
class scores, box deltas and quaternions. The output heads have no ReLU
(`relu=False`), as in JAX. `VGG16Det` holds the parameters under the JAX
package's names; `vgg16_det_forward(model, cfg, ...)` is the network.

Training draws its random numbers from a `draws` object
(`engine.train.Draws`): the RPN layers' uniforms (`ops.rpn`) and dropout
on fc6 and fc7 ("dropout/fc6", "dropout/fc7"). `trunk_scale` narrows the
trunk for tests; the JAX package has no such field.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from posecnn_torch.core.profiler import span
from posecnn_torch.models import layers as L
from posecnn_torch.models.backbone import Conv, VGGTrunk, scaled_width, trunk_shapes
from posecnn_torch.models.posecnn import Linear, _dropout
from posecnn_torch.ops.roi_pool import crop_pool_batched
from posecnn_torch.ops.rpn import (
    anchor_target_layer,
    generate_anchors,
    proposal_layer,
    proposal_target_layer,
    shifted_anchors,
)


@dataclass(frozen=True)
class DetConfig:
    """`models/detection.py:DetConfig`, field for field (same defaults),
    and the port's `trunk_scale`."""

    num_classes: int = 22
    anchor_scales: Tuple[float, ...] = (8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1, 2)
    feature_stride: int = 16
    is_train: bool = True
    keep_prob: float = 0.5
    compute_dtype: Any = torch.bfloat16
    rpn_pre_nms_top_n: int = 6000
    rpn_post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    roi_batch_size: int = 128
    fc_dim: int = 4096
    trunk_scale: float = 1.0

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)


class VGG16Det(nn.Module):
    """The parameters of `init_vgg16_det_params`."""

    def __init__(self, cfg: DetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        C, A = cfg.num_classes, cfg.num_anchors
        c5 = scaled_width(512, cfg.trunk_scale)
        self.trunk = VGGTrunk(cfg.trunk_scale, device=device)
        self.conv_rpn = Conv(c5, c5, 3, device=device)
        self.rpn_cls_score = Conv(c5, 2 * A, 1, device=device)
        self.rpn_bbox_pred = Conv(c5, 4 * A, 1, device=device)
        self.fc6 = Linear(7 * 7 * c5, cfg.fc_dim, device=device)
        self.fc7 = Linear(cfg.fc_dim, cfg.fc_dim, device=device)
        self.cls_score = Linear(cfg.fc_dim, C, device=device)
        self.bbox_pred = Linear(cfg.fc_dim, 4 * C, device=device)
        self.poses_pred_unnormalized = Linear(cfg.fc_dim, 4 * C, device=device)


def init_vgg16_det_params_numpy(seed: int, cfg: DetConfig) -> Dict[str, Dict[str, np.ndarray]]:
    """Random weights in the JAX layout, with the shapes and init rules of
    `init_vgg16_det_params` (He sqrt(2/fan_in) truncated at 2 sigma; the
    output heads at 0.01 (`rpn_cls_score`, `cls_score`) and 0.001
    (`rpn_bbox_pred`, `bbox_pred`, `poses_pred_unnormalized`); zero biases),
    from numpy seed `seed`."""
    from posecnn_torch.core.convert import init_conv, init_fc

    rng = np.random.default_rng(seed)
    C, A = cfg.num_classes, cfg.num_anchors
    c5 = scaled_width(512, cfg.trunk_scale)

    def fc(ci, co, stddev=None):
        return init_fc(rng, ci, co, stddev)

    p = {name: init_conv(rng, 3, ci, co) for name, ci, co, _ in trunk_shapes(cfg.trunk_scale)}
    p["conv_rpn"] = init_conv(rng, 3, c5, c5)
    p["rpn_cls_score"] = init_conv(rng, 1, c5, 2 * A, stddev=0.01)
    p["rpn_bbox_pred"] = init_conv(rng, 1, c5, 4 * A, stddev=0.001)
    p["fc6"] = fc(7 * 7 * c5, cfg.fc_dim)
    p["fc7"] = fc(cfg.fc_dim, cfg.fc_dim)
    p["cls_score"] = fc(cfg.fc_dim, C, stddev=0.01)
    p["bbox_pred"] = fc(cfg.fc_dim, 4 * C, stddev=0.001)
    p["poses_pred_unnormalized"] = fc(cfg.fc_dim, 4 * C, stddev=0.001)
    return p


def make_det_model(cfg: DetConfig, params, device) -> VGG16Det:
    """`VGG16Det` on `device` holding JAX-layout `params` (nested or flat
    npz key paths)."""
    from posecnn_torch.core.convert import params_from_numpy

    model = VGG16Det(cfg, device=device)
    model.load_state_dict(params_from_numpy(params, device), strict=True)
    return model.eval()


@functools.lru_cache(maxsize=16)
def _anchors(Hf: int, Wf: int, stride: int, ratios: tuple, scales: tuple, device: torch.device) -> torch.Tensor:
    # cached on the device, and made outside inference mode so that a
    # training step may use what an inference call cached
    with torch.inference_mode(False):
        base = generate_anchors(stride, ratios, scales)
        return torch.from_numpy(shifted_anchors(Hf, Wf, stride, base)).to(device)


def vgg16_det_forward(
    model: VGG16Det,
    cfg: DetConfig,
    data: torch.Tensor,
    gt_boxes: Optional[torch.Tensor] = None,
    gt_poses: Optional[torch.Tensor] = None,
    draws=None,
) -> Dict[str, torch.Tensor]:
    """One image, as in the reference: data (1,H,W,3) mean-subtracted BGR;
    gt_boxes (G,5) [x1,y1,x2,y2,cls] and gt_poses (G,13) zero-padded
    (training). Returns the named endpoints of the JAX function."""
    if data.shape[0] != 1:
        raise ValueError("the detection network takes one image, like the reference")
    m = model
    dt = cfg.compute_dtype
    C, A = cfg.num_classes, cfg.num_anchors
    H, W = data.shape[1], data.shape[2]
    train = cfg.is_train and gt_boxes is not None
    keep = cfg.keep_prob if cfg.is_train else 1.0

    with span("trunk"):
        net = m.trunk(data, compute_dtype=dt)
    conv5 = net["conv5_3"]
    with span("rpn"):
        conv_rpn = L.conv2d(m.conv_rpn.weight, m.conv_rpn.bias, conv5, relu=True, compute_dtype=dt)
        rpn_cls_score = L.conv2d(m.rpn_cls_score.weight, m.rpn_cls_score.bias, conv_rpn, relu=False,
                                 compute_dtype=dt)
        rpn_bbox_pred = L.conv2d(m.rpn_bbox_pred.weight, m.rpn_bbox_pred.bias, conv_rpn, relu=False,
                                 compute_dtype=dt)

        Hf, Wf = conv_rpn.shape[1], conv_rpn.shape[2]
        # softmax over each anchor's (bg, fg) pair, then the reference's
        # channel blocks (bg of every anchor, then fg)
        pairs = L.softmax_hd(rpn_cls_score.reshape(1, Hf, Wf, A, 2))
        rpn_prob_blocks = torch.cat([pairs[..., 0], pairs[..., 1]], dim=-1)
        anchors = _anchors(Hf, Wf, cfg.feature_stride, tuple(cfg.anchor_ratios), tuple(cfg.anchor_scales),
                           data.device)

        out: Dict[str, torch.Tensor] = {
            "rpn_cls_score": rpn_cls_score,
            "rpn_bbox_pred": rpn_bbox_pred,
            "rpn_cls_prob": rpn_prob_blocks,
        }
        if train:
            at = anchor_target_layer(draws, anchors, gt_boxes, (H, W))
            out.update(rpn_labels=at.labels, rpn_bbox_targets=at.bbox_targets,
                       rpn_bbox_inside_weights=at.bbox_inside_weights,
                       rpn_bbox_outside_weights=at.bbox_outside_weights)

    with span("proposals"):
        rois, scores = proposal_layer(
            rpn_prob_blocks[0], rpn_bbox_pred[0], anchors, (H, W), A, pre_nms_top_n=cfg.rpn_pre_nms_top_n,
            post_nms_top_n=cfg.rpn_post_nms_top_n, nms_thresh=cfg.rpn_nms_thresh,
        )
        out["rois_raw"] = rois
        out["rpn_scores"] = scores

        if train:
            if gt_poses is None:
                gt_poses = torch.zeros((gt_boxes.shape[0], 13), device=data.device)
            pt = proposal_target_layer(draws, rois, scores, gt_boxes, gt_poses, C, batch_size=cfg.roi_batch_size)
            rois_target = pt.rois
            out.update(labels=pt.labels, bbox_targets=pt.bbox_targets, bbox_inside_weights=pt.bbox_inside_weights,
                       bbox_outside_weights=pt.bbox_outside_weights, poses_target=pt.poses_target,
                       poses_weight=pt.poses_weight)
        else:
            rois_target = rois
            out["poses_weight"] = torch.ones((rois.shape[0], 4 * C), device=data.device)
        out["rois"] = rois_target

    with span("rcnn_head"):
        # the RCNN head: crop_pool reads 7-column rois (batch, cls, x1..y2)
        R = rois_target.shape[0]
        z = torch.zeros((R, 1), dtype=rois_target.dtype, device=data.device)
        rois7 = torch.cat([rois_target[:, :1], z, rois_target[:, 1:5], z], dim=1)
        pool5 = crop_pool_batched(conv5, rois7[None], 1.0 / cfg.feature_stride, 7)[0]
        fc6 = L.fc(m.fc6.weight, m.fc6.bias, pool5.reshape(R, -1), relu=True, compute_dtype=dt)
        fc6 = _dropout(fc6, keep, draws, "dropout/fc6")
        fc7 = L.fc(m.fc7.weight, m.fc7.bias, fc6, relu=True, compute_dtype=dt)
        fc7 = _dropout(fc7, keep, draws, "dropout/fc7")
        cls_score = L.fc(m.cls_score.weight, m.cls_score.bias, fc7, relu=False)
        out["cls_score"] = cls_score
        out["cls_prob"] = L.softmax_hd(cls_score)
        out["bbox_pred"] = L.fc(m.bbox_pred.weight, m.bbox_pred.bias, fc7, relu=False)
        poses_tanh = torch.tanh(L.fc(m.poses_pred_unnormalized.weight, m.poses_pred_unnormalized.bias, fc7,
                                     relu=False))
        out["poses_tanh"] = poses_tanh
        out["poses_mul"] = poses_tanh * out["poses_weight"]
        out["poses_pred"] = L.l2_normalize(out["poses_mul"], dim=1)
    return out
