"""PoseCNN: VGG16 trunk, label and vertex heads, Hough voting, RoI pooling
and the quaternion head, for inference and training.

Port of `posecnn_tpu/models/posecnn.py`. `PoseCNN` holds the parameters
under the JAX package's names; `posecnn_forward(model, cfg, ...)` is the
network, as `posecnn_forward(params, cfg, ...)` is in JAX, and returns the
same named endpoints in the same layouts (NHWC maps, (R, 7) rois). The
DEPTH and NORMAL inputs run the one trunk on their image; RGBD adds a
second trunk on the depth image (`data_p`), whose conv5_3 and conv4_3 the
label head reads concatenated with the colour trunk's, while the vertex
head and the RoI pools read the colour trunk's alone.

With `vertex_reg_3d` the vertex head predicts extent-normalized object
coordinates (3 channels a class) and the network ends there.

With `adaptation` the pooled RoI features also go through the gradient
reversal layer to `fc9` and the 2-way `domain_score` (the domain
classifier; its labels `label_domain` are Hough's per-row domains).

Training (`cfg.is_train`) adds dropout on add_score, addv, fc6, fc7 and
fc9, the `gt_label_weight` endpoint, GT rows into Hough voting (targets
and 9 rows a detection), the per-image `hough_gt_mix` draw that feeds Hough the GT
labels and vertex targets instead of the heads', and `poses_pred`. With
`hough_from_gt`, Hough always reads the GT label and vertex targets. Its
random numbers come from a `draws` object (`engine.train.Draws`): one
U[0,1) tensor per named use, from a torch.Generator or replayed.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.core.profiler import span
from posecnn_torch.models import layers as L
from posecnn_torch.models.backbone import Conv, VGGTrunk, scaled_width
from posecnn_torch.ops.gradient_reversal import gradient_reversal
from posecnn_torch.ops.hard_label import hard_label
from posecnn_torch.ops.hough_voting import hough_voting, hough_voting_multi
from posecnn_torch.ops.roi_pool import crop_pool_batched, roi_pool_batched
from posecnn_torch.ops.vertex_targets import vertex_targets_device


class Linear(nn.Module):
    """Weight (out, in) and bias of one fully connected layer."""

    def __init__(self, c_i: int, c_o: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((c_o, c_i), device=device))
        self.bias = nn.Parameter(torch.empty((c_o,), device=device))


class PoseCNN(nn.Module):
    """The parameters of `init_posecnn_params`; `posecnn_forward` runs the
    network on them. The RGBD input has a second trunk for the depth image
    (`trunk_p`, the JAX package's `conv*_p` layers), and the label head's
    `score_conv5` and `score_conv4` read both trunks' maps, concatenated.

    The `upscore*` deconvolutions are fixed bilinear filters, not parameters:
    `layers.deconv` rebuilds them from the formula.
    """

    def __init__(self, cfg: PoseCNNConfig, device=None):
        super().__init__()
        self.cfg = cfg
        C, U = cfg.num_classes, cfg.num_units
        c5 = scaled_width(512, cfg.trunk_scale)
        self.trunk = VGGTrunk(cfg.trunk_scale, device=device)
        dual = cfg.input_format == "RGBD"
        if dual:
            self.trunk_p = VGGTrunk(cfg.trunk_scale, device=device)
        c5_label = 2 * c5 if dual else c5
        self.score_conv5 = Conv(c5_label, U, 1, device=device)
        self.score_conv4 = Conv(c5_label, U, 1, device=device)
        self.score = Conv(U, C, 1, device=device)
        if cfg.vertex_reg:
            self.score_conv5_vertex = Conv(c5, 128, 1, device=device)
            self.score_conv4_vertex = Conv(c5, 128, 1, device=device)
            self.vertex_pred = Conv(128, 3 * C, 1, device=device)
            if cfg.pose_reg:
                self.fc6 = Linear(7 * 7 * c5, cfg.fc_dim, device=device)
                self.fc7 = Linear(cfg.fc_dim, cfg.fc_dim, device=device)
                self.fc8 = Linear(cfg.fc_dim, 4 * C, device=device)
                if cfg.adaptation:
                    self.fc9 = Linear(7 * 7 * c5, 256, device=device)
                    self.domain_score = Linear(256, 2, device=device)


def _dropout(x: torch.Tensor, keep: float, draws, name: str) -> torch.Tensor:
    if keep >= 1.0:
        return x
    return L.dropout(x, keep, uniform=draws.uniform(name, x.shape, x.device))


def posecnn_forward(
    model: PoseCNN,
    cfg: PoseCNNConfig,
    data: torch.Tensor,
    extents: torch.Tensor,
    meta_data: torch.Tensor,
    gt_poses: Optional[torch.Tensor] = None,
    gt_label_2d: Optional[torch.Tensor] = None,
    gt_centers: Optional[torch.Tensor] = None,
    draws=None,
    data_p: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """data (B,H,W,3) mean-subtracted BGR (for DEPTH and NORMAL the depth or
    normal image); data_p (B,H,W,3) the mean-subtracted depth image of the
    RGBD input; extents (C,3); meta_data (B,48);
    gt_poses (G,13) zero-padded GT rows (training); gt_label_2d (B,H,W) int
    and gt_centers (B,G,4) (training); `draws` the step's random numbers
    (training with keep_prob < 1 or hough_gt_mix > 0). Returns the named
    endpoints."""
    C = cfg.num_classes
    dt = cfg.compute_dtype
    train = cfg.is_train
    keep = cfg.keep_prob if train else 1.0
    m = model

    with span("trunk"):
        net = m.trunk(data, compute_dtype=dt)
    conv5, conv4 = net["conv5_3"], net["conv4_3"]
    out: Dict[str, torch.Tensor] = {"conv4_3": conv4, "conv5_3": conv5}
    if cfg.input_format == "RGBD":
        # the dual tower (posecnn.py:165-170): the label head reads both
        # trunks; the vertex head and the RoI pools read the colour trunk
        if data_p is None:
            raise ValueError("the RGBD input needs data_p, the depth image")
        with span("trunk"):
            net_p = m.trunk_p(data_p, compute_dtype=dt)
        label5 = torch.cat([conv5, net_p["conv5_3"]], dim=-1)
        label4 = torch.cat([conv4, net_p["conv4_3"]], dim=-1)
    else:
        label5, label4 = conv5, conv4

    with span("heads"):
        # semantic labeling branch (posecnn.py:175-192)
        score_conv5 = L.conv2d(m.score_conv5.weight, m.score_conv5.bias, label5, relu=True, compute_dtype=dt)
        upscore_conv5 = L.deconv(score_conv5, 4, 2)
        score_conv4 = L.conv2d(m.score_conv4.weight, m.score_conv4.bias, label4, relu=True, compute_dtype=dt)
        add_score = _dropout(score_conv4 + upscore_conv5, keep, draws, "dropout/add_score")
        score = L.conv1x1_upsample(m.score.weight, m.score.bias, add_score, 16, 8, relu=True, compute_dtype=dt)
        out["score"] = score
        out["prob"] = L.log_softmax_hd(score)
        prob_normalized = L.softmax_hd(score)
        out["prob_normalized"] = prob_normalized
        label_2d = L.argmax_2d(prob_normalized)
        out["label_2d"] = label_2d
        if gt_label_2d is not None:
            out["gt_label_weight"] = hard_label(prob_normalized, gt_label_2d, cfg.threshold_label)
        if not cfg.vertex_reg:
            return out

        # vertex branch (posecnn.py:200-210)
        sc5v = L.conv2d(m.score_conv5_vertex.weight, m.score_conv5_vertex.bias, conv5, relu=False, compute_dtype=dt)
        up5v = L.deconv(sc5v, 4, 2)
        sc4v = L.conv2d(m.score_conv4_vertex.weight, m.score_conv4_vertex.bias, conv4, relu=False, compute_dtype=dt)
        addv = _dropout(sc4v + up5v, keep, draws, "dropout/addv")
        vertex_pred = L.conv1x1_upsample(
            m.vertex_pred.weight, m.vertex_pred.bias, addv, 16, 8, relu=False, compute_dtype=dt
        )
        out["vertex_pred"] = vertex_pred
        if cfg.vertex_reg_3d:
            # 3D object coordinates: no Hough voting and no pose head
            # (posecnn.py:212-214); the poses come from RANSAC (engine/ransac.py)
            return out

    # Hough voting, no gradient (posecnn.py:216-283); with no GT rows, one
    # zero row, JAX's default
    with span("hough"):
        if gt_poses is None:
            gt_poses = torch.zeros((1, 13), dtype=torch.float32, device=data.device)
        with torch.no_grad():
            hough_label, hough_vert = label_2d, vertex_pred.float()
            if cfg.hough_from_gt:
                if gt_label_2d is None or gt_centers is None:
                    raise ValueError("hough_from_gt needs gt_label_2d and gt_centers")
                hough_vert, _ = vertex_targets_device(gt_label_2d, gt_centers, C)
                hough_label = gt_label_2d.to(label_2d.dtype)
            elif train and cfg.hough_gt_mix > 0.0:
                if gt_label_2d is None or gt_centers is None:
                    raise ValueError("hough_gt_mix needs gt_label_2d and gt_centers")
                gt_vt, _ = vertex_targets_device(gt_label_2d, gt_centers, C)
                pick_gt = draws.uniform("hough_gt_mix", (gt_label_2d.shape[0],), data.device) < cfg.hough_gt_mix
                hough_label = torch.where(pick_gt[:, None, None], gt_label_2d.to(label_2d.dtype), label_2d)
                hough_vert = torch.where(pick_gt[:, None, None, None], gt_vt, hough_vert)
            common = dict(num_classes=C, is_train=train, skip_pixels=cfg.skip_pixels,
                          label_threshold=cfg.label_threshold, class_slots=cfg.hough_class_slots,
                          max_samples=cfg.hough_max_samples, pixel_grid_stride=cfg.hough_pixel_stride,
                          sampler=cfg.hough_sampler)
            if cfg.vote_threshold > 0:
                # the multi-instance local-max mode (posecnn.py:243-263)
                hough = hough_voting_multi(hough_label, hough_vert, extents, meta_data, gt_poses,
                                           voting_threshold=cfg.vote_threshold, per_threshold=cfg.vote_percentage,
                                           **common)
            else:
                hough = hough_voting(hough_label, hough_vert, extents, meta_data, gt_poses,
                                     center_stride=cfg.hough_center_stride, refine_window=cfg.hough_refine_window,
                                     **common)
    out["rois"] = hough.rois
    out["poses_init"] = hough.poses_init
    out["poses_target"] = hough.poses_target
    out["poses_weight"] = hough.poses_weight
    out["rois_valid"] = hough.valid
    out["num_rois"] = hough.num_rois
    if cfg.adaptation:
        out["label_domain"] = hough.domains
    if not cfg.pose_reg:
        return out

    # quaternion branch (posecnn.py:296-330): pool in the compute dtype
    with span("pose_head"):
        B = data.shape[0]
        R = hough.rois.shape[0]
        rois_b = hough.rois.reshape(B, R // B, 7)
        c5, c4 = conv5.to(dt), conv4.to(dt)
        if cfg.use_crop_pool:
            pool5 = crop_pool_batched(c5, rois_b, 1.0 / 16.0, 7)
            pool4 = crop_pool_batched(c4, rois_b, 1.0 / 8.0, 7)
        else:
            pool5 = roi_pool_batched(c5, rois_b, 7, 1.0 / 16.0)
            pool4 = roi_pool_batched(c4, rois_b, 7, 1.0 / 8.0)
        pool_score = (pool5 + pool4).reshape(R, 7, 7, -1)
        fc6 = L.fc(m.fc6.weight, m.fc6.bias, pool_score, relu=True, compute_dtype=dt)
        fc6 = _dropout(fc6, keep, draws, "dropout/fc6")
        fc7 = L.fc(m.fc7.weight, m.fc7.bias, fc6, relu=True, compute_dtype=dt)
        fc7 = _dropout(fc7, keep, draws, "dropout/fc7")
        fc8 = L.fc(m.fc8.weight, m.fc8.bias, fc7, relu=False, compute_dtype=dt)
        poses_tanh = torch.tanh(fc8)
        poses_mul = poses_tanh * hough.poses_weight
        # tf.nn.l2_normalize(dim=1) over the whole 4C row (posecnn.py:325-327)
        out["poses_tanh"] = poses_tanh
        out["poses_mul"] = poses_mul
        out["poses_pred"] = L.l2_normalize(poses_mul, dim=1)
        if cfg.adaptation:
            # the domain classifier (posecnn.py:332-343): reversed gradient,
            # fc9, and 2-way logits without ReLU (the JAX package's departure
            # from the reference, whose ReLU'd logits could zero the gradient)
            fc9 = L.fc(m.fc9.weight, m.fc9.bias, gradient_reversal(pool_score, cfg.adapt_lambda), relu=True,
                       compute_dtype=dt)
            fc9 = _dropout(fc9, keep, draws, "dropout/fc9")
            domain_score = L.fc(m.domain_score.weight, m.domain_score.bias, fc9, relu=False)
            out["domain_score"] = domain_score
            out["domain_prob"] = L.softmax_hd(domain_score)
            out["domain_label"] = torch.argmax(domain_score, dim=-1).to(torch.int32)
    return out
