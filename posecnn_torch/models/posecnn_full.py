"""vgg16_full: the dense FCN variant of PoseCNN that fuses all five trunk
scales (NETWORK VGG16FULL).

Port of `posecnn_tpu/models/posecnn_full.py`. Each scale of `_SCALES`
(conv5_3 down to conv1_2) goes through a 1x1 convolution to `num_units`
with ReLU; the results are summed from conv5 down, with a x2 bilinear
deconvolution (k=4) between levels, so the last sum is at the input's
resolution. This runs twice, for the label branch and for the vertex
branch (`*_vertex` layers), each followed by its own dropout draw
("dropout/fused", "dropout/fused_vertex"). The differences from
`models/posecnn.py`, kept from the JAX package:

  * the hard-label gate of `gt_label_weight` is 0.7, whatever
    `threshold_label` says (the loss's gate too: `ce_threshold` of
    `engine.train.make_train_step`);
  * Hough voting reads the heads' label and vertex maps, never the GT
    (no `hough_from_gt`, no `hough_gt_mix`);
  * the pose branch pools conv5_3 and conv4_3 with the bilinear crop pool
    at inference too, then fc6, fc7 (no dropout) and
    `poses_pred_unnormalized` in place of fc8;
  * no adaptation head, and a single trunk (no RGBD `data_p`);
    `vertex_reg_3d` and `vote_threshold` are not read.

`PoseCNNFull` holds the parameters under the JAX package's names;
`posecnn_full_forward` takes the arguments of `posecnn.posecnn_forward`
and returns the same endpoints, so the train step and the inference
function run either network.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.models import layers as L
from posecnn_torch.models.backbone import Conv, VGGTrunk, scaled_width, trunk_shapes
from posecnn_torch.models.layers import make_deconv_filter
from posecnn_torch.models.posecnn import Linear, _dropout
from posecnn_torch.ops.hard_label import hard_label
from posecnn_torch.ops.hough_voting import hough_voting
from posecnn_torch.ops.roi_pool import crop_pool_batched

# (score layer, trunk endpoint, its width at trunk_scale 1), conv5 first
_SCALES = [
    ("score_conv5", "conv5_3", 512),
    ("score_conv4", "conv4_3", 512),
    ("score_conv3", "conv3_3", 256),
    ("score_conv2", "conv2_2", 128),
    ("score_conv1", "conv1_2", 64),
]
# the hard-label gate of vgg16_full (posecnn_full.py:106)
CE_THRESHOLD = 0.7


def _check_supported(cfg: PoseCNNConfig) -> None:
    # JAX's step would read the domain_score that posecnn_full_forward never
    # returns (KeyError); vertex_reg_3d and vote_threshold it ignores, as here
    if cfg.adaptation:
        raise NotImplementedError("vgg16_full has no domain head: adaptation is not supported")


class PoseCNNFull(nn.Module):
    """The parameters of `init_posecnn_full_params`; `posecnn_full_forward`
    runs the network on them. The `upscore_conv*` deconvolutions are fixed
    bilinear filters, not parameters: `layers.deconv` rebuilds them."""

    def __init__(self, cfg: PoseCNNConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        C, U = cfg.num_classes, cfg.num_units
        self.trunk = VGGTrunk(cfg.trunk_scale, device=device)
        for name, _, c in _SCALES:
            self.add_module(name, Conv(scaled_width(c, cfg.trunk_scale), U, 1, device=device))
        self.score = Conv(U, C, 1, device=device)
        if cfg.vertex_reg:
            for name, _, c in _SCALES:
                self.add_module(name + "_vertex", Conv(scaled_width(c, cfg.trunk_scale), U, 1, device=device))
            self.vertex_pred = Conv(U, 3 * C, 1, device=device)
            if cfg.pose_reg:
                c5 = scaled_width(512, cfg.trunk_scale)
                self.fc6 = Linear(7 * 7 * c5, cfg.fc_dim, device=device)
                self.fc7 = Linear(cfg.fc_dim, cfg.fc_dim, device=device)
                self.poses_pred_unnormalized = Linear(cfg.fc_dim, 4 * C, device=device)


def init_posecnn_full_params_numpy(seed: int, cfg: PoseCNNConfig) -> Dict[str, Dict[str, np.ndarray]]:
    """Random weights in the JAX layout, with the shapes and init rules of
    `init_posecnn_full_params` (He sqrt(2/fan_in) truncated at 2 sigma;
    `score` 0.01, `vertex_pred` and `poses_pred_unnormalized` 0.001; zero
    biases; bilinear `upscore_conv*` filters at num_units), from numpy seed
    `seed`."""
    from posecnn_torch.core.convert import init_conv, init_fc

    _check_supported(cfg)
    rng = np.random.default_rng(seed)
    C, U = cfg.num_classes, cfg.num_units
    p = {name: init_conv(rng, 3, ci, co) for name, ci, co, _ in trunk_shapes(cfg.trunk_scale)}
    for suffix in ("", "_vertex") if cfg.vertex_reg else ("",):
        for name, _, c in _SCALES:
            p[name + suffix] = init_conv(rng, 1, scaled_width(c, cfg.trunk_scale), U)
        for lvl in "5432":
            p[f"upscore_conv{lvl}{suffix}"] = {"weights": make_deconv_filter(4, U)}
    p["score"] = init_conv(rng, 1, U, C, stddev=0.01)
    if cfg.vertex_reg:
        p["vertex_pred"] = init_conv(rng, 1, U, 3 * C, stddev=0.001)
        if cfg.pose_reg:
            c5 = scaled_width(512, cfg.trunk_scale)
            p["fc6"] = init_fc(rng, 7 * 7 * c5, cfg.fc_dim)
            p["fc7"] = init_fc(rng, cfg.fc_dim, cfg.fc_dim)
            p["poses_pred_unnormalized"] = init_fc(rng, cfg.fc_dim, 4 * C, stddev=0.001)
    return p


def make_full_model(cfg: PoseCNNConfig, params, device) -> PoseCNNFull:
    """`PoseCNNFull` on `device` holding JAX-layout `params` (nested or flat
    npz key paths)."""
    from posecnn_torch.core.convert import params_from_numpy

    model = PoseCNNFull(cfg, device=device)
    model.load_state_dict(params_from_numpy(params), strict=True)
    return model.eval()


def _fuse_scales(m: PoseCNNFull, net: Dict[str, torch.Tensor], suffix: str, dt, keep: float, draws,
                 name: str) -> torch.Tensor:
    """`posecnn_full.py:_fuse_scales`: the 1x1 ReLU scores of the five
    scales summed from conv5 down, x2 upsampled between levels, then one
    dropout draw."""
    h = None
    for i, (layer, endpoint, _) in enumerate(_SCALES):
        p = getattr(m, layer + suffix)
        s = L.conv2d(p.weight, p.bias, net[endpoint], relu=True, compute_dtype=dt)
        h = s if h is None else s + h
        if i < len(_SCALES) - 1:
            h = L.deconv(h, 4, 2)
    return _dropout(h, keep, draws, name)


def posecnn_full_forward(
    model: PoseCNNFull,
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
    """data (B,H,W,3) mean-subtracted BGR, H and W multiples of 16;
    extents (C,3); meta_data (B,48); gt_poses (G,13) zero-padded GT rows
    (training); gt_label_2d (B,H,W) int (training); `draws` the step's
    random numbers (training with keep_prob < 1). `gt_centers` and
    `data_p` are not read (Hough reads the heads' maps; one trunk). Returns
    the endpoints of `posecnn.posecnn_forward`: score, prob,
    prob_normalized, label_2d, gt_label_weight, vertex_pred, the Hough rows
    and the quaternions."""
    _check_supported(cfg)
    C = cfg.num_classes
    dt = cfg.compute_dtype
    train = cfg.is_train
    keep = cfg.keep_prob if train else 1.0
    m = model

    net = m.trunk(data, compute_dtype=dt)
    out: Dict[str, torch.Tensor] = {}
    fused = _fuse_scales(m, net, "", dt, keep, draws, "dropout/fused")
    score = L.conv2d(m.score.weight, m.score.bias, fused, relu=True, compute_dtype=dt)
    out["score"] = score
    out["prob"] = L.log_softmax_hd(score)
    prob_normalized = L.softmax_hd(score)
    out["prob_normalized"] = prob_normalized
    label_2d = L.argmax_2d(prob_normalized)
    out["label_2d"] = label_2d
    if gt_label_2d is not None:
        out["gt_label_weight"] = hard_label(prob_normalized, gt_label_2d, CE_THRESHOLD)
    if not cfg.vertex_reg:
        return out

    fused_v = _fuse_scales(m, net, "_vertex", dt, keep, draws, "dropout/fused_vertex")
    vertex_pred = L.conv2d(m.vertex_pred.weight, m.vertex_pred.bias, fused_v, relu=False, compute_dtype=dt)
    out["vertex_pred"] = vertex_pred

    if gt_poses is None:
        gt_poses = torch.zeros((1, 13), dtype=torch.float32, device=data.device)
    with torch.no_grad():
        hough = hough_voting(
            label_2d, vertex_pred.float(), extents, meta_data, gt_poses, num_classes=C, is_train=train,
            skip_pixels=cfg.skip_pixels, label_threshold=cfg.label_threshold, class_slots=cfg.hough_class_slots,
            max_samples=cfg.hough_max_samples, center_stride=cfg.hough_center_stride,
            refine_window=cfg.hough_refine_window, pixel_grid_stride=cfg.hough_pixel_stride,
            sampler=cfg.hough_sampler,
        )
    out["rois"] = hough.rois
    out["poses_init"] = hough.poses_init
    out["poses_target"] = hough.poses_target
    out["poses_weight"] = hough.poses_weight
    out["rois_valid"] = hough.valid
    out["num_rois"] = hough.num_rois
    if not cfg.pose_reg:
        return out

    # the pose branch: the crop pool on the trunk's float32 maps, at
    # inference too (posecnn_full.py:130-143)
    B = data.shape[0]
    R = hough.rois.shape[0]
    rois_b = hough.rois.reshape(B, R // B, 7)
    pool5 = crop_pool_batched(net["conv5_3"], rois_b, 1.0 / 16.0, 7)
    pool4 = crop_pool_batched(net["conv4_3"], rois_b, 1.0 / 8.0, 7)
    fc6 = L.fc(m.fc6.weight, m.fc6.bias, (pool4 + pool5).reshape(R, 7, 7, -1), relu=True, compute_dtype=dt)
    fc7 = L.fc(m.fc7.weight, m.fc7.bias, fc6, relu=True, compute_dtype=dt)
    fc8 = L.fc(m.poses_pred_unnormalized.weight, m.poses_pred_unnormalized.bias, fc7, relu=False, compute_dtype=dt)
    poses_tanh = torch.tanh(fc8)
    out["poses_tanh"] = poses_tanh
    out["poses_mul"] = poses_tanh * hough.poses_weight
    out["poses_pred"] = L.l2_normalize(out["poses_mul"], dim=1)
    return out
