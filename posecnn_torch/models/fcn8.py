"""FCN-8s semantic segmentation over the VGG16 trunk.

Port of `posecnn_tpu/models/fcn8.py` (`init_fcn8_params`, `fcn8_forward`):
fc6 as a 7x7 convolution over pool5 and fc7 as a 1x1, both with ReLU and
dropout in training, `score_fr`, then the 2x upsampling fused with the
pool4 score, the 2x with the pool3 score, and the 8x to the input
resolution; the upsamplings are the fixed bilinear filters of
`layers.deconv`, not parameters. The input's height and width must be
multiples of 32. `FCN8` holds the parameters under the JAX package's names;
`trunk_scale` and `fc_dim` narrow it for tests (the JAX function reads its
widths from the parameters it is given).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from posecnn_torch.models import layers as L
from posecnn_torch.models.backbone import Conv, VGGTrunk, scaled_width, trunk_shapes
from posecnn_torch.models.layers import make_deconv_filter
from posecnn_torch.models.posecnn import _dropout


class FCN8(nn.Module):
    """The parameters of `init_fcn8_params`; `fcn8_forward` runs them."""

    def __init__(self, num_classes: int, trunk_scale: float = 1.0, fc_dim: int = 4096, device=None):
        super().__init__()
        C = num_classes
        c5, c3 = scaled_width(512, trunk_scale), scaled_width(256, trunk_scale)
        self.trunk = VGGTrunk(trunk_scale, device=device)
        self.fc6 = Conv(c5, fc_dim, 7, device=device)
        self.fc7 = Conv(fc_dim, fc_dim, 1, device=device)
        self.score_fr = Conv(fc_dim, C, 1, device=device)
        self.score_pool4 = Conv(c5, C, 1, device=device)
        self.score_pool3 = Conv(c3, C, 1, device=device)


def init_fcn8_params_numpy(seed: int, num_classes: int, trunk_scale: float = 1.0,
                           fc_dim: int = 4096) -> Dict[str, Dict[str, np.ndarray]]:
    """Random weights in the JAX layout, with the shapes and init rules of
    `init_fcn8_params` (He sqrt(2/fan_in) truncated at 2 sigma, the score
    layers 0.001, zero biases, bilinear upscore filters), from numpy seed
    `seed`."""
    from posecnn_torch.core.convert import init_conv

    rng = np.random.default_rng(seed)
    C = num_classes
    c5, c3 = scaled_width(512, trunk_scale), scaled_width(256, trunk_scale)

    def conv(k, ci, co, stddev=None):
        return init_conv(rng, k, ci, co, stddev)

    p = {name: conv(3, ci, co) for name, ci, co, _ in trunk_shapes(trunk_scale)}
    p["fc6"] = conv(7, c5, fc_dim)
    p["fc7"] = conv(1, fc_dim, fc_dim)
    p["score_fr"] = conv(1, fc_dim, C, stddev=0.001)
    p["score_pool4"] = conv(1, c5, C, stddev=0.001)
    p["score_pool3"] = conv(1, c3, C, stddev=0.001)
    p["upscore2"] = {"weights": make_deconv_filter(4, C)}
    p["upscore4"] = {"weights": make_deconv_filter(4, C)}
    p["upscore32"] = {"weights": make_deconv_filter(16, C)}
    return p


def make_fcn8(num_classes: int, params, device, trunk_scale: float = 1.0, fc_dim: int = 4096) -> FCN8:
    """`FCN8` on `device` holding JAX-layout `params` (nested or flat npz
    key paths)."""
    from posecnn_torch.core.convert import params_from_numpy

    model = FCN8(num_classes, trunk_scale, fc_dim, device=device)
    model.load_state_dict(params_from_numpy(params, device), strict=True)
    return model.eval()


def fcn8_forward(model: FCN8, data: torch.Tensor, num_classes: int, compute_dtype=torch.bfloat16,
                 keep_prob: float = 1.0, draws=None) -> Dict[str, torch.Tensor]:
    """data (B,H,W,3) mean-subtracted BGR, H and W multiples of 32 ->
    score (B,H,W,C) logits, prob (log-softmax), prob_normalized (softmax)
    and label_2d (argmax). With keep_prob < 1 the dropout of fc6 and fc7
    draws from `draws` (`engine.train.Draws`: "dropout/fc6", "dropout/fc7")."""
    dt = compute_dtype
    m = model
    net = m.trunk(data, compute_dtype=dt)
    pool5 = L.max_pool(net["conv5_3"], 2, 2)
    fc6 = L.conv2d(m.fc6.weight, m.fc6.bias, pool5, relu=True, compute_dtype=dt)
    fc6 = _dropout(fc6, keep_prob, draws, "dropout/fc6")
    fc7 = L.conv2d(m.fc7.weight, m.fc7.bias, fc6, relu=True, compute_dtype=dt)
    fc7 = _dropout(fc7, keep_prob, draws, "dropout/fc7")
    score_fr = L.conv2d(m.score_fr.weight, m.score_fr.bias, fc7, relu=False, compute_dtype=dt)
    up2 = L.deconv(score_fr, 4, 2)
    sp4 = L.conv2d(m.score_pool4.weight, m.score_pool4.bias, net["pool4"], relu=False, compute_dtype=dt)
    up4 = L.deconv(up2 + sp4, 4, 2)
    sp3 = L.conv2d(m.score_pool3.weight, m.score_pool3.bias, net["pool3"], relu=False, compute_dtype=dt)
    upscore = L.deconv(up4 + sp3, 16, 8)
    return {
        "score": upscore,
        "prob": L.log_softmax_hd(upscore),
        "prob_normalized": L.softmax_hd(upscore),
        "label_2d": L.argmax_2d(upscore),
    }
