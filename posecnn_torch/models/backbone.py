"""VGG16 convolutional trunk (conv1_1 ... conv5_3).

Port of `posecnn_tpu/models/backbone.py`. Parameters are named as in the JAX
package (`conv1_1.weight` holds `['conv1_1']['weights']`, OIHW); the second
tower of the RGBD input is another `VGGTrunk`, whose layers the JAX package
names with the suffix `_p` (`conv1_1_p`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from posecnn_torch.models.layers import conv2d, conv3x3_bf16_bias_relu, conv3x3_bf16_conv2d, max_pool

VGG_CONV_DEFS = [
    # (name, c_i, c_o, pool_after)
    ("conv1_1", 3, 64, False),
    ("conv1_2", 64, 64, True),
    ("conv2_1", 64, 128, False),
    ("conv2_2", 128, 128, True),
    ("conv3_1", 128, 256, False),
    ("conv3_2", 256, 256, False),
    ("conv3_3", 256, 256, True),
    ("conv4_1", 256, 512, False),
    ("conv4_2", 512, 512, False),
    ("conv4_3", 512, 512, True),
    ("conv5_1", 512, 512, False),
    ("conv5_2", 512, 512, False),
    ("conv5_3", 512, 512, False),
]


def scaled_width(c: int, scale: float) -> int:
    """Channel width under a trunk width multiplier (min 8, /8-aligned)."""
    if scale >= 1.0:
        return c
    return max(8, int(round(c * scale / 8)) * 8)


class Conv(nn.Module):
    """Weight (OIHW) and bias of one convolution; `layers.conv2d` applies it."""

    def __init__(self, c_i: int, c_o: int, k: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((c_o, c_i, k, k), device=device))
        self.bias = nn.Parameter(torch.empty((c_o,), device=device))


def trunk_shapes(width_scale: float = 1.0):
    """(name, c_i, c_o, pool_after) of every trunk layer at this width."""
    out = []
    for name, c_i, c_o, pool_after in VGG_CONV_DEFS:
        ci = c_i if c_i == 3 else scaled_width(c_i, width_scale)
        out.append((name, ci, scaled_width(c_o, width_scale), pool_after))
    return out


class VGGTrunk(nn.Module):
    def __init__(self, width_scale: float = 1.0, device=None):
        super().__init__()
        self.defs = trunk_shapes(width_scale)
        for name, ci, co, _ in self.defs:
            self.add_module(name, Conv(ci, co, 3, device=device))

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = torch.bfloat16) -> Dict[str, torch.Tensor]:
        """x (B,H,W,3) -> dict of endpoints, conv4_3 and conv5_3 included
        (`backbone.py:vgg_trunk`)."""
        out = {}
        h = x
        for name, _, c_out, pool_after in self.defs:
            p = getattr(self, name)
            if compute_dtype == torch.bfloat16 and c_out == 64 and name != "conv1_1":
                # conv1_2 on the conv3x3 kernel: from 128 rows the JAX trunk's
                # conv3x3_manual_bwd (bias added in bf16), below them its plain
                # bf16 conv2d (f32 bias) (backbone.py:69-76)
                if h.shape[1] >= 128:
                    h = conv3x3_bf16_bias_relu(p.weight, p.bias, h)
                else:
                    h = conv3x3_bf16_conv2d(p.weight, p.bias, h)
            else:
                h = conv2d(p.weight, p.bias, h, relu=True, compute_dtype=compute_dtype)
            out[name] = h
            if pool_after:
                h = max_pool(h, 2, 2)
                out["pool" + name[4]] = h
        return out
