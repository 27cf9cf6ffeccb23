"""Model FLOPs of one training step, counted from the cell's shapes.

What is counted: the learned convolutions and dense layers, 2 operations a
multiply-add, forward plus the weight gradient plus the input gradient
(the first convolution's input gradient excepted: nothing needs it). What
is not: the fixed bilinear upsamplings, the pooling, the Hough voting, the
losses, the optimizer and every other elementwise pass. So `mfu.train` is
a lower bound of the share of the peak the step's work could fill, and it
stays the same yardstick whatever a later kernel does.
"""

from __future__ import annotations

from typing import List, Tuple

VGG16 = [
    # (name, c_i, c_o, pool_after)
    ("conv1_1", 3, 64, False), ("conv1_2", 64, 64, True),
    ("conv2_1", 64, 128, False), ("conv2_2", 128, 128, True),
    ("conv3_1", 128, 256, False), ("conv3_2", 256, 256, False), ("conv3_3", 256, 256, True),
    ("conv4_1", 256, 512, False), ("conv4_2", 512, 512, False), ("conv4_3", 512, 512, True),
    ("conv5_1", 512, 512, False), ("conv5_2", 512, 512, False), ("conv5_3", 512, 512, False),
]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def trunk_layers(H: int, W: int) -> List[Tuple[str, int, int, int, int, int]]:
    """(name, k, c_i, c_o, H_out, W_out) of the VGG16 trunk on an HxW image
    (SAME 3x3 convolutions, 2x2 pools rounding up)."""
    out = []
    h, w = H, W
    for name, ci, co, pool in VGG16:
        out.append((name, 3, ci, co, h, w))
        if pool:
            h, w = _ceil_div(h, 2), _ceil_div(w, 2)
    return out


def _conv_macs(n: int, k: int, ci: int, co: int, h: int, w: int) -> float:
    return float(n) * h * w * ci * co * k * k


def _train_flops(layers, n: int) -> float:
    """2 x (forward + dW + dX) MACs of `layers` [(name, k, ci, co, h, w)]
    over n images; the first layer has no dX."""
    total = 0.0
    for i, (_, k, ci, co, h, w) in enumerate(layers):
        macs = _conv_macs(n, k, ci, co, h, w)
        total += 2.0 * macs * (2 if i == 0 else 3)
    return total


def posecnn_step_flops(batch: int, H: int, W: int, num_classes: int, num_units: int, rows: int,
                       fc_dim: int = 4096) -> float:
    """The PoseCNN training step (trunk, label and vertex heads, fc6-fc8
    over `rows` RoI rows)."""
    trunk = trunk_layers(H, W)
    h16, w16 = trunk[-1][4], trunk[-1][5]
    h8, w8 = trunk[9][4], trunk[9][5]  # conv4_3
    C, U = num_classes, num_units
    heads = [
        ("score_conv5", 1, 512, U, h16, w16), ("score_conv4", 1, 512, U, h8, w8),
        ("score", 1, U, C, h8, w8),
        ("score_conv5_vertex", 1, 512, 128, h16, w16), ("score_conv4_vertex", 1, 512, 128, h8, w8),
        ("vertex_pred", 1, 128, 3 * C, h8, w8),
    ]
    fcs = [("fc6", 1, 7 * 7 * 512, fc_dim, 1, 1), ("fc7", 1, fc_dim, fc_dim, 1, 1), ("fc8", 1, fc_dim, 4 * C, 1, 1)]
    return _train_flops(trunk + heads, batch) + sum(2.0 * 3 * _conv_macs(rows, *f[1:]) for f in fcs)


def video_step_flops(frames: int, H: int, W: int, num_classes: int, num_units: int) -> float:
    """The DA-RNN video step over `frames` = T x B images: trunk, the label
    fusion, the GRU's gate convolution and the score layer at full size."""
    trunk = trunk_layers(H, W)
    h16, w16 = trunk[-1][4], trunk[-1][5]
    h8, w8 = trunk[9][4], trunk[9][5]
    C, U = num_classes, num_units
    heads = [
        ("score_conv5", 1, 512, U, h16, w16), ("score_conv4", 1, 512, U, h8, w8),
        ("gru_gates", 1, 2 * U, U, H, W), ("score", 1, U, C, H, W),
    ]
    return _train_flops(trunk + heads, frames)
