"""ResNet-50 segmentation network (NETWORK RESNET50, --network resnet50).

Port of `posecnn_tpu/models/resnet50.py` (`init_resnet50_params`,
`resnet50_forward`): a stride-16 trunk (a 7x7/2 convolution with no max
pool, stages res2..res5 at strides 1, 2, 2, 2, each opened by a block with
a projection shortcut), a 1x1 `score` layer with no ReLU, the x16 bilinear
`upscore` (32x32, a fixed filter, not a parameter) and the log-softmax.
The batch norm is inference-style, `(x - mean) * rsqrt(variance + 1e-5)`
with no scale or offset; its `mean` and `variance` are parameters, as in
the JAX package, where the optimizer updates them and the L2 term leaves
them out (`engine.train.make_seg_train_step`). The convolutions use
TensorFlow's SAME padding (the 7x7/2 pads 2 before and 3 after on even
sides) on cuDNN; the network has no 64->64 stride-1 3x3 at full
resolution, so it runs no conv3x3 kernel, as the JAX package runs XLA
convolutions there. Inside the trunk activations are NCHW views of
channels-last memory; the endpoints are NHWC, as the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from posecnn_torch.models import layers as L
from posecnn_torch.models.layers import make_deconv_filter

# (stage, blocks, mid_channels, out_channels, stride)
STAGES = [
    ("2", "abc", 64, 256, 1),
    ("3", "abcd", 128, 512, 2),
    ("4", "abcdef", 256, 1024, 2),
    ("5", "abc", 512, 2048, 2),
]
BN_EPS = 1e-5


class ConvW(nn.Module):
    """A convolution's weight (OIHW) and, where the JAX layer has one, bias."""

    def __init__(self, c_i: int, c_o: int, k: int, bias: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((c_o, c_i, k, k), device=device))
        self.bias = nn.Parameter(torch.empty((c_o,), device=device)) if bias else None


class BN(nn.Module):
    """The inference-style batch norm's stored `mean` and `variance`."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.mean = nn.Parameter(torch.zeros((c,), device=device))
        self.variance = nn.Parameter(torch.ones((c,), device=device))


def layer_shapes(num_classes: int):
    """(name, kind, shape) of every parameter layer in the JAX package's
    order: kind "conv" (k, c_i, c_o, bias) or "bn" (c,)."""
    out = [("conv1", "conv", (7, 3, 64, True)), ("bn_conv1", "bn", (64,))]
    c_in = 64
    for stage, blocks, mid, c_out, _ in STAGES:
        out += [(f"res{stage}a_branch1", "conv", (1, c_in, c_out, False)), (f"bn{stage}a_branch1", "bn", (c_out,))]
        for b in blocks:
            cin_b = c_in if b == "a" else c_out
            for br, k, ci, co in (("2a", 1, cin_b, mid), ("2b", 3, mid, mid), ("2c", 1, mid, c_out)):
                out += [(f"res{stage}{b}_branch{br}", "conv", (k, ci, co, False)),
                        (f"bn{stage}{b}_branch{br}", "bn", (co,))]
        c_in = c_out
    out.append(("score", "conv", (1, 2048, num_classes, True)))
    return out


class ResNet50(nn.Module):
    """The parameters of `init_resnet50_params`, under its names
    (`res2a_branch2b.weight` holds `['res2a_branch2b']['weights']`);
    `resnet50_forward` runs them."""

    def __init__(self, num_classes: int, device=None):
        super().__init__()
        for name, kind, s in layer_shapes(num_classes):
            if kind == "conv":
                k, ci, co, bias = s
                self.add_module(name, ConvW(ci, co, k, bias, device=device))
            else:
                self.add_module(name, BN(s[0], device=device))


def init_resnet50_params_numpy(seed: int, num_classes: int) -> Dict[str, Dict[str, np.ndarray]]:
    """Random weights in the JAX layout with the shapes and init rules of
    `init_resnet50_params`, from numpy seed `seed`: He sqrt(2/fan_in)
    truncated at 2 sigma (conv1 with zero biases, the others without
    biases), each block's `branch2c` at stddev 0.01, `score` at 0.01 with
    zero biases, batch norms at mean 0 and variance 1, the bilinear
    `upscore`. Statistically like JAX's draws, not equal to them."""
    from posecnn_torch.core.convert import _trunc_normal

    rng = np.random.default_rng(seed)
    p = {}
    for name, kind, s in layer_shapes(num_classes):
        if kind == "bn":
            p[name] = {"mean": np.zeros(s, np.float32), "variance": np.ones(s, np.float32)}
            continue
        k, ci, co, bias = s
        std = 0.01 if name.endswith("branch2c") or name == "score" else math.sqrt(2.0 / (k * k * ci))
        p[name] = {"weights": _trunc_normal(rng, (k, k, ci, co), std)}
        if bias:
            p[name]["biases"] = np.zeros((co,), np.float32)
    p["upscore"] = {"weights": make_deconv_filter(32, num_classes)}
    return p


def make_resnet50(num_classes: int, params, device) -> ResNet50:
    """`ResNet50` on `device` holding JAX-layout `params` (nested or flat
    npz key paths)."""
    from posecnn_torch.core.convert import params_from_numpy

    model = ResNet50(num_classes, device=device)
    model.load_state_dict(params_from_numpy(params, device), strict=True)
    return model.eval()


def _same_pads(n: int, k: int, s: int):
    """TensorFlow SAME padding of one axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(c: ConvW, x: torch.Tensor, stride: int, dt) -> torch.Tensor:
    """`layers.conv2d` of the JAX package with relu=False on an NCHW view:
    the operands in `dt`, the result in float32, then the bias."""
    k = c.weight.shape[-1]
    (t, b), (lft, r) = _same_pads(x.shape[2], k, stride), _same_pads(x.shape[3], k, stride)
    if dt is not None:
        x = x.to(dt)
    if t or b or lft or r:
        x = F.pad(x, (lft, r, t, b)).contiguous(memory_format=torch.channels_last)
    w = c.weight if dt is None else c.weight.to(dt, memory_format=torch.channels_last)
    y = F.conv2d(x, w, stride=stride).float()
    return y if c.bias is None else y + c.bias.view(1, -1, 1, 1)


def _bn(n: BN, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    y = (x - n.mean.view(1, -1, 1, 1)) * torch.rsqrt(n.variance.view(1, -1, 1, 1) + BN_EPS)
    return torch.relu(y) if relu else y


def resnet50_forward(model: ResNet50, data: torch.Tensor, num_classes: int,
                     compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """data (B,H,W,3) mean-subtracted BGR, H and W multiples of 16 ->
    score (B,H,W,C) logits, prob (log-softmax), prob_normalized (softmax)
    and label_2d (argmax)."""
    dt, m = compute_dtype, model
    h = data.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
    h = _bn(m.bn_conv1, _conv(m.conv1, h, 2, dt), relu=True)
    for stage, blocks, _mid, _out, stride in STAGES:
        def unit(name, x, s, relu):
            return _bn(getattr(m, f"bn{stage}{name}"), _conv(getattr(m, f"res{stage}{name}"), x, s, dt), relu)

        shortcut = unit("a_branch1", h, stride, False)
        for b in blocks:
            x = unit(f"{b}_branch2a", h, stride if b == "a" else 1, True)
            x = unit(f"{b}_branch2b", x, 1, True)
            x = unit(f"{b}_branch2c", x, 1, False)
            h = torch.relu((shortcut if b == "a" else h) + x)
    score = _conv(m.score, h, 1, dt).permute(0, 2, 3, 1).contiguous()
    upscore = L.deconv(score, 32, 16)
    return {
        "score": upscore,
        "prob": L.log_softmax_hd(upscore),
        "prob_normalized": L.softmax_hd(upscore),
        "label_2d": L.argmax_2d(upscore),
    }
