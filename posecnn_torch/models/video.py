"""The multi-frame video models: a per-frame VGG-FCN fused over time.

Port of `posecnn_tpu/models/video.py`. `VideoNet` and `Video3DNet` hold the
parameters under the JAX package's names (`models/gru.py` for the cells);
`video_step(model, cfg, ...)` is one frame, `video_forward` a Python loop
over the T frames in place of `lax.scan`, returning the per-frame outputs
stacked over T and the final state.

  * vgg16 (`VideoConfig`): the trunk (`models/backbone.py`, conv1_2 on the
    conv3x3 kernel when it runs in bf16), the two-scale label fusion up to
    a full-resolution `upscore` of `num_units` channels, the recurrent
    (state, weights, points) warped from the previous frame by
    `ops.compute_flow` (depth and the camera motion in meta_data), fused by
    GRU2D, then the 1x1 `score`: score, prob (log-softmax),
    prob_normalized and label_2d a frame;
  * vgg16_3d (`Video3DConfig`): the same trunk and fusion to `score`, its
    softmax lifted into a voxel grid (`ops.backproject`), fused there by
    GRU3D and read back per pixel as the argmax class
    (`ops.backproject.compute_label`): score, prob_normalized, label_2d
    and flag_3d a frame.

Dtypes, as in JAX: the trunk's convolutions take `compute_dtype` (bf16:
conv1_2's output is bf16, every other layer's float32); the 1x1 score
layers cast their inputs to it and return float32; `upscore` (the
bilinear upsampling, `layers.deconv`) is float32; the GRU state, weights,
points, gates and the flow are float32, and GRU2D concatenates the float32
`upscore` with the float32 state. The `upscore*` filters are not
parameters (`layers.deconv` rebuilds them), as for PoseCNN.

The recurrent state starts as (zeros, ones, NaN points)
(`init_video_state`), the voxel state at zeros (`init_video3d_state`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from posecnn_torch.core.profiler import span
from posecnn_torch.models import layers as L
from posecnn_torch.models.backbone import Conv, VGGTrunk, trunk_shapes
from posecnn_torch.models.gru import GRU2D, GRU3D, gru2d, gru3d, init_gru2d_numpy, init_gru3d_numpy
from posecnn_torch.ops.backproject import backproject, compute_label
from posecnn_torch.ops.compute_flow import compute_flow


@dataclass(frozen=True)
class VideoConfig:
    """`posecnn_tpu/models/video.py:VideoConfig`, field for field."""

    num_classes: int = 22
    num_units: int = 64
    num_steps: int = 5
    flow_kernel: int = 3
    flow_threshold: float = 0.02
    flow_max_weight: float = 50.0
    compute_dtype: torch.dtype = torch.bfloat16


@dataclass(frozen=True)
class Video3DConfig:
    """`posecnn_tpu/models/video.py:Video3DConfig`, field for field."""

    num_classes: int = 22
    num_units: int = 64
    num_steps: int = 5
    grid_size: int = 32
    backproject_kernel: int = 1
    backproject_threshold: float = 0.02
    compute_dtype: torch.dtype = torch.bfloat16


class _FCN(nn.Module):
    """The trunk and the label fusion both video models share."""

    def __init__(self, cfg, device=None):
        super().__init__()
        C, U = cfg.num_classes, cfg.num_units
        self.trunk = VGGTrunk(device=device)
        self.score_conv5 = Conv(512, U, 1, device=device)
        self.score_conv4 = Conv(512, U, 1, device=device)
        self.score = Conv(U, C, 1, device=device)


class VideoNet(_FCN):
    def __init__(self, cfg: VideoConfig, device=None):
        super().__init__(cfg, device)
        self.gru2d = GRU2D(cfg.num_units, cfg.num_units, device=device)


class Video3DNet(_FCN):
    def __init__(self, cfg: Video3DConfig, device=None):
        super().__init__(cfg, device)
        self.gru3d = GRU3D(cfg.num_classes, cfg.num_classes, device=device)


def _init_fcn_numpy(rng: np.random.Generator, cfg) -> Dict:
    from posecnn_torch.core.convert import init_conv

    C, U = cfg.num_classes, cfg.num_units
    params = {name: init_conv(rng, 3, ci, co) for name, ci, co, _ in trunk_shapes()}
    params["score_conv5"] = init_conv(rng, 1, 512, U)
    params["upscore_conv5"] = {"weights": L.make_deconv_filter(4, U)}
    params["score_conv4"] = init_conv(rng, 1, 512, U)
    params["upscore"] = {"weights": L.make_deconv_filter(16, U)}
    params["score"] = init_conv(rng, 1, U, C, stddev=0.01)
    return params


def init_video_params_numpy(seed: int, cfg: VideoConfig) -> Dict:
    """Random weights in the JAX layout with the rules of
    `init_video_params`: He sqrt(2/fan_in) truncated at 2 sigma, `score`
    0.01, zero biases, the bilinear upscores, GRU2D's gates at zero."""
    params = _init_fcn_numpy(np.random.default_rng(seed), cfg)
    params["gru2d"] = init_gru2d_numpy(cfg.num_units, cfg.num_units)
    return params


def init_video3d_params_numpy(seed: int, cfg: Video3DConfig) -> Dict:
    """As `init_video_params_numpy`, with GRU3D's zero gates over the
    classes in place of GRU2D (`init_video3d_params`)."""
    params = _init_fcn_numpy(np.random.default_rng(seed), cfg)
    params["gru3d"] = init_gru3d_numpy(cfg.num_classes, cfg.num_classes)
    return params


def make_video_model(cfg, params: Mapping, device) -> nn.Module:
    """`VideoNet` (a `VideoConfig`) or `Video3DNet` (a `Video3DConfig`) on
    `device`, holding JAX-layout `params` (nested or flat)."""
    from posecnn_torch.core.convert import params_from_numpy

    model = (Video3DNet if isinstance(cfg, Video3DConfig) else VideoNet)(cfg, device=device)
    model.load_state_dict(params_from_numpy(params, device), strict=True)
    return model


def init_video_state(batch: int, height: int, width: int, num_units: int, device=None):
    """A video's fresh recurrent state: (state 0, weights 1, points NaN)."""
    state = torch.zeros((batch, height, width, num_units), dtype=torch.float32, device=device)
    weights = torch.ones((batch, height, width, num_units), dtype=torch.float32, device=device)
    points = torch.full((batch, height, width, 3), float("nan"), dtype=torch.float32, device=device)
    return state, weights, points


def init_video3d_state(batch: int, grid_size: int, num_classes: int, device=None) -> torch.Tensor:
    """A video's fresh voxel class distribution, zeros (B,G,G,G,C)."""
    return torch.zeros((batch, grid_size, grid_size, grid_size, num_classes), dtype=torch.float32, device=device)


def _upscore(model: _FCN, data: torch.Tensor, dt) -> torch.Tensor:
    with span("trunk"):
        net = model.trunk(data, compute_dtype=dt)
    c5, c4 = model.score_conv5, model.score_conv4
    sc5 = L.conv2d(c5.weight, c5.bias, net["conv5_3"], relu=True, compute_dtype=dt)
    sc4 = L.conv2d(c4.weight, c4.bias, net["conv4_3"], relu=True, compute_dtype=dt)
    return L.deconv(sc4 + L.deconv(sc5, 4, 2), 16, 8)


def video_step(model: VideoNet, cfg: VideoConfig, data: torch.Tensor, depth: torch.Tensor, meta_data: torch.Tensor,
               state: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
    """One frame: data (B,H,W,3) mean-subtracted BGR, depth (B,H,W) in
    metres, meta_data (B,48), state (state, weights, points). Returns
    (outputs, new state)."""
    dt = cfg.compute_dtype
    h_state, h_weights, h_points = state
    upscore = _upscore(model, data, dt)
    with span("flow_warp"):
        warped_state, warped_weights, points = compute_flow(
            h_state, h_weights, h_points, depth, meta_data, kernel_size=cfg.flow_kernel,
            threshold=cfg.flow_threshold, max_weight=cfg.flow_max_weight)
    fused, new_state, new_weights = gru2d(model.gru2d, upscore, warped_state, warped_weights)
    s = model.score
    score = L.conv2d(s.weight, s.bias, fused, relu=True, compute_dtype=dt)
    out = {"score": score, "prob": L.log_softmax_hd(score), "prob_normalized": L.softmax_hd(score),
           "label_2d": L.argmax_2d(score)}
    return out, (new_state, new_weights, points)


def _scan(step, state, data_seq, depth_seq, meta_seq):
    outs = []
    for t in range(data_seq.shape[0]):
        out, state = step(data_seq[t], depth_seq[t], meta_seq[t], state)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}, state


def video_forward(model: VideoNet, cfg: VideoConfig, data_seq: torch.Tensor, depth_seq: torch.Tensor,
                  meta_seq: torch.Tensor, state: Optional[Tuple] = None):
    """data_seq (T,B,H,W,3), depth_seq (T,B,H,W), meta_seq (T,B,48) ->
    (outputs stacked over T, the final state)."""
    T, B, H, W, _ = data_seq.shape
    if state is None:
        state = init_video_state(B, H, W, cfg.num_units, device=data_seq.device)
    return _scan(lambda d, z, m, s: video_step(model, cfg, d, z, m, s), state, data_seq, depth_seq, meta_seq)


def video3d_step(model: Video3DNet, cfg: Video3DConfig, data: torch.Tensor, depth: torch.Tensor,
                 meta_data: torch.Tensor, state_3d: torch.Tensor):
    """One frame: trunk -> 2D class scores -> lifted to the voxels -> GRU3D
    -> the fused distribution read back as a 2D label. Returns (outputs,
    new voxel state)."""
    dt = cfg.compute_dtype
    s = model.score
    score = L.conv2d(s.weight, s.bias, _upscore(model, data, dt), relu=True, compute_dtype=dt)
    prob2d = L.softmax_hd(score).to(torch.float32)
    _, vox_label, flag = backproject(prob2d, prob2d, depth, meta_data, state_3d, grid_size=cfg.grid_size,
                                     kernel_size=cfg.backproject_kernel, threshold=cfg.backproject_threshold)
    fused, new_state = gru3d(model.gru3d, vox_label, flag, state_3d)
    out = {"score": score, "prob_normalized": prob2d, "label_2d": compute_label(fused, depth, meta_data, cfg.grid_size),
           "flag_3d": flag}
    return out, new_state


def video3d_forward(model: Video3DNet, cfg: Video3DConfig, data_seq: torch.Tensor, depth_seq: torch.Tensor,
                    meta_seq: torch.Tensor, state_3d: Optional[torch.Tensor] = None):
    """The voxel-fusion step over T frames: (outputs stacked over T, the
    final voxel state)."""
    if state_3d is None:
        state_3d = init_video3d_state(data_seq.shape[1], cfg.grid_size, cfg.num_classes, device=data_seq.device)
    return _scan(lambda d, z, m, s: video3d_step(model, cfg, d, z, m, s), state_3d, data_seq, depth_seq, meta_seq)
