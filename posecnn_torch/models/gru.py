"""Recurrent cells of the video models.

Port of `posecnn_tpu/models/gru.py`. Each cell's parameters are a module
laid out as the JAX tree (`['gru2d']['Gates']['weights']` is
`gru2d.Gates.weight`, OIHW; GRU3D's `Gates` a (out, in) matrix); each cell
is a function of the module and the tensors (NHWC, or (B,G,G,G,C)):

  * `gru2d` (lib/networks/gru2d.py): one sigmoid update gate u from a 1x1
    conv over [inputs, state]; the running weighted average
    new_h = relu((w state + u inputs) / (w + u)), new_w = w + u;
  * `gru2d_original`: the convolutional GRU with reset and update gates
    (1x1) and a 3x3 tanh candidate;
  * `vanilla2d`: tanh(conv1x1([inputs, state]));
  * `add2d`: the running average by step count;
  * `gru3d`: the flag-gated voxel update, the 1x1x1 conv3d as a per-voxel
    matmul over [inputs, state]: new_h = flag relu(u state + (1-u) inputs)
    + (1-flag) state.

GRU2D's and GRU3D's gates start at zero (`gru.py:27-35`, :77-85: u = 0.5);
the others draw He-scaled weights. The convolutions run in float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from posecnn_torch.models.backbone import Conv
from posecnn_torch.models.layers import conv2d


class Linear(nn.Module):
    """Weight (out, in) and bias of a per-voxel matmul."""

    def __init__(self, c_i: int, c_o: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((c_o, c_i), device=device))
        self.bias = nn.Parameter(torch.empty((c_o,), device=device))


class GRU2D(nn.Module):
    def __init__(self, num_units: int, channels: int, device=None):
        super().__init__()
        self.Gates = Conv(num_units + channels, num_units, 1, device=device)


class GRU2DOriginal(nn.Module):
    def __init__(self, num_units: int, channels: int, device=None):
        super().__init__()
        self.Gates = Conv(num_units + channels, 2 * num_units, 1, device=device)
        self.Candidate = Conv(num_units + channels, num_units, 3, device=device)


class Vanilla2D(nn.Module):
    def __init__(self, num_units: int, channels: int, device=None):
        super().__init__()
        self.W = Conv(num_units + channels, num_units, 1, device=device)


class GRU3D(nn.Module):
    def __init__(self, num_units: int, channels: int, device=None):
        super().__init__()
        self.Gates = Linear(num_units + channels, num_units, device=device)


def init_gru2d_numpy(num_units: int, channels: int) -> Dict[str, Dict[str, np.ndarray]]:
    """GRU2D's zero gates in the JAX layout (1,1,U+C,U)."""
    return {"Gates": {"weights": np.zeros((1, 1, num_units + channels, num_units), np.float32),
                      "biases": np.zeros((num_units,), np.float32)}}


def init_gru3d_numpy(num_units: int, channels: int) -> Dict[str, Dict[str, np.ndarray]]:
    """GRU3D's zero gates in the JAX layout (U+C, U)."""
    return {"Gates": {"weights": np.zeros((num_units + channels, num_units), np.float32),
                      "biases": np.zeros((num_units,), np.float32)}}


def init_gru2d_original_numpy(rng: np.random.Generator, num_units: int, channels: int):
    from posecnn_torch.core.convert import init_conv

    return {"Gates": init_conv(rng, 1, num_units + channels, 2 * num_units),
            "Candidate": init_conv(rng, 3, num_units + channels, num_units)}


def init_vanilla2d_numpy(rng: np.random.Generator, num_units: int, channels: int):
    from posecnn_torch.core.convert import init_conv

    return {"W": init_conv(rng, 1, num_units + channels, num_units)}


def _conv(c: Conv, x: torch.Tensor) -> torch.Tensor:
    return conv2d(c.weight, c.bias, x, relu=False)


def gru2d(cell: GRU2D, inputs: torch.Tensor, state: torch.Tensor, weights: torch.Tensor):
    """inputs (B,H,W,C), state and weights (B,H,W,U) -> (out, new_state,
    new_weights)."""
    u = torch.sigmoid(_conv(cell.Gates, torch.cat([inputs, state], dim=3)))
    new_w = weights + u
    new_h = torch.relu((weights * state + u * inputs) / new_w)
    return new_h, new_h, new_w


def gru2d_original(cell: GRU2DOriginal, inputs: torch.Tensor, state: torch.Tensor):
    ru = torch.sigmoid(_conv(cell.Gates, torch.cat([inputs, state], dim=3)))
    r, u = torch.chunk(ru, 2, dim=3)
    c = torch.tanh(_conv(cell.Candidate, torch.cat([inputs, r * state], dim=3)))
    new_h = u * state + (1 - u) * c
    return new_h, new_h


def vanilla2d(cell: Vanilla2D, inputs: torch.Tensor, state: torch.Tensor):
    h = torch.tanh(_conv(cell.W, torch.cat([inputs, state], dim=3)))
    return h, h


def add2d(inputs: torch.Tensor, state: torch.Tensor, step: int):
    new_h = (state * step + inputs) / (step + 1)
    return new_h, new_h


def gru3d(cell: GRU3D, inputs: torch.Tensor, flag: torch.Tensor, state: torch.Tensor):
    """inputs (B,G,G,G,C), flag (B,G,G,G,1) 1 where a pixel saw the voxel
    this frame, state (B,G,G,G,U) -> (out, new_state)."""
    g = cell.Gates
    u = torch.sigmoid(torch.cat([inputs, state], dim=-1) @ g.weight.T + g.bias)
    fused = torch.relu(u * state + (1.0 - u) * inputs)
    new_h = flag * fused + (1.0 - flag) * state
    return new_h, new_h
