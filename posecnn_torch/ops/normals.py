"""Depth to camera-frame points and surface normals.

Port of `posecnn_tpu/ops/normals.py`: the normal at a pixel is the unit
cross product of the point map's vertical and horizontal differences
(central inside, one-sided at the image's edges, as `jnp.gradient`),
turned toward the camera; pixels with no depth, or beyond the cutoff, get
a zero normal.
"""

from __future__ import annotations

import torch


def backproject_depth(depth: torch.Tensor, fx, fy, px, py) -> torch.Tensor:
    """depth (H,W) -> camera-frame points (H,W,3)."""
    h, w = depth.shape
    x = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    y = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    X = (x - px) / fx * depth
    Y = (y - py) / fy * depth
    return torch.stack([X, Y, depth], dim=-1)


def _gradient(a: torch.Tensor, dim: int) -> torch.Tensor:
    """`jnp.gradient` at unit spacing along `dim`: (a[i+1] - a[i-1]) / 2
    inside, a[1] - a[0] and a[-1] - a[-2] at the ends."""
    n = a.shape[dim]
    inner = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) / 2
    first = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    last = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def compute_normals(depth: torch.Tensor, fx, fy, px, py, depth_cutoff: float = 20.0) -> torch.Tensor:
    """depth (H,W) -> unit normals (H,W,3); invalid pixels get 0."""
    pts = backproject_depth(depth, fx, fy, px, py)
    dx = _gradient(pts, 1)
    dy = _gradient(pts, 0)
    n = torch.linalg.cross(dy, dx, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-8)
    flip = (n * pts).sum(dim=-1, keepdim=True) > 0  # n . p < 0 faces the camera
    n = torch.where(flip, -n, n)
    valid = (depth > 0) & (depth < depth_cutoff)
    return torch.where(valid[..., None], n, torch.zeros((), dtype=n.dtype, device=n.device))
