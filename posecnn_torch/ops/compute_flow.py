"""Flow warping of the video model's recurrent state between frames.

Port of `posecnn_tpu/ops/compute_flow.py:compute_flow` (:25), batched over
the images: every pixel of the current frame with depth > 0 is lifted to
its camera-frame point (K^-1, depth), taken by pose_live2world into the
previous frame's camera and projected by K; the previous state and its
weights (capped at `max_weight`) are averaged over the (2k+1)^2 window
around that pixel (dx outer, dy inner) where the stored point's z is within
`threshold` of the warped z. A pixel no window pixel matched gets state 0
and weight 1. The points returned are the current frame's camera-frame
points, NaN where the depth is 0 (the recurrent state's NaN start never
matches: a comparison with NaN is False).

The window mean is one autograd function (`_WindowMean`): its backward
scatters the cotangent back through the same indices, so the (2k+1)^2
gathers (49 at k=3, each a copy of the state) are not kept for the
backward; it keeps the projected pixels and one match mask a window
offset. No gradient reaches the points or the depth.
"""

from __future__ import annotations

from typing import Tuple

import torch

from posecnn_torch.ops.backproject import _apply, _camera_points, _meta_parts, xla_int32


def _flat_index(px: torch.Tensor, py: torch.Tensor, dx: int, dy: int, H: int, W: int) -> torch.Tensor:
    """The flat (B*H*W) index of each pixel's window pixel (py+dy, px+dx),
    clamped into the image."""
    B = px.shape[0]
    lin = (py + dy).clamp(0, H - 1).long() * W + (px + dx).clamp(0, W - 1).long()
    return (lin + torch.arange(B, device=px.device)[:, None, None] * (H * W)).reshape(-1)


class _WindowMean(torch.autograd.Function):
    """(data, weights) (B,H,W,C) -> their means over each pixel's matched
    window pixels, (state 0, weight 1) where none matched. The two go
    through the window side by side, one (B*H*W, 2C) gather an offset; a
    match is 0 or 1, so acc + m * x (`addcmul_`) rounds as JAX's sum."""

    @staticmethod
    def forward(ctx, data, weights, px, py, match, kernel_size):
        B, H, W, C = data.shape
        src = torch.cat([data, weights], dim=3).reshape(B * H * W, 2 * C)
        acc = torch.zeros((B, H, W, 2 * C), dtype=data.dtype, device=data.device)
        count = torch.zeros((B, H, W), dtype=torch.float32, device=data.device)
        o = 0
        for dx in range(-kernel_size, kernel_size + 1):
            for dy in range(-kernel_size, kernel_size + 1):
                taken = src.index_select(0, _flat_index(px, py, dx, dy, H, W)).reshape(B, H, W, 2 * C)
                acc.addcmul_(match[o].to(data.dtype)[..., None], taken)
                count = count + match[o]
                o += 1
        has = (count > 0)[..., None]
        denom = torch.clamp(count, min=1.0)[..., None]
        ctx.save_for_backward(px, py, match, denom)
        ctx.kernel_size = kernel_size
        zero, one = torch.zeros((), device=data.device), torch.ones((), device=data.device)
        mean = acc / denom
        return torch.where(has, mean[..., :C], zero), torch.where(has, mean[..., C:], one)

    @staticmethod
    def backward(ctx, g_data, g_weights):
        px, py, match, denom = ctx.saved_tensors
        k = ctx.kernel_size
        B, H, W, C = g_data.shape
        # where(has, acc / denom, .): has holds wherever a match does
        gd = torch.cat([g_data, g_weights], dim=3) / denom
        grad = torch.zeros((B * H * W, 2 * C), dtype=gd.dtype, device=gd.device)
        o = 0
        for dx in range(-k, k + 1):
            for dy in range(-k, k + 1):
                grad.index_add_(0, _flat_index(px, py, dx, dy, H, W),
                                (match[o].to(gd.dtype)[..., None] * gd).reshape(-1, 2 * C))
                o += 1
        grad = grad.reshape(B, H, W, 2 * C)
        need = ctx.needs_input_grad
        return (grad[..., :C] if need[0] else None), (grad[..., C:] if need[1] else None), None, None, None, None


def compute_flow(data: torch.Tensor, weights: torch.Tensor, points: torch.Tensor, depth: torch.Tensor,
                 meta_data: torch.Tensor, kernel_size: int = 2, threshold: float = 0.01,
                 max_weight: float = 100.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """data, weights (B,H,W,C): the previous frame's state; points (B,H,W,3)
    its camera-frame points; depth (B,H,W) the current frame's; meta_data
    (B,48). Returns (warped state, warped weights, the current points)."""
    B, H, W, C = data.shape
    K, Kinv, _, l2w, _, _ = _meta_parts(meta_data)
    with torch.no_grad():
        pts = _camera_points(depth, Kinv)
        world = _apply(l2w, pts)
        pix = _apply(K, world)
        px = xla_int32(torch.round(pix[..., 0] / pix[..., 2]))
        py = xla_int32(torch.round(pix[..., 1] / pix[..., 2]))
        z1 = world[..., 2]
        has_depth = depth > 0
        z_prev = points[..., 2].reshape(-1)
        match = []
        for dx in range(-kernel_size, kernel_size + 1):
            for dy in range(-kernel_size, kernel_size + 1):
                x, y = px + dx, py + dy
                inb = (x >= 0) & (x < W) & (y >= 0) & (y < H) & has_depth
                zp = z_prev.index_select(0, _flat_index(px, py, dx, dy, H, W)).reshape(B, H, W)
                match.append(inb & (torch.abs(zp - z1) < threshold))
        match = torch.stack(match)
        top_points = torch.where(has_depth[..., None], pts, torch.full((), float("nan"), device=depth.device))
    capped = torch.minimum(weights, torch.tensor(max_weight, device=weights.device))
    top_data, top_weights = _WindowMean.apply(data, capped, px, py, match, kernel_size)
    return top_data, top_weights, top_points
