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

The projection runs in PyTorch on every device. The match and the window
mean are one autograd function (`_WindowMean`): on a CUDA tensor the
kernels of `posecnn_torch/csrc/flow_warp.cu` (one launch a direction; a
64-bit match mask a pixel and its count kept for the backward), on a CPU
tensor the plain version (`match_plain`, `window_mean_plain`,
`window_mean_backward_plain`: the (2k+1)^2 gathers, keeping one match mask
a window offset). Either way the gathers are not kept for the backward,
which scatters the cotangent back through the same indices. No gradient
reaches the points or the depth.
"""

from __future__ import annotations

from typing import Tuple

import torch

from posecnn_torch.ops.backproject import _apply, _camera_points, _meta_parts, xla_int32

# Kernel launches of `flow_warp.cu` since the count was last reset: one for
# each forward and one for each backward of `_WindowMean` on the card.
FLOW_WARP_LAUNCHES = 0

# the kernels keep a pixel's matches in one 64-bit word: (2k+1)^2 <= 64
MAX_KERNEL_SIZE = 3


def _flat_index(px: torch.Tensor, py: torch.Tensor, dx: int, dy: int, H: int, W: int) -> torch.Tensor:
    """The flat (B*H*W) index of each pixel's window pixel (py+dy, px+dx),
    clamped into the image."""
    B = px.shape[0]
    lin = (py + dy).clamp(0, H - 1).long() * W + (px + dx).clamp(0, W - 1).long()
    return (lin + torch.arange(B, device=px.device)[:, None, None] * (H * W)).reshape(-1)


def match_plain(px, py, z1, has_depth, z_prev, kernel_size: int, threshold: float) -> torch.Tensor:
    """((2k+1)^2, B, H, W) bool, offset by offset (dx outer, dy inner): the
    window pixel lies in the image, the pixel has depth and the previous
    points' z there (`z_prev`, (B*H*W,)) is within `threshold` of `z1`."""
    B, H, W = px.shape
    match = []
    for dx in range(-kernel_size, kernel_size + 1):
        for dy in range(-kernel_size, kernel_size + 1):
            x, y = px + dx, py + dy
            inb = (x >= 0) & (x < W) & (y >= 0) & (y < H) & has_depth
            zp = z_prev.index_select(0, _flat_index(px, py, dx, dy, H, W)).reshape(B, H, W)
            match.append(inb & (torch.abs(zp - z1) < threshold))
    return torch.stack(match)


def window_mean_plain(data, weights, px, py, match, kernel_size: int):
    """(data, weights) (B,H,W,C) -> (their means over each pixel's matched
    window pixels, (state 0, weight 1) where none matched, and the mean's
    divisor (B,H,W,1)). The two go through the window side by side, one
    (B*H*W, 2C) gather an offset; a match is 0 or 1, so acc + m * x
    (`addcmul_`) rounds as JAX's sum."""
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
    zero, one = torch.zeros((), device=data.device), torch.ones((), device=data.device)
    mean = acc / denom
    return torch.where(has, mean[..., :C], zero), torch.where(has, mean[..., C:], one), denom


def window_mean_backward_plain(g_data, g_weights, px, py, match, denom, kernel_size: int):
    """The cotangents of `window_mean_plain`'s two means -> those of data
    and weights: g / denom scattered back through each matched offset."""
    B, H, W, C = g_data.shape
    # where(has, acc / denom, .): has holds wherever a match does
    gd = torch.cat([g_data, g_weights], dim=3) / denom
    grad = torch.zeros((B * H * W, 2 * C), dtype=gd.dtype, device=gd.device)
    o = 0
    for dx in range(-kernel_size, kernel_size + 1):
        for dy in range(-kernel_size, kernel_size + 1):
            grad.index_add_(0, _flat_index(px, py, dx, dy, H, W),
                            (match[o].to(gd.dtype)[..., None] * gd).reshape(-1, 2 * C))
            o += 1
    grad = grad.reshape(B, H, W, 2 * C)
    return grad[..., :C], grad[..., C:]


def _expect(device, **specs) -> None:
    """Raise unless each named tensor (tensor, dtype, shape) has its dtype
    and shape and lies on `device`: the kernels take raw pointers."""
    for name, (t, dtype, shape) in specs.items():
        if t.dtype != dtype:
            raise TypeError(f"flow warp: {name} is {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"flow warp: {name} is {tuple(t.shape)}, want {tuple(shape)}")
        if t.device != device:
            raise ValueError(f"flow warp: {name} on {t.device}, the state on {device}")


def _check_window(kernel_size: int, B: int, H: int, W: int, C: int) -> None:
    if not 0 <= kernel_size <= MAX_KERNEL_SIZE:
        raise ValueError(f"the flow warp kernel takes kernel_size 0 to {MAX_KERNEL_SIZE}, got {kernel_size}")
    if B * H * W * max(C, 3) >= 2 ** 31:
        raise ValueError(f"flow warp: {B}x{H}x{W}x{C} is past the kernel's int32 pixel index")


def check_kernel_inputs(data, weights, px, py, z1, has_depth, points, kernel_size: int) -> None:
    """Raise where the forward kernel cannot take these inputs: float32
    state and weights (B,H,W,C) and points (B,H,W,3), int32 pixels, float32
    z1 and bool depth mask (B,H,W), all on one device, k <= MAX_KERNEL_SIZE."""
    B, H, W = px.shape
    C = data.shape[-1]
    _check_window(kernel_size, B, H, W, C)
    f32, pix = torch.float32, (B, H, W)
    _expect(data.device, data=(data, f32, pix + (C,)), weights=(weights, f32, pix + (C,)),
            px=(px, torch.int32, pix), py=(py, torch.int32, pix), z1=(z1, f32, pix),
            has_depth=(has_depth, torch.bool, pix), points=(points, f32, pix + (3,)))


def _vec(*tensors) -> int:
    """4 where every channel row can be read as float4s, else 1."""
    C = tensors[0].shape[-1]
    return 4 if C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def launch_forward(data, weights, px, py, z1, has_depth, points, kernel_size: int, threshold: float):
    """The forward kernel on the current stream: (mean of data, mean of
    weights, the 64-bit match mask (B,H,W) int64, its divisor (B,H,W)
    float32); counts the launch."""
    global FLOW_WARP_LAUNCHES
    from posecnn_torch._build import flow_warp_lib

    check_kernel_inputs(data, weights, px, py, z1, has_depth, points, kernel_size)
    data, weights, points = data.contiguous(), weights.contiguous(), points.contiguous()
    px, py, z1, has_depth = px.contiguous(), py.contiguous(), z1.contiguous(), has_depth.contiguous()
    B, H, W, C = data.shape
    out_data, out_weights = torch.empty_like(data), torch.empty_like(weights)
    mask = torch.empty((B, H, W), dtype=torch.int64, device=data.device)
    denom = torch.empty((B, H, W), dtype=torch.float32, device=data.device)
    vec = _vec(data, weights, out_data, out_weights)
    with torch.cuda.device(data.device):
        err = flow_warp_lib().flow_warp_forward_launch(
            px.data_ptr(), py.data_ptr(), z1.data_ptr(), has_depth.data_ptr(), points.data_ptr(), data.data_ptr(),
            weights.data_ptr(), out_data.data_ptr(), out_weights.data_ptr(), mask.data_ptr(), denom.data_ptr(),
            B, H, W, C, kernel_size, float(threshold), vec, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flow_warp_forward_launch failed: CUDA error {err}")
    FLOW_WARP_LAUNCHES += 1
    return out_data, out_weights, mask, denom


def launch_backward(g_data, g_weights, px, py, mask, denom, kernel_size: int):
    """The backward kernel on the current stream: the cotangents of data
    and weights, zero-filled and then added to; counts the launch."""
    global FLOW_WARP_LAUNCHES
    from posecnn_torch._build import flow_warp_lib

    B, H, W, C = g_data.shape
    _check_window(kernel_size, B, H, W, C)
    f32, pix = torch.float32, (B, H, W)
    _expect(g_data.device, g_data=(g_data, f32, pix + (C,)), g_weights=(g_weights, f32, pix + (C,)),
            px=(px, torch.int32, pix), py=(py, torch.int32, pix), mask=(mask, torch.int64, pix),
            denom=(denom, f32, pix))
    g_data, g_weights, px, py = g_data.contiguous(), g_weights.contiguous(), px.contiguous(), py.contiguous()
    mask, denom = mask.contiguous(), denom.contiguous()
    grad_data, grad_weights = torch.zeros_like(g_data), torch.zeros_like(g_weights)
    vec = _vec(g_data, g_weights, grad_data, grad_weights)
    with torch.cuda.device(g_data.device):
        err = flow_warp_lib().flow_warp_backward_launch(
            g_data.data_ptr(), g_weights.data_ptr(), px.data_ptr(), py.data_ptr(), mask.data_ptr(), denom.data_ptr(),
            grad_data.data_ptr(), grad_weights.data_ptr(), B, H, W, C, kernel_size, vec,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flow_warp_backward_launch failed: CUDA error {err}")
    FLOW_WARP_LAUNCHES += 1
    return grad_data, grad_weights


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"compute_flow: unsupported device {t.device}")
    return t.device.type


class _WindowMean(torch.autograd.Function):
    """(data, weights) (B,H,W,C) -> their means over each pixel's matched
    window pixels, (state 0, weight 1) where none matched: the kernels on
    a CUDA tensor (or a raise), the plain version on a CPU tensor."""

    @staticmethod
    def forward(ctx, data, weights, px, py, z1, has_depth, points, kernel_size, threshold):
        ctx.kernel_size = kernel_size
        if _device_type(data) == "cuda":
            out_data, out_weights, mask, denom = launch_forward(data, weights, px, py, z1, has_depth, points,
                                                                kernel_size, threshold)
            ctx.save_for_backward(px, py, mask, denom)
            return out_data, out_weights
        match = match_plain(px, py, z1, has_depth, points[..., 2].reshape(-1), kernel_size, threshold)
        out_data, out_weights, denom = window_mean_plain(data, weights, px, py, match, kernel_size)
        ctx.save_for_backward(px, py, match, denom)
        return out_data, out_weights

    @staticmethod
    def backward(ctx, g_data, g_weights):
        px, py, match, denom = ctx.saved_tensors  # on the card, `match` is the mask words
        k = ctx.kernel_size
        if _device_type(g_data) == "cuda":
            gd, gw = launch_backward(g_data, g_weights, px, py, match, denom, k)
        else:
            gd, gw = window_mean_backward_plain(g_data, g_weights, px, py, match, denom, k)
        need = ctx.needs_input_grad
        return (gd if need[0] else None), (gw if need[1] else None), None, None, None, None, None, None, None


def project_pixels(depth: torch.Tensor, meta_data: torch.Tensor):
    """The current frame's pixels taken into the previous frame's camera:
    (camera-frame points (B,H,W,3), px and py (B,H,W) int32 by XLA's cast,
    the warped z (B,H,W), depth > 0)."""
    K, Kinv, _, l2w, _, _ = _meta_parts(meta_data)
    pts = _camera_points(depth, Kinv)
    world = _apply(l2w, pts)
    pix = _apply(K, world)
    px = xla_int32(torch.round(pix[..., 0] / pix[..., 2]))
    py = xla_int32(torch.round(pix[..., 1] / pix[..., 2]))
    return pts, px, py, world[..., 2], depth > 0


def compute_flow(data: torch.Tensor, weights: torch.Tensor, points: torch.Tensor, depth: torch.Tensor,
                 meta_data: torch.Tensor, kernel_size: int = 2, threshold: float = 0.01,
                 max_weight: float = 100.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """data, weights (B,H,W,C): the previous frame's state; points (B,H,W,3)
    its camera-frame points; depth (B,H,W) the current frame's; meta_data
    (B,48). Returns (warped state, warped weights, the current points)."""
    with torch.no_grad():
        pts, px, py, z1, has_depth = project_pixels(depth, meta_data)
        top_points = torch.where(has_depth[..., None], pts, torch.full((), float("nan"), device=depth.device))
    # a fill on the device, not a host constant copied there (no sync)
    capped = torch.minimum(weights, torch.full((), max_weight, dtype=weights.dtype, device=weights.device))
    top_data, top_weights = _WindowMean.apply(data, capped, px, py, z1, has_depth, points, kernel_size, threshold)
    return top_data, top_weights, top_points
