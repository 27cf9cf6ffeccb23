"""3D voxel-grid ops of the video models: lift a 2D map into a voxel grid,
and read a voxel grid back at each pixel.

Port of `posecnn_tpu/ops/backproject.py` (`_meta_parts`, `_pixel_rays`,
`_camera_points`, `backproject` :60, `project` :122, `compute_label`
:151), batched over the images in torch ops (no loop over B). The 48
floats of meta_data: K [0:9], K^-1 [9:18], pose_world2live [18:30],
pose_live2world [30:42], the voxel step [42:45], the voxel grid's origin
[45:48].

A float coordinate becomes an int32 index by XLA's rule (`xla_int32`):
NaN goes to 0 and values out of range saturate, where a plain cast gives
INT_MIN for all of them. So a voxel on the camera plane (0/0 = NaN) reads
pixel 0 as the JAX package's does.
"""

from __future__ import annotations

from typing import Tuple

import torch

_INT32_MIN, _INT32_MAX = -2.0 ** 31, 2.0 ** 31 - 1


def xla_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts: NaN to 0, +-inf and values past the
    range to INT32_MAX / INT32_MIN, the rest truncated toward zero."""
    x = torch.nan_to_num(x.double(), nan=0.0, posinf=_INT32_MAX, neginf=_INT32_MIN)
    return x.clamp(_INT32_MIN, _INT32_MAX).to(torch.int32)


def _meta_parts(meta: torch.Tensor):
    """meta (B,48) -> K (B,3,3), K^-1 (B,3,3), world2live (B,3,4),
    live2world (B,3,4), voxel step (B,3), voxel origin (B,3)."""
    B = meta.shape[0]
    return (meta[:, 0:9].reshape(B, 3, 3), meta[:, 9:18].reshape(B, 3, 3), meta[:, 18:30].reshape(B, 3, 4),
            meta[:, 30:42].reshape(B, 3, 4), meta[:, 42:45], meta[:, 45:48])


def _apply(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """p (B,...,3) @ M[:, :, :3]^T (+ M[:, :, 3] for a (B,3,4) M), each
    output the sum over j of p_j M_ij in order j = 0, 1, 2."""
    shape = (M.shape[0],) + (1,) * (p.dim() - 2) + (3,)
    out = p[..., 0:1] * M[:, :, 0].reshape(shape) + p[..., 1:2] * M[:, :, 1].reshape(shape) \
        + p[..., 2:3] * M[:, :, 2].reshape(shape)
    if M.shape[2] == 4:
        out = out + M[:, :, 3].reshape(shape)
    return out


def _pixel_rays(height: int, width: int, Kinv: torch.Tensor) -> torch.Tensor:
    """K^-1 (w, h, 1) of every pixel: (B,H,W,3)."""
    ws = torch.arange(width, dtype=torch.float32, device=Kinv.device)
    hs = torch.arange(height, dtype=torch.float32, device=Kinv.device)
    grid = torch.stack([ws[None, :].expand(height, width), hs[:, None].expand(height, width),
                        torch.ones((height, width), device=Kinv.device)], dim=-1)
    return _apply(Kinv, grid[None].expand(Kinv.shape[0], height, width, 3))


def _camera_points(depth: torch.Tensor, Kinv: torch.Tensor) -> torch.Tensor:
    """depth (B,H,W) -> camera-frame points depth * K^-1 (w, h, 1), (B,H,W,3)."""
    return depth[..., None] * _pixel_rays(depth.shape[1], depth.shape[2], Kinv)


def _gather_pixels(img: torch.Tensor, yc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """img (B,H,W[,C]) at the pixels (yc, xc) (B,...) -> (B,...[,C])."""
    B, H, W = img.shape[:3]
    flat = img.reshape(B, H * W, -1)
    lin = (yc.long() * W + xc.long()).reshape(B, -1)
    out = torch.gather(flat, 1, lin[..., None].expand(-1, -1, flat.shape[2]))
    out = out.reshape(yc.shape + flat.shape[2:])
    return out[..., 0] if img.dim() == 3 else out


def backproject(data: torch.Tensor, label: torch.Tensor, depth: torch.Tensor, meta_data: torch.Tensor,
                label_3d: torch.Tensor, grid_size: int, kernel_size: int,
                threshold: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """data (B,H,W,C), label (B,H,W,L), depth (B,H,W), meta_data (B,48),
    label_3d (B,G,G,G,L) -> (top_data (B,G,G,G,C), top_label (B,G,G,G,L),
    top_flag (B,G,G,G,1)).

    Each voxel (world X from d, Y from h, Z from w) goes through
    world2live and K to a pixel; over the (2k+1)^2 window around it
    (dx outer, dy inner), the pixels inside the image whose depth is within
    `threshold` of the voxel's camera z are averaged (data) and summed
    (label). A voxel no pixel matched keeps 0, its previous label, flag 0."""
    B, H, W, C = data.shape
    G = grid_size
    K, _, w2l, _, step, origin = _meta_parts(meta_data)
    g = torch.arange(G, dtype=torch.float32, device=data.device)
    X = (g[None, :] * step[:, 0:1] + origin[:, 0:1])[:, :, None, None].expand(B, G, G, G)
    Y = (g[None, :] * step[:, 1:2] + origin[:, 1:2])[:, None, :, None].expand(B, G, G, G)
    Z = (g[None, :] * step[:, 2:3] + origin[:, 2:3])[:, None, None, :].expand(B, G, G, G)
    live = _apply(w2l, torch.stack([X, Y, Z], dim=-1))
    pix = _apply(K, live)
    px = xla_int32(torch.round(pix[..., 0] / pix[..., 2]))
    py = xla_int32(torch.round(pix[..., 1] / pix[..., 2]))
    dvox = live[..., 2]
    acc = torch.zeros((B, G, G, G, C), dtype=data.dtype, device=data.device)
    acc_lab = torch.zeros((B, G, G, G, label.shape[-1]), dtype=label.dtype, device=data.device)
    count = torch.zeros((B, G, G, G), dtype=torch.float32, device=data.device)
    for dx in range(-kernel_size, kernel_size + 1):
        for dy in range(-kernel_size, kernel_size + 1):
            x, y = px + dx, py + dy
            inb = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            xc, yc = x.clamp(0, W - 1), y.clamp(0, H - 1)
            d = _gather_pixels(depth, yc, xc)
            m = ((torch.abs(d - dvox) < threshold) & inb).to(torch.float32)
            acc = acc + m[..., None] * _gather_pixels(data, yc, xc)
            acc_lab = acc_lab + m[..., None] * _gather_pixels(label, yc, xc)
            count = count + m
    has = (count > 0)[..., None]
    top_data = torch.where(has, acc / torch.clamp(count, min=1.0)[..., None], torch.zeros((), device=data.device))
    top_label = torch.where(has, acc_lab, label_3d)
    return top_data, top_label, has.to(torch.float32)


def project(data_3d: torch.Tensor, depth: torch.Tensor, meta_data: torch.Tensor, grid_size: int) -> torch.Tensor:
    """data_3d (B,G,G,G,C), depth (B,H,W) -> (B,H,W,C): each pixel's point
    (K^-1, its depth, live2world) read at its nearest voxel; 0 outside the
    grid."""
    B, G = data_3d.shape[0], grid_size
    _, Kinv, _, l2w, step, origin = _meta_parts(meta_data)
    world = _apply(l2w, _camera_points(depth, Kinv))
    o = origin[:, None, None, :]
    s = step[:, None, None, :]
    v = xla_int32(torch.round((world - o) / s))
    inb = ((v >= 0) & (v < G)).all(dim=-1)
    vc = v.clamp(0, G - 1).long()
    lin = ((vc[..., 0] * G + vc[..., 1]) * G + vc[..., 2]).reshape(B, -1)
    flat = data_3d.reshape(B, G ** 3, -1)
    out = torch.gather(flat, 1, lin[..., None].expand(-1, -1, flat.shape[2])).reshape(depth.shape + flat.shape[2:])
    return torch.where(inb[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def compute_label(data_3d: torch.Tensor, depth: torch.Tensor, meta_data: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(B,H,W) int32: the argmax class of the voxel under each pixel (0, the
    background, outside the grid; the first maximum on ties)."""
    return torch.argmax(project(data_3d, depth, meta_data, grid_size), dim=-1).to(torch.int32)
