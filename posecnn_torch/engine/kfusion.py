"""TSDF fusion ("KinectFusion") on the card.

Port of `posecnn_tpu/engine/kfusion.py` in torch ops with fixed shapes (no
host round trip but `KinectFusion.solve_pose`'s test for a first frame):
the volume is a dense (G,G,G) truncated signed distance and weight grid,
with an optional (G,G,G,C) class-probability grid.

  * `bilateral_filter`: the depth smoothed over a (2r+1)^2 window, weights
    exp(-(dx^2+dy^2)/2 sigma_s^2) exp(-(d'-d)^2/2 sigma_d^2) over pixels
    with depth; the window wraps around the image's edges, as JAX's
    `jnp.roll` does;
  * `fuse_depth`: each voxel projected into the frame (world2cam, K), the
    projective TSDF update clipped at the truncation, the weight capped at
    `max_weight`, the class probabilities averaged alike;
  * `raycast`: `max_steps` sphere-tracing steps a pixel from `near`, the
    first sign change a hit;
  * `solve_pose`: ICP odometry (`engine.refine.icp_refine`) of the frame's
    subsampled points against the volume's surface voxels;
  * `extract_surface`: the voxels with |sdf| < thresh and weight > 0, the
    first `max_points` in flat (d, h, w) order; `marching_tetrahedra`: the
    mesh of the zero level set, 6 tetrahedra a cube around its 0-7
    diagonal, 16 sign cases of up to 2 triangles, the first `max_cells`
    active cells in flat order;
  * `KinectFusion`: the stateful wrapper of the reference's kfusion.pyx
    (feed_data, feed_label, solve_pose, fuse_depth, extract_surface,
    extract_mesh, render, back_project).

A float voxel or pixel coordinate becomes an index by XLA's rule
(`ops.backproject.xla_int32`: NaN to 0, saturating), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from posecnn_torch.ops.backproject import xla_int32


@dataclass
class TSDFVolume:
    sdf: torch.Tensor        # (G,G,G) truncated signed distance
    weight: torch.Tensor     # (G,G,G)
    origin: torch.Tensor     # (3,) world coordinates of voxel (0,0,0)
    voxel_size: float
    truncation: float
    class_prob: Optional[torch.Tensor] = None  # (G,G,G,C)

    @property
    def grid_size(self) -> int:
        return self.sdf.shape[0]


def create_volume(grid_size: int, origin, voxel_size: float, truncation: Optional[float] = None,
                  num_classes: Optional[int] = None, device=None) -> TSDFVolume:
    """An empty volume: sdf 1, weight 0, truncation 5 voxels unless given."""
    G = grid_size
    cp = torch.zeros((G, G, G, num_classes), dtype=torch.float32, device=device) if num_classes else None
    return TSDFVolume(sdf=torch.ones((G, G, G), dtype=torch.float32, device=device),
                      weight=torch.zeros((G, G, G), dtype=torch.float32, device=device),
                      origin=torch.as_tensor(np.asarray(origin, np.float32), device=device),
                      voxel_size=float(voxel_size),
                      truncation=float(truncation if truncation is not None else 5.0 * voxel_size), class_prob=cp)


def se3_inverse(RT: torch.Tensor) -> torch.Tensor:
    """[R|t] (3,4) -> [R^T | -R^T t]."""
    Rt = RT[:, :3].T
    return torch.cat([Rt, -(Rt @ RT[:, 3:4])], dim=1)


def bilateral_filter(depth: torch.Tensor, radius: int = 2, sigma_space: float = 1.5,
                     sigma_depth: float = 0.03) -> torch.Tensor:
    """Edge-preserving smoothing of a depth map (H,W) in metres; a pixel
    without depth keeps its 0."""
    acc = torch.zeros_like(depth)
    norm = torch.zeros_like(depth)
    valid = depth > 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = torch.roll(depth, (dy, dx), dims=(0, 1))
            v = torch.roll(valid, (dy, dx), dims=(0, 1))
            w_s = float(np.exp(-(dx * dx + dy * dy) / (2 * sigma_space ** 2)))
            w = w_s * torch.exp(-torch.square(shifted - depth) / (2 * sigma_depth ** 2)) * v
            acc = acc + w * shifted
            norm = norm + w
    return torch.where(valid & (norm > 0), acc / torch.clamp(norm, min=1e-9), depth)


def _voxel_world_coords(vol: TSDFVolume) -> torch.Tensor:
    """(G,G,G,3) world coordinates of the voxels (x from d, y from h, z from w)."""
    G = vol.grid_size
    g = torch.arange(G, dtype=torch.float32, device=vol.sdf.device)
    X = (vol.origin[0] + g * vol.voxel_size)[:, None, None].expand(G, G, G)
    Y = (vol.origin[1] + g * vol.voxel_size)[None, :, None].expand(G, G, G)
    Z = (vol.origin[2] + g * vol.voxel_size)[None, None, :].expand(G, G, G)
    return torch.stack([X, Y, Z], dim=-1)


def _rigid(RT: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """p (...,3) @ R^T + t, each output summed over j = 0, 1, 2 in order."""
    return p[..., 0:1] * RT[:, 0] + p[..., 1:2] * RT[:, 1] + p[..., 2:3] * RT[:, 2] + RT[:, 3]


def fuse_depth(vol: TSDFVolume, depth: torch.Tensor, K: torch.Tensor, world2cam: torch.Tensor,
               max_weight: float = 64.0, label_prob: Optional[torch.Tensor] = None) -> TSDFVolume:
    """Integrate one depth frame (H,W), and per-pixel class probabilities
    (H,W,C) where the volume has a class grid, into the volume."""
    H, W = depth.shape
    cam = _rigid(world2cam, _voxel_world_coords(vol))
    z = cam[..., 2]
    u = K[0, 0] * cam[..., 0] / z + K[0, 2]
    v = K[1, 1] * cam[..., 1] / z + K[1, 2]
    ui, vi = xla_int32(torch.round(u)), xla_int32(torch.round(v))
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z > 0)
    lin = vi.clamp(0, H - 1).long() * W + ui.clamp(0, W - 1).long()
    d = depth.reshape(-1)[lin]
    sdf_new = d - z  # positive in front of the surface
    upd = inb & (d > 0) & (sdf_new > -vol.truncation)
    tsdf_new = torch.clamp(sdf_new / vol.truncation, -1.0, 1.0)
    w_old = vol.weight
    w_new = torch.where(upd, torch.clamp(w_old + 1.0, max=max_weight), w_old)
    denom = torch.clamp(w_old + 1.0, min=1.0)
    sdf = torch.where(upd, (vol.sdf * w_old + tsdf_new) / denom, vol.sdf)
    cp = vol.class_prob
    if cp is not None and label_prob is not None:
        probs = label_prob.reshape(H * W, -1)[lin]  # (G,G,G,C)
        cp = torch.where(upd[..., None], (cp * w_old[..., None] + probs) / denom[..., None], cp)
    return TSDFVolume(sdf, w_new, vol.origin, vol.voxel_size, vol.truncation, cp)


def raycast(vol: TSDFVolume, K: torch.Tensor, cam2world: torch.Tensor, height: int, width: int,
            step_scale: float = 0.75, max_steps: int = 192, near: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depth map (H,W) and hit mask the volume shows the camera
    cam2world, by sphere tracing its TSDF."""
    dev = vol.sdf.device
    Kinv = torch.linalg.inv(K)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    grid = torch.stack([xs[None, :].expand(height, width), ys[:, None].expand(height, width),
                        torch.ones((height, width), device=dev)], dim=-1)
    rays_cam = _rigid(torch.cat([Kinv, torch.zeros((3, 1), device=dev)], dim=1), grid)
    rays_cam = rays_cam / torch.linalg.vector_norm(rays_cam, dim=-1, keepdim=True)
    rays_w = _rigid(torch.cat([cam2world[:, :3], torch.zeros((3, 1), device=dev)], dim=1), rays_cam)
    origin_w = cam2world[:, 3]
    G = vol.grid_size
    step = vol.truncation * step_scale
    sdf_flat, w_flat = vol.sdf.reshape(-1), vol.weight.reshape(-1)

    def sample_sdf(p):
        gidx = (p - vol.origin) / vol.voxel_size
        gi = xla_int32(torch.round(gidx)).clamp(0, G - 1).long()
        inside = ((gidx >= 0) & (gidx <= G - 1)).all(dim=-1)
        lin = (gi[..., 0] * G + gi[..., 1]) * G + gi[..., 2]
        return torch.where(inside & (w_flat[lin] > 0), sdf_flat[lin], torch.ones((), device=dev))

    dist = torch.full((height, width), near, dtype=torch.float32, device=dev)
    hit = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for _ in range(max_steps):
        s = sample_sdf(origin_w + rays_w * dist[..., None])
        hit = hit | ((s < 0) & ~hit)
        dist = torch.where(hit, dist, dist + torch.clamp(s, min=0.1) * step / torch.clamp(torch.abs(s), min=0.1))
    return torch.where(hit, dist * rays_cam[..., 2], torch.zeros((), device=dev)), hit


def _compact(flag: torch.Tensor, n_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat indices of the first `n_max` set entries of `flag` (1-D), in
    order, 0 in the slots past their count; and the slots' validity."""
    rank = torch.cumsum(flag.to(torch.int64), dim=0) - 1
    dest = torch.where(flag & (rank < n_max), rank, torch.full_like(rank, n_max))
    idx = torch.zeros(n_max + 1, dtype=torch.int64, device=flag.device)
    idx.scatter_(0, torch.where(dest < n_max, dest, torch.full_like(dest, n_max)),
                 torch.where(dest < n_max, torch.arange(flag.numel(), device=flag.device), torch.zeros_like(dest)))
    n = torch.clamp(flag.sum(), max=n_max)
    return idx[:n_max], torch.arange(n_max, device=flag.device) < n


def extract_surface(vol: TSDFVolume, max_points: int = 4096, thresh: float = 0.25):
    """The voxels near the zero level set: (points (N,3), valid (N,),
    labels (N,) the argmax class where there is a class grid, else 0);
    zeros in the invalid slots."""
    G = vol.grid_size
    idx, valid = _compact(((torch.abs(vol.sdf) < thresh) & (vol.weight > 0)).reshape(-1), max_points)
    gi = torch.stack([idx // (G * G), (idx // G) % G, idx % G], dim=-1)
    pts = vol.origin + gi.to(torch.float32) * vol.voxel_size
    if vol.class_prob is not None:
        labels = torch.argmax(vol.class_prob.reshape(-1, vol.class_prob.shape[-1])[idx], dim=-1).to(torch.int32)
    else:
        labels = torch.zeros((max_points,), dtype=torch.int32, device=idx.device)
    zero = torch.zeros((), device=pts.device)
    return torch.where(valid[:, None], pts, zero), valid, torch.where(valid, labels, torch.zeros_like(labels))


def solve_pose(vol: TSDFVolume, depth: torch.Tensor, K: torch.Tensor, world2cam_init: torch.Tensor, iters: int = 10,
               max_points: int = 2048) -> torch.Tensor:
    """ICP odometry: world2cam (3,4) aligning the frame's points (a stride
    of its pixels, ~max_points of them; no-depth pixels out of the solve)
    to the volume's surface voxels, from `world2cam_init`."""
    from posecnn_torch.engine.refine import icp_refine
    from posecnn_torch.utils.quaternion import mat2quat, quat2mat

    H, W = depth.shape
    stride = max(1, int(np.sqrt(H * W / max_points)))
    d = depth[::stride, ::stride]
    hh, ww = d.shape
    xs = torch.arange(0, W, stride, dtype=torch.float32, device=depth.device)[:ww]
    ys = torch.arange(0, H, stride, dtype=torch.float32, device=depth.device)[:hh]
    Xc = (xs[None, :] - K[0, 2]) / K[0, 0] * d
    Yc = (ys[:, None] - K[1, 2]) / K[1, 1] * d
    pts_cam = torch.stack([Xc, Yc, d], dim=-1).reshape(-1, 3)
    valid = pts_cam[:, 2] > 0  # depth holes would pull the pose toward the origin
    surf_pts, surf_valid, _ = extract_surface(vol, max_points=max_points)
    cam2world = se3_inverse(world2cam_init)
    q, t = icp_refine(mat2quat(cam2world[:, :3])[None], cam2world[:, 3][None], pts_cam[None], surf_pts[None],
                      surf_valid[None], iters=iters, huber_delta=2.0 * vol.voxel_size, model_valid=valid[None])
    return se3_inverse(torch.cat([quat2mat(q[0]), t[0][:, None]], dim=1))


# marching tetrahedra: cube corners (bit 0 = x, bit 1 = y, bit 2 = z), the 6
# tetrahedra around the 0-7 diagonal, a tetrahedron's 6 edges as vertex
# pairs, and each of its 16 sign cases' triangles (bit i set = vertex i
# inside) as edge ids, -1 for none (`kfusion.py:244-279`)
_CUBE_OFFSETS = np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int64)
_TETS = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], np.int64)
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)
_TET_TRIS = np.array([
    [-1, -1, -1, -1, -1, -1], [0, 1, 2, -1, -1, -1], [0, 3, 4, -1, -1, -1], [1, 2, 4, 1, 4, 3],
    [1, 3, 5, -1, -1, -1], [0, 2, 5, 0, 5, 3], [0, 4, 5, 0, 5, 1], [2, 5, 4, -1, -1, -1],
    [2, 4, 5, -1, -1, -1], [0, 1, 5, 0, 5, 4], [0, 3, 5, 0, 5, 2], [1, 5, 3, -1, -1, -1],
    [1, 3, 4, 1, 4, 2], [0, 4, 3, -1, -1, -1], [0, 2, 1, -1, -1, -1], [-1, -1, -1, -1, -1, -1],
], np.int64)


def marching_tetrahedra(vol: TSDFVolume, max_cells: int = 8192):
    """The triangle mesh of the TSDF's zero level set: (triangles
    (max_cells*12, 3, 3) world vertices, valid (max_cells*12,), labels
    (max_cells*12,) the class of each triangle's cell). A cell is active
    where all 8 corners are observed and their signs differ; a grid value
    of exactly 0 counts as 1e-6 outside; slivers (area^2 <= (1e-4
    voxel^2)^2) are dropped."""
    G = vol.grid_size
    dev = vol.sdf.device
    offs = torch.as_tensor(_CUBE_OFFSETS, device=dev)

    def corners(a):
        return torch.stack([a[o[0]:G - 1 + o[0], o[1]:G - 1 + o[1], o[2]:G - 1 + o[2]] for o in _CUBE_OFFSETS], dim=-1)

    sdf = torch.where(vol.sdf == 0.0, torch.full((), 1e-6, device=dev), vol.sdf)
    c_sdf = corners(sdf)
    inside = c_sdf < 0
    active = corners(vol.weight > 0).all(dim=-1) & inside.any(dim=-1) & (~inside).any(dim=-1)
    g = G - 1
    cell_idx, cell_valid = _compact(active.reshape(-1), max_cells)
    ci = torch.stack([cell_idx // (g * g), (cell_idx // g) % g, cell_idx % g], dim=-1)  # (M,3)
    corner_pos = vol.origin + (ci[:, None, :] + offs[None]).to(torch.float32) * vol.voxel_size  # (M,8,3)
    corner_sdf = c_sdf.reshape(-1, 8)[cell_idx]  # (M,8)
    tets = torch.as_tensor(_TETS, device=dev)
    t_sdf, t_pos = corner_sdf[:, tets], corner_pos[:, tets, :]  # (M,6,4), (M,6,4,3)
    bits = (t_sdf < 0).to(torch.int64)
    case = bits[..., 0] + 2 * bits[..., 1] + 4 * bits[..., 2] + 8 * bits[..., 3]  # (M,6)
    ev = torch.as_tensor(_TET_EDGES, device=dev)
    sa, sb = t_sdf[..., ev[:, 0]], t_sdf[..., ev[:, 1]]  # (M,6,6)
    pa, pb = t_pos[..., ev[:, 0], :], t_pos[..., ev[:, 1], :]
    denom = sa - sb
    t = torch.where(torch.abs(denom) > 1e-12, sa / torch.where(denom == 0, torch.ones_like(denom), denom),
                    torch.full((), 0.5, device=dev))
    edge_pt = pa + torch.clamp(t, 0.0, 1.0)[..., None] * (pb - pa)  # (M,6,6,3)
    M = case.shape[0]
    tri_edges = torch.as_tensor(_TET_TRIS, device=dev)[case].reshape(M, 6, 2, 3)
    tri_ok = (tri_edges >= 0).all(dim=-1) & cell_valid[:, None, None]
    safe = torch.clamp(tri_edges, min=0)  # (M,6,2,3)
    tris = torch.gather(edge_pt[:, :, None, :, :].expand(M, 6, 2, 6, 3), 3,
                        safe[..., None].expand(M, 6, 2, 3, 3))  # (M,6,2,3,3)
    tris = tris.reshape(M * 12, 3, 3)
    n2 = torch.linalg.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    tri_valid = tri_ok.reshape(M * 12) & ((n2 * n2).sum(dim=-1) > (1e-4 * vol.voxel_size ** 2) ** 2)
    if vol.class_prob is not None:
        cell_flat = (ci[:, 0] * G + ci[:, 1]) * G + ci[:, 2]
        cls = torch.argmax(vol.class_prob.reshape(-1, vol.class_prob.shape[-1])[cell_flat], dim=-1).to(torch.int32)
    else:
        cls = torch.zeros((M,), dtype=torch.int32, device=dev)
    labels = torch.repeat_interleave(cls, 12)
    tris = torch.where(tri_valid[:, None, None], tris, torch.zeros((), device=dev))
    return tris, tri_valid, torch.where(tri_valid, labels, torch.zeros_like(labels))


class KinectFusion:
    """The reference's kfusion.pyx API over one volume on `device`."""

    def __init__(self, grid_size: int = 128, origin=(-1.5, -1.5, 0.0), voxel_size: float = 0.02,
                 num_classes: Optional[int] = None, device=None):
        self.device = torch.device("cuda" if device is None else device)
        self.vol = create_volume(grid_size, origin, voxel_size, num_classes=num_classes, device=self.device)
        self.world2cam = torch.cat([torch.eye(3), torch.zeros((3, 1))], dim=1).to(self.device)
        self._depth = None
        self._label_prob = None

    def feed_data(self, depth: np.ndarray, K: np.ndarray):
        """A frame's depth in metres (H,W), bilateral-filtered, and its K."""
        self.K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        self._depth = bilateral_filter(torch.as_tensor(np.asarray(depth, np.float32), device=self.device))

    def feed_label(self, label_prob):
        """The frame's class probabilities (H,W,C), fused with its depth."""
        self._label_prob = torch.as_tensor(label_prob, dtype=torch.float32, device=self.device)

    def solve_pose(self, iters: int = 10) -> np.ndarray:
        """Track the camera against the volume (the identity on an empty one)."""
        if float(self.vol.weight.sum()) > 0:
            self.world2cam = solve_pose(self.vol, self._depth, self.K, self.world2cam, iters=iters)
        return self.world2cam.cpu().numpy()

    def fuse_depth(self):
        self.vol = fuse_depth(self.vol, self._depth, self.K, self.world2cam, label_prob=self._label_prob)

    def extract_surface(self, max_points: int = 4096):
        pts, valid, labels = extract_surface(self.vol, max_points=max_points)
        v = valid.cpu().numpy()
        return pts.cpu().numpy()[v], labels.cpu().numpy()[v]

    def extract_mesh(self, max_cells: int = 8192):
        """Triangle mesh (marching tetrahedra): (tris (T,3,3), labels (T,))."""
        tris, valid, labels = marching_tetrahedra(self.vol, max_cells=max_cells)
        v = valid.cpu().numpy()
        return tris.cpu().numpy()[v], labels.cpu().numpy()[v]

    def render(self, height: int, width: int):
        depth, hit = raycast(self.vol, self.K, se3_inverse(self.world2cam), height, width)
        return depth.cpu().numpy(), hit.cpu().numpy()

    def back_project(self) -> np.ndarray:
        """The filtered depth's camera-frame points (H,W,3)."""
        from posecnn_torch.ops.normals import backproject_depth

        K = self.K
        return backproject_depth(self._depth, K[0, 0], K[1, 1], K[0, 2], K[1, 2]).cpu().numpy()
