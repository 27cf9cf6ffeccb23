"""Pose refinement against measured depth: ICP as batched Gauss-Newton.

Port of `posecnn_tpu/engine/refine.py`. JAX vmaps one detection's
refinement over the padded detection rows; here every function takes the
rows as a leading batch dimension and the whole frame runs in one pass of
torch ops:

  * the target cloud of a detection is the measured depth backprojected at
    the pixels the network labeled with its class, sampled at a stride
    that rounds up (`sample_object_cloud`);
  * each iteration moves the model points by the current pose, matches
    each to its nearest target point (|s|^2 + |t|^2 - 2 s.t, one product a
    row), Huber-weights the residuals and solves the 6-dof point-to-point
    normal equations, plus the point-to-plane term when `plane_weight` > 0;
  * `refine_translation` is the depth-median translation fix that comes
    before ICP (the reference's `poses_new`).

Products must run in full float32: TF32 (`engine.test.set_float32_precision`
turns it off) moves the nearest-neighbour argmin near ties.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from posecnn_torch.ops.normals import compute_normals
from posecnn_torch.utils.quaternion import mat2quat, quat2mat


def sample_object_cloud(depth: torch.Tensor, label: torch.Tensor, cls: torch.Tensor, fx, fy, px, py,
                        max_points: int = 512) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backproject up to max_points depth pixels of each class in `cls`
    (R,). Returns points (R,M,3), valid (R,M) and the flat pixel index
    (R,M) of each point (0 in invalid slots, whose points are 0).

    The pixels of class c with depth > 0 are taken in row-major order at a
    stride of ceil(count / M), so the sample spans the whole object; the
    first M taken fill the slots in order (`engine/refine.py:31-74`)."""
    H, W = depth.shape
    M = max_points
    flat_d = depth.reshape(-1)
    m = (label.reshape(1, -1) == cls.reshape(-1, 1)) & (flat_d > 0)[None, :]  # (R, HW)
    cnt = torch.cumsum(m, dim=1, dtype=torch.int32)
    total = torch.clamp(cnt[:, -1:], min=1)
    stride = torch.clamp((total + M - 1) // M, min=1)
    take = m & ((cnt - 1) % stride == 0)
    ctake = torch.cumsum(take, dim=1, dtype=torch.int32)
    # the slot of a taken pixel is its rank among the taken (srank); the
    # pixel in slot k is where min(ctake, M) first reaches k + 1
    slots = torch.arange(1, M + 1, dtype=torch.int32, device=depth.device).expand(cls.shape[0], M).contiguous()
    pos = torch.searchsorted(torch.clamp(ctake, max=M), slots)
    valid = torch.arange(M, device=depth.device)[None, :] < torch.clamp(ctake[:, -1:], max=M)
    idx = torch.where(valid, pos, torch.zeros((), dtype=pos.dtype, device=pos.device))
    x = (idx % W).to(torch.float32)
    y = (idx // W).to(torch.float32)
    z = flat_d[idx]
    pts = torch.stack([(x - px) / fx * z, (y - py) / fy * z, z], dim=-1)
    pts = torch.where(valid[..., None], pts, torch.zeros((), dtype=pts.dtype, device=pts.device))
    return pts, valid, idx


def _nearest(src: torch.Tensor, tgt: torch.Tensor, tgt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each src point (R,P,3), the index and squared distance of its
    nearest valid tgt point (R,T,3); the first index on a tie. All-invalid
    rows give index 0 at distance inf."""
    d2 = ((src * src).sum(dim=-1)[:, :, None] + (tgt * tgt).sum(dim=-1)[:, None, :]
          - torch.bmm(2.0 * src, tgt.transpose(1, 2)))
    d2 = torch.where(tgt_valid[:, None, :], d2, torch.full((), float("inf"), dtype=d2.dtype, device=d2.device))
    j = torch.argmin(d2, dim=-1)
    return j, torch.gather(d2, 2, j[..., None])[..., 0]


def _skew(k: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(k[..., 0])
    return torch.stack([
        torch.stack([z, -k[..., 2], k[..., 1]], dim=-1),
        torch.stack([k[..., 2], z, -k[..., 0]], dim=-1),
        torch.stack([-k[..., 1], k[..., 0], z], dim=-1),
    ], dim=-2)


def icp_refine(
    quat: torch.Tensor,
    trans: torch.Tensor,
    model_points: torch.Tensor,
    target_points: torch.Tensor,
    target_valid: torch.Tensor,
    iters: int = 20,
    huber_delta: float = 0.01,
    damping: float = 1e-6,
    target_normals: Optional[torch.Tensor] = None,
    plane_weight: float = 0.0,
    model_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine R poses at once: quat (R,4) wxyz, trans (R,3), model_points
    (R,P,3), target_points (R,T,3) and target_valid (R,T) in the camera
    frame. Returns the refined (quat (R,4), trans (R,3)). model_valid (R,P)
    takes padded or invalid model points out of the solve.

    target_normals (R,T,3) with plane_weight > 0 add the point-to-plane
    energy n . (src - tgt), Huber-weighted and gated like the point term
    (`engine/refine.py:icp_refine`)."""
    Rm = quat2mat(quat, normalize=True)
    t = trans
    eye3 = torch.eye(3, dtype=quat.dtype, device=quat.device)
    eye6 = torch.eye(6, dtype=quat.dtype, device=quat.device)
    for _ in range(iters):
        src = torch.bmm(model_points, Rm.transpose(1, 2)) + t[:, None, :]  # (R,P,3)
        j, d2 = _nearest(src, target_points, target_valid)
        tgt = torch.gather(target_points, 1, j[..., None].expand(-1, -1, 3))
        r = torch.sqrt(torch.clamp(d2, min=1e-12))
        w = torch.where(r <= huber_delta, torch.ones_like(r), huber_delta / r)  # Huber IRLS
        w = torch.where(torch.isfinite(d2), w, torch.zeros_like(w))
        if model_valid is not None:
            w = w * model_valid.to(w.dtype)
        # point-to-point Gauss-Newton on xi = (omega, v): J = [-[src]x | I]
        e = src - tgt
        sx, sy, sz = src[..., 0], src[..., 1], src[..., 2]
        zeros = torch.zeros_like(sx)
        Jw = torch.stack([
            torch.stack([zeros, sz, -sy], dim=-1),
            torch.stack([-sz, zeros, sx], dim=-1),
            torch.stack([sy, -sx, zeros], dim=-1),
        ], dim=-2)  # (R,P,3,3): d(residual)/d(omega)
        J = torch.cat([Jw, eye3.expand_as(Jw)], dim=-1)  # (R,P,3,6)
        JW = J * w[..., None, None]
        H = torch.einsum("rpij,rpik->rjk", JW, J)
        g = torch.einsum("rpij,rpi->rj", JW, e)
        if target_normals is not None and plane_weight > 0:
            n = torch.gather(target_normals, 1, j[..., None].expand(-1, -1, 3))  # normal at the match
            n_ok = (n * n).sum(dim=-1) > 0.5  # a zero normal is an invalid pixel
            r_pl = (n * e).sum(dim=-1)  # signed plane distance
            a = torch.abs(r_pl)
            w_pl = torch.where(a <= huber_delta, torch.ones_like(a), huber_delta / torch.clamp(a, min=1e-12))
            w_pl = w_pl * w * n_ok.to(w.dtype)
            Jp = torch.einsum("rpi,rpij->rpj", n, J)
            JpW = Jp * (plane_weight * w_pl)[..., None]
            H = H + torch.einsum("rpj,rpk->rjk", JpW, Jp)
            g = g + torch.einsum("rpj,rp->rj", JpW, r_pl)
        dx = -torch.linalg.solve_ex(H + damping * eye6, g)[0]  # no error check: no host sync
        omega, v = dx[:, :3], dx[:, 3:]
        # exponential map (Rodrigues)
        theta = torch.linalg.vector_norm(omega, dim=-1) + 1e-12
        K = _skew(omega / theta[:, None])
        s, c = torch.sin(theta)[:, None, None], (1 - torch.cos(theta))[:, None, None]
        dR = eye3 + s * K + c * torch.bmm(K, K)
        Rm = torch.bmm(dR, Rm)
        t = torch.bmm(dR, t[..., None])[..., 0] + v
    return mat2quat(Rm), t


def refine_translation(trans: torch.Tensor, target_points: torch.Tensor, target_valid: torch.Tensor) -> torch.Tensor:
    """Scale each translation (R,3) along its viewing ray so its depth is
    the median depth of the detection's valid target points (R,T,3), with
    `jnp.nanmedian`'s rule: the mean of the two middle values for an even
    count. A row with no valid point keeps its translation."""
    T = target_points.shape[1]
    z = torch.where(target_valid, target_points[..., 2],
                    torch.full((), float("inf"), dtype=target_points.dtype, device=target_points.device))
    zs = torch.sort(z, dim=1).values
    q = 0.5 * (target_valid.sum(dim=1).to(z.dtype) - 1)
    lo, hi = torch.floor(q), torch.ceil(q)
    hw = q - lo
    lo_v = torch.gather(zs, 1, torch.clamp(lo, 0, T - 1).long()[:, None])[:, 0]
    hi_v = torch.gather(zs, 1, torch.clamp(hi, 0, T - 1).long()[:, None])[:, 0]
    z_med = lo_v * (1 - hw) + hi_v * hw
    z_med = torch.where(torch.isfinite(z_med), z_med, trans[:, 2])
    return trans * (z_med / torch.clamp(trans[:, 2], min=1e-6))[:, None]


def icp_refine_detections(
    rois: torch.Tensor,
    poses: torch.Tensor,
    depth: torch.Tensor,
    label: torch.Tensor,
    points_all: torch.Tensor,
    meta: torch.Tensor,
    iters: int = 20,
    max_points: int = 512,
    plane_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """rois (R,7), poses (R,7) [quat | t], depth and label (H,W),
    points_all (C,P,3), meta (48,). Returns (the ICP poses (R,7), the
    depth-median translations (R,3)). A row keeps its pose unless its class
    is > 0 and more than 16 target points are valid. plane_weight > 0 adds
    the point-to-plane energy on normals of the measured depth."""
    fx, px, fy, py = meta[0], meta[2], meta[4], meta[5]
    cls = rois[:, 1].to(torch.int64)
    tgt, tv, idx = sample_object_cloud(depth, label, cls, fx, fy, px, py, max_points)
    tn = None
    if plane_weight > 0:
        tn = compute_normals(depth, fx, fy, px, py).reshape(-1, 3)[idx]
    t_new = refine_translation(poses[:, 4:7], tgt, tv)
    q, t = icp_refine(poses[:, :4], t_new, points_all[cls], tgt, tv, iters=iters, target_normals=tn,
                      plane_weight=plane_weight)
    ok = ((tv.sum(dim=1) > 16) & (rois[:, 1] > 0))[:, None]
    return torch.cat([torch.where(ok, q, poses[:, :4]), torch.where(ok, t, poses[:, 4:7])], dim=1), t_new
