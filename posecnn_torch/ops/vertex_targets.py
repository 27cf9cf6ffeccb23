"""Vertex targets built on the device, and the fused vertex loss.

Port of `posecnn_tpu/ops/vertex_targets.py`: from a small table of GT rows
[cls, cx, cy, z] per image, each labelled pixel gets the unit direction to
its object's projected centre and the log of the object's depth, with
`weight_value` on the 3 channels of its class. A pixel whose class has
several rows is routed to the nearest centre. Adaptation frames (label -1)
get zero targets and weights. `smooth_l1_loss_vertex_sparse3d` is the
VERTEX_REG_3D loss on the host's compact object-coordinate targets.
"""

from __future__ import annotations

import torch


def _nearest_rows(label: torch.Tensor, gt_centers: torch.Tensor):
    """label (B,H,W) int; gt_centers (B,G,4) rows [cls, cx, cy, z], zero
    padded. Returns e (B,H,W,3) = [cx, cy, z] of each pixel's nearest row of
    its class (the first on a tie) and found (B,H,W) bool."""
    B, H, W = label.shape
    cls = gt_centers[..., 0].to(torch.int64)  # (B,G)
    valid = cls > 0
    xs = torch.arange(W, dtype=torch.float32, device=label.device)
    ys = torch.arange(H, dtype=torch.float32, device=label.device)
    dx2 = (gt_centers[..., 1][:, :, None] - xs[None, None, :]) ** 2  # (B,G,W)
    dy2 = (gt_centers[..., 2][:, :, None] - ys[None, None, :]) ** 2  # (B,G,H)
    d2 = dy2[:, :, :, None] + dx2[:, :, None, :]  # (B,G,H,W)
    match = (cls[:, :, None, None] == label[:, None, :, :].long()) & valid[:, :, None, None]
    score = torch.where(match, d2, torch.full((), float("inf"), device=label.device))
    g = torch.argmin(score, dim=1)  # (B,H,W), the first minimum
    found = match.any(dim=1)
    rows = gt_centers[..., 1:4]  # (B,G,3)
    e = torch.gather(rows, 1, g.reshape(B, H * W, 1).expand(B, H * W, 3)).reshape(B, H, W, 3)
    return e, found


def _direction_targets(label: torch.Tensor, gt_centers: torch.Tensor):
    """(t3 (B,H,W,3) = [dx/n, dy/n, log z], found (B,H,W))."""
    B, H, W = label.shape
    e, found = _nearest_rows(label, gt_centers)
    xs = torch.arange(W, dtype=torch.float32, device=label.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=label.device)[None, :, None]
    dx = e[..., 0] - xs
    dy = e[..., 1] - ys
    n = torch.sqrt(dx * dx + dy * dy) + 1e-10
    logz = torch.log(torch.clamp(e[..., 2], min=1e-10))
    return torch.stack([dx / n, dy / n, logz], dim=-1), found


def vertex_targets_device(label: torch.Tensor, gt_centers: torch.Tensor, num_classes: int, weight_value: float = 10.0):
    """label (B,H,W) int; gt_centers (B,G,4). Returns (targets, weights),
    each (B,H,W,3C) float32 (`vertex_targets.py:129`)."""
    B, H, W = label.shape
    C = num_classes
    t3, found = _direction_targets(label, gt_centers)
    fg = (label > 0) & found
    onehot = torch.nn.functional.one_hot(torch.where(fg, label.long(), 0), C).float() * fg[..., None]
    targets = (onehot[..., None] * t3[..., None, :]).reshape(B, H, W, 3 * C)
    weights = torch.repeat_interleave(onehot, 3, dim=-1) * weight_value
    return targets, weights


def smooth_l1_loss_vertex_sparse(
    vertex_pred: torch.Tensor,
    label: torch.Tensor,
    gt_centers: torch.Tensor,
    num_classes: int,
    weight_value: float = 10.0,
    sigma: float = 1.0,
    z_obj_norm: bool = False,
    total=None,
) -> torch.Tensor:
    """Fused target generation + smooth-L1 (`vertex_targets.py:52`): only
    the 3 channels of each pixel's class enter, and the (B,H,W,3C) target
    and weight maps are never built. The L1/L2 switch is detached, as JAX's
    stop_gradient is.

    z_obj_norm (TPU.VERTEX_Z_OBJ_NORM, `vertex_targets.py:94-126`): each
    pixel's log-z weight is scaled by the mean foreground pixel count of
    the batch's (image, class) instances over its own instance's count,
    clipped to [0.2, 5], so every instance weighs about the same in the
    depth channel; the loss is then normalised by the sum of the three
    channels' weights.

    `total` maps a local count to the global batch's (a data-parallel
    step: the sum over the data group); the mean instance count and the
    normalizer are then the global batch's."""
    total = (lambda x: x) if total is None else total
    B, H, W = label.shape
    C = num_classes
    sigma_2 = sigma ** 2
    t3, found = _direction_targets(label, gt_centers)
    lab_safe = label.long().clamp(0, C - 1)
    fg = (label > 0) & found
    w = torch.where(fg, torch.tensor(weight_value, dtype=torch.float32, device=label.device), 0.0)
    pred5 = vertex_pred.reshape(B, H, W, C, 3)
    pred3 = torch.gather(pred5, 3, lab_safe[..., None, None].expand(B, H, W, 1, 3))[..., 0, :]
    if z_obj_norm:
        onehot = torch.nn.functional.one_hot(lab_safe, C).float() * fg[..., None]
        cnt = onehot.sum(dim=(1, 2))  # (B,C) foreground pixels of each instance
        n_inst = total((cnt > 0).sum().float())
        mean_cnt = total(cnt.sum()) / torch.clamp(n_inst, min=1.0)
        cnt_pix = torch.gather(cnt, 1, lab_safe.reshape(B, H * W)).reshape(B, H, W)
        factor = torch.clamp(mean_cnt / torch.clamp(cnt_pix, min=1.0), 0.2, 5.0)
        wv = torch.stack([w, w, w * factor], dim=-1)
    else:
        wv = w[..., None]
    diff = wv * (pred3.float() - t3)
    abs_diff = diff.abs()
    sign = (abs_diff < 1.0 / sigma_2).to(diff.dtype).detach()
    in_loss = diff * diff * (sigma_2 / 2.0) * sign + (abs_diff - 0.5 / sigma_2) * (1.0 - sign)
    if z_obj_norm:
        return in_loss.sum() / (total(wv.sum()) + 1e-10)
    return in_loss.sum() / (3.0 * total(w.sum()) + 1e-10)


def smooth_l1_loss_vertex_sparse3d(
    vertex_pred: torch.Tensor,
    label: torch.Tensor,
    targets3: torch.Tensor,
    weights3: torch.Tensor,
    num_classes: int,
    sigma: float = 1.0,
    total=None,
) -> torch.Tensor:
    """The VERTEX_REG_3D loss on compact host targets
    (`vertex_targets.py:smooth_l1_loss_vertex_sparse3d` :158): targets3
    (B,H,W,3) holds each pixel's extent-normalized object coordinates,
    weights3 (B,H,W) its weight; the prediction's 3 channels of the pixel's
    class (label clipped to [0, C-1]) enter the smooth L1, normalised by
    3 * sum(weights3) (of the global batch with `total`, as above)."""
    B, H, W = label.shape
    C = num_classes
    sigma_2 = sigma ** 2
    lab_safe = label.long().clamp(0, C - 1)
    pred5 = vertex_pred.reshape(B, H, W, C, 3)
    pred3 = torch.gather(pred5, 3, lab_safe[..., None, None].expand(B, H, W, 1, 3))[..., 0, :]
    w = weights3.float()
    diff = w[..., None] * (pred3.float() - targets3)
    abs_diff = diff.abs()
    sign = (abs_diff < 1.0 / sigma_2).to(diff.dtype).detach()
    in_loss = diff * diff * (sigma_2 / 2.0) * sign + (abs_diff - 0.5 / sigma_2) * (1.0 - sign)
    count = w.sum() if total is None else total(w.sum())
    return in_loss.sum() / (3.0 * count + 1e-10)
