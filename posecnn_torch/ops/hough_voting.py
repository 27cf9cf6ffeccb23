"""Hough centre voting, inference and training outputs.

Port of `posecnn_tpu/ops/hough_voting.py:hough_voting`: class slots from the
label histogram, a fixed-size pixel sample per slot, votes on a coarse
centre grid, an exact full-resolution refine window around each slot's
coarse argmax, the inlier box at the winning centre, ROI rows and initial
poses. Both vote passes go through
`ops.voting.accumulate_votes` (the CUDA kernel on the card): the coarse grid
with one set of centres shared by the slots, the refine window with one set
per slot. Training (`is_train=True`) adds the GT quaternion targets of
detections matched to a GT row by projected-box IoU > 0.2, and expands each
detection into 9 rows: the box and 8 copies jittered by 5% of its size, in
the reference order. Nothing here reads a value back to the host, and no
gradient flows through the outputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from posecnn_torch.ops.voting import accumulate_votes
from posecnn_torch.utils.quaternion import quat2mat

# cosine between the predicted direction and the direction to a centre
# above which a pixel votes for it (the reference's inlier_threshold)
INLIER_THRESHOLD = 0.9

_CORNER_SIGNS = (
    (1, 1, 1), (-1, 1, 1), (1, -1, 1), (-1, -1, 1),
    (1, 1, -1), (-1, 1, -1), (1, -1, -1), (-1, -1, -1),
)

# training jitter offsets in the reference order (hough_voting.py:62-67):
# row 0 is the box itself, then (-1,-1), (1,-1), (-1,1), (1,1), (0,-1),
# (-1,0), (0,1), (1,0), in units of 5% of the box's width and height
_JITTER = (
    (0, 0), (-1, -1), (1, -1), (-1, 1), (1, 1), (0, -1), (-1, 0), (0, 1), (1, 0),
)


class HoughOutputs(NamedTuple):
    rois: torch.Tensor          # (R, 7) batch, cls, x1, y1, x2, y2, score
    poses_init: torch.Tensor    # (R, 7) w,x,y,z, tx, ty, tz
    poses_target: torch.Tensor  # (R, 4C)
    poses_weight: torch.Tensor  # (R, 4C)
    domains: torch.Tensor       # (R,) int32
    valid: torch.Tensor         # (R,) bool
    num_rois: torch.Tensor      # () int32


def _corners(extent: torch.Tensor) -> torch.Tensor:
    """(..., 3) extents -> (..., 8, 3) box corners."""
    signs = torch.tensor(_CORNER_SIGNS, dtype=torch.float32, device=extent.device)
    return signs * (extent * 0.5)[..., None, :]


def project_box_threshold(extent, fx, fy, px, py, distance, factor=0.6):
    """Largest side of the projected extent box at each distance, times
    `factor` (`hough_voting.py:_project_box_threshold`).

    extent (S, 3); distance (S, N) -> (S, N)."""
    cx = _corners(extent)  # (S, 8, 3)
    X, Y, Z0 = cx[:, None, :, 0], cx[:, None, :, 1], cx[:, None, :, 2]  # (S,1,8)
    Z = Z0 + distance[..., None]  # (S,N,8)
    x = fx * (X / Z) + px
    y = fy * (Y / Z) + py
    width = x.amax(dim=-1) - x.amin(dim=-1) + 1
    height = y.amax(dim=-1) - y.amin(dim=-1) + 1
    return torch.maximum(width, height) * factor


def _sample_class_pixels(lab_cand, slot_cls, slot_valid, skip_pixels, P, pixel_index):
    """Every `skip_pixels`-th pixel of each slot's class in row-major order,
    padded to P (`hough_voting.py:_sample_class_pixels`), for all slots at
    once. Returns (indices (S, P) into the image, valid (S, P))."""
    S = slot_cls.shape[0]
    m = (lab_cand[None, :] == slot_cls[:, None]) & slot_valid[:, None]  # (S, N)
    rank = torch.cumsum(m, dim=1) - 1
    take = m & (rank % skip_pixels == 0)
    srank = torch.cumsum(take, dim=1) - 1
    keep = take & (srank < P)
    dest = torch.where(keep, srank, torch.full_like(srank, P))
    samp = torch.zeros((S, P + 1), dtype=torch.int64, device=lab_cand.device)
    # every kept pixel has its own destination; all others land in column P,
    # which is dropped
    samp.scatter_(1, dest, pixel_index.expand(S, -1))
    n_kept = keep.sum(dim=1)
    arange = torch.arange(P, device=lab_cand.device)
    return samp[:, :P], arange[None, :] < n_kept[:, None]


def coarse_centers(H: int, W: int, center_stride: int, device):
    """The coarse centre grid at `center_stride`: its x and y coordinates
    and the centres (1, 2, NC), row-major with NC = len(gxs) * len(gys)."""
    gxs = torch.arange(0, W, center_stride, device=device).float()
    gys = torch.arange(0, H, center_stride, device=device).float()
    coarse = torch.stack([gxs.repeat(gys.shape[0]), gys.repeat_interleave(gxs.shape[0])])[None].contiguous()
    return gxs, gys, coarse


def candidate_pixels(H: int, W: int, pixel_grid_stride: int, device) -> torch.Tensor:
    """Row-major indices of the pixels that may be sampled: every
    `pixel_grid_stride`-th row and column."""
    g = pixel_grid_stride
    if g > 1:
        rows = torch.arange(0, H, g, device=device)
        cols = torch.arange(0, W, g, device=device)
        return (rows[:, None] * W + cols[None, :]).reshape(-1)
    return torch.arange(H * W, device=device)


def slot_samples(lab, vert, meta, extents, cand_index, W, *, num_classes, class_slots, label_threshold, skip,
                 max_samples):
    """One image's class slots and their packed vote samples.

    lab (H*W,) int; vert (H*W, 3C); meta (48,); extents (C, 3). Returns the
    slots' classes (S,) (0 where empty), their validity (S,), extents (S, 3)
    and the samples (S, 8, P) that `accumulate_votes` takes: px, py, u, v,
    depth, box_thr, (0.9*|uv|)^2, valid."""
    dev = lab.device
    C, S, P = num_classes, class_slots, max_samples
    fx, px_, fy, py_ = meta[0], meta[2], meta[4], meta[5]

    # class slots: active classes in ascending order (hough_voting.py:309-320)
    cls_ids = torch.arange(C, device=dev)
    counts = (lab[None, :] == cls_ids[:, None]).sum(dim=1)
    active = (counts > label_threshold) & (cls_ids > 0)
    order = torch.sort(torch.where(active, cls_ids, torch.full_like(cls_ids, C))).values
    if S > C:
        order = torch.cat([order, torch.full((S - C,), C, dtype=order.dtype, device=dev)])
    slot_cls = order[:S]
    slot_valid = slot_cls < C
    cls = torch.where(slot_valid, slot_cls, torch.zeros_like(slot_cls))
    ext = extents[cls]  # (S, 3)

    # samples (hough_voting.py:_slot_samples)
    idx, svalid = _sample_class_pixels(lab[cand_index], cls, slot_valid, skip, P, cand_index)
    sx = (idx % W).float()
    sy = (idx // W).float()
    col = 3 * cls[:, None]
    su = torch.where(svalid, vert[idx, col], 0.0)
    sv = torch.where(svalid, vert[idx, col + 1], 0.0)
    sd = torch.where(svalid, torch.exp(vert[idx, col + 2]), 0.0)
    sthr = project_box_threshold(ext, fx, fy, px_, py_, sd)
    tsq = INLIER_THRESHOLD * INLIER_THRESHOLD * (su * su + sv * sv)
    packed = torch.stack([sx, sy, su, sv, sd, sthr, tsq, svalid.float()], dim=1).contiguous()
    return cls, slot_valid, ext, packed


def refine_window_centers(bx, by, H: int, W: int, center_stride: int, refine_window: int):
    """The exact full-resolution refine window around each slot's coarse
    argmax (bx, by) (S,), clamped into the image: its x and y coordinates
    (S, RW) and the per-slot centres (S, 2, RW*RW), row-major."""
    RW = refine_window
    half = (RW - center_stride) // 2
    x0 = torch.clamp(bx - half, 0, W - RW)
    y0 = torch.clamp(by - half, 0, H - RW)
    off = torch.arange(RW, device=bx.device).float()
    cxs = x0[:, None] + off  # (S, RW)
    cys = y0[:, None] + off
    window = torch.stack([cxs.repeat(1, RW), cys.repeat_interleave(RW, dim=1)], dim=1).contiguous()
    return cxs, cys, window


def hough_voting(
    label: torch.Tensor,
    vertex_pred: torch.Tensor,
    extents: torch.Tensor,
    meta_data: torch.Tensor,
    gt_poses: torch.Tensor,
    *,
    num_classes: int,
    is_train: bool,
    skip_pixels: int = 10,
    label_threshold: int = 500,
    class_slots: int = 8,
    max_samples: int = 1024,
    center_stride: int = 4,
    refine_window: int = 16,
    pixel_grid_stride: int = 1,
    sampler: str = "exact",
) -> HoughOutputs:
    """Fixed-shape Hough voting, one detection per active class slot (9
    rows each when `is_train`).

    label (B,H,W) int; vertex_pred (B,H,W,3C) f32; extents (C,3);
    meta_data (B,48) (fx=meta[0], px=meta[2], fy=meta[4], py=meta[5]);
    gt_poses (G,13) zero-padded (rows with cls <= 0 are ignored).

    sampler "exact" takes every `skip_pixels`-th class pixel in row-major
    order. sampler "approx" takes the first `max_samples` class pixels in
    row-major order and ignores `skip_pixels`: that is what the JAX
    package's `approx_max_k` returns on the CPU, made deterministic here.
    The multi-instance mode (`voting_threshold > 0`, `hough_voting_multi`)
    is not ported yet.
    """
    if sampler not in ("exact", "approx"):
        raise ValueError(f"unknown sampler {sampler!r}")
    dev = label.device
    B, H, W = label.shape
    C, S, P = num_classes, class_slots, max_samples
    skip = 1 if sampler == "approx" else skip_pixels
    t2 = INLIER_THRESHOLD * INLIER_THRESHOLD

    label_flat = label.reshape(B, H * W)
    vert_flat = vertex_pred.reshape(B, H * W, 3 * C)
    gt_cls = gt_poses[:, 1]
    gt_batch = gt_poses[:, 0]
    gt_any = torch.any(gt_cls > 0)

    gxs, gys, coarse = coarse_centers(H, W, center_stride, dev)
    gw = gxs.shape[0]
    cand_index = candidate_pixels(H, W, pixel_grid_stride, dev)
    slot_ids = torch.arange(S, device=dev)
    per_image = []
    for b in range(B):
        meta = meta_data[b]
        fx, px_, fy, py_ = meta[0], meta[2], meta[4], meta[5]
        cls, slot_valid, ext, packed = slot_samples(
            label_flat[b], vert_flat[b], meta, extents, cand_index, W, num_classes=C, class_slots=S,
            label_threshold=label_threshold, skip=skip, max_samples=P,
        )
        sx, sy, su, sv = packed[:, 0], packed[:, 1], packed[:, 2], packed[:, 3]
        svalid = packed[:, 7] > 0

        # coarse votes, first maximum wins (thrust::max_element); the kernel
        # tiles the grid in 2-D with its width
        votes, dsum = accumulate_votes(packed, coarse, grid_w=gw)
        best = torch.argmax(votes, dim=1)
        bx = gxs[best % gw]
        by = gys[best // gw]

        if center_stride > 1:
            # exact full-resolution refine window around the coarse argmax
            RW = refine_window
            cxs, cys, window = refine_window_centers(bx, by, H, W, center_stride, RW)
            v2, d2 = accumulate_votes(packed, window)  # (S, RW*RW)
            j = torch.argmax(v2, dim=1)
            cx = cxs[slot_ids, j % RW]
            cy = cys[slot_ids, j // RW]
            vbest = v2[slot_ids, j]
            dbest = d2[slot_ids, j]
        else:
            cx, cy = bx, by
            vbest = votes[slot_ids, best]
            dbest = dsum[slot_ids, best]

        dist = torch.where(vbest > 0, dbest / torch.clamp(vbest, min=1.0), 0.0)

        # inlier box at the winning centre with the mean distance
        thr_mean = project_box_threshold(ext, fx, fy, px_, py_, dist[:, None])  # (S, 1)
        ccx, ccy = cx[:, None], cy[:, None]
        dx = sx - ccx
        dy = sy - ccy
        dot = su * (ccx - sx) + sv * (ccy - sy)
        n1sq = su * su + sv * sv
        n2sq = dx * dx + dy * dy
        inl = (dot > 0.0) & (dot * dot > (t2 * n1sq) * n2sq)
        okb = (dx.abs() < thr_mean) & (dy.abs() < thr_mean) & inl & svalid
        bw = torch.where(okb, dx.abs(), -1.0).amax(dim=1)
        bh = torch.where(okb, dy.abs(), -1.0).amax(dim=1)
        bb_width = torch.where(vbest > 0, 2.0 * bw, 0.0)
        bb_height = torch.where(vbest > 0, 2.0 * bh, 0.0)

        scale = 0.05
        rx = (cx - px_) / fx
        ry = (cy - py_) / fy
        box = torch.stack(
            [
                cx - bb_width * (0.5 + scale),
                cy - bb_height * (0.5 + scale),
                cx + bb_width * (0.5 + scale),
                cy + bb_height * (0.5 + scale),
            ],
            dim=1,
        )
        one, zero = torch.ones_like(dist), torch.zeros_like(dist)
        pose = torch.stack([one, zero, zero, zero, rx * dist, ry * dist, dist], dim=1)

        # GT quaternion targets by projected-box IoU > 0.2, first match wins
        # (hough_voting.py:439-464); with no GT rows they are all zero
        gext = extents[torch.clamp(gt_cls.to(torch.int64), 0, C - 1)]
        pc = _corners(gext) @ quat2mat(gt_poses[:, 6:10]).transpose(-1, -2) + gt_poses[:, None, 10:13]
        gx_ = fx * pc[..., 0] / pc[..., 2] + px_
        gy_ = fy * pc[..., 1] / pc[..., 2] + py_
        boxes_gt = torch.stack([gx_.amin(-1), gy_.amin(-1), gx_.amax(-1), gy_.amax(-1)], dim=1)  # (G,4)
        ious = _iou(box[:, None, :], boxes_gt[None, :, :])  # (S, G)
        match = (
            (gt_cls.to(torch.int64)[None, :] == cls[:, None])
            & (gt_batch.to(torch.int64)[None, :] == b)
            & (gt_cls[None, :] > 0)
            & (ious > 0.2)
        )
        found = match.any(dim=1)
        first = torch.argmax(match.to(torch.uint8), dim=1)
        quat = gt_poses[first, 6:10] * found[:, None]
        cols4 = 4 * cls[:, None] + torch.arange(4, device=dev)
        targets = torch.zeros((S, 4 * C), device=dev).scatter(1, cols4, quat)
        weights = torch.zeros((S, 4 * C), device=dev).scatter(
            1, cols4, (found & slot_valid).float()[:, None].expand(S, 4)
        )
        targets = torch.where(slot_valid[:, None], targets, 0.0)
        domain = torch.where(gt_any, 0, 1).to(torch.int32).expand(S)
        per_image.append((cls, slot_valid, box, vbest, pose, targets, weights, domain))

    slot_cls, slot_valid, box, score, pose, targets, weights, domain = [
        torch.stack(t) for t in zip(*per_image)
    ]  # leading (B, S)
    if is_train:
        # 9 rows per detection (hough_voting.py:473-486)
        J = len(_JITTER)
        shift = torch.tensor(_JITTER, dtype=torch.float32, device=dev)  # (J, 2)
        ww = (box[..., 2] - box[..., 0])[..., None]
        hh = (box[..., 3] - box[..., 1])[..., None]
        bx0 = box[..., None, 0] + shift[:, 0] * 0.05 * ww
        by0 = box[..., None, 1] + shift[:, 1] * 0.05 * hh
        box = torch.stack([bx0, by0, bx0 + ww, by0 + hh], dim=-1)  # (B,S,J,4)
    else:
        J = 1
        box = box[:, :, None, :]
    R = B * S * J

    def rows(x):  # (B, S, ...) -> (R, ...), each slot repeated J times
        return x[:, :, None].expand(B, S, J, *x.shape[2:]).reshape(R, *x.shape[2:])

    batch_col = torch.arange(B, device=dev).float()[:, None].expand(B, S)
    rois = torch.cat(
        [rows(batch_col)[:, None], rows(slot_cls.float())[:, None], box.reshape(R, 4), rows(score)[:, None]], dim=-1
    )
    valid = rows(slot_valid)
    rois = torch.where(valid[:, None], rois, 0.0)
    poses_init = torch.where(valid[:, None], rows(pose), 0.0)
    poses_target = torch.where(valid[:, None], rows(targets), 0.0)
    poses_weight = torch.where(valid[:, None], rows(weights), 0.0)
    domains = torch.where(valid, rows(domain), 0)
    num_rois = valid.sum().to(torch.int32)
    return HoughOutputs(rois, poses_init, poses_target, poses_weight, domains, valid, num_rois)


def _iou(box_a, box_b):
    """IoU with the +1 pixel convention (`hough_voting.py:_iou`)."""
    left = torch.maximum(box_a[..., 0], box_b[..., 0])
    right = torch.minimum(box_a[..., 2], box_b[..., 2])
    top = torch.maximum(box_a[..., 1], box_b[..., 1])
    bottom = torch.minimum(box_a[..., 3], box_b[..., 3])
    w = torch.clamp(right - left + 1, min=0.0)
    h = torch.clamp(bottom - top + 1, min=0.0)
    inter = w * h
    sa = (box_a[..., 2] - box_a[..., 0] + 1) * (box_a[..., 3] - box_a[..., 1] + 1)
    sb = (box_b[..., 2] - box_b[..., 0] + 1) * (box_b[..., 3] - box_b[..., 1] + 1)
    return inter / (sa + sb - inter)
