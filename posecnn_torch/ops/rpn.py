"""Region Proposal Network layers.

Port of `posecnn_tpu/ops/rpn.py`: `generate_anchors` (:23) and
`shifted_anchors` (:61) on the host in NumPy, exact; `_random_subsample`
(:73), `anchor_target_layer` (:94), `proposal_layer` (:164) and
`proposal_target_layer` (:215) on tensors, with the JAX package's fixed
shapes: masked sets instead of dynamic index sets, and an extra row that
takes the writes `mode="drop"` discards there, sliced off.

Random numbers come from a `draws` object (`engine.train.Draws`), by name:
the anchor layer's fg and bg uniforms ("rpn/anchor_fg", "rpn/anchor_bg":
JAX's k1 and k2 of `split(r_at)`) and the proposal-target layer's
("rpn/target_fg", "rpn/target_bg": k1 and k2 of `split(r_pt)`), so a test
can replay JAX's draws.

Orders: `lax.top_k` puts the lower index first among equal scores, and
`jnp.argsort` is stable; the port sorts with `torch.sort(stable=True)`
(`torch.topk`'s order among ties is unspecified on CUDA). Nothing on the
proposal path is detached, as in JAX: the rois carry the gradient of
`rpn_bbox_pred` into the RoI crops and the regression targets. The keep
mask of NMS has no gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from posecnn_torch.ops.bbox import bbox_overlaps, bbox_transform, bbox_transform_inv, clip_boxes
from posecnn_torch.ops.nms import nms_keep_sorted


def generate_anchors(base_size=16, ratios=(0.5, 1, 2), scales=(8, 16, 32)) -> np.ndarray:
    """Base anchor windows (reference generate_anchors.py:41), host-side."""
    base_anchor = np.array([1, 1, base_size, base_size]) - 1

    def whctrs(anchor):
        w = anchor[2] - anchor[0] + 1
        h = anchor[3] - anchor[1] + 1
        x_ctr = anchor[0] + 0.5 * (w - 1)
        y_ctr = anchor[1] + 0.5 * (h - 1)
        return w, h, x_ctr, y_ctr

    def mkanchors(ws, hs, x_ctr, y_ctr):
        ws = ws[:, np.newaxis]
        hs = hs[:, np.newaxis]
        return np.hstack(
            (x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1), x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1))
        )

    w, h, x_ctr, y_ctr = whctrs(base_anchor)
    size = w * h
    size_ratios = size / np.array(ratios)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * np.array(ratios))
    ratio_anchors = mkanchors(ws, hs, x_ctr, y_ctr)
    anchors = np.vstack(
        [
            mkanchors(
                whctrs(ratio_anchors[i])[0] * np.array(scales),
                whctrs(ratio_anchors[i])[1] * np.array(scales),
                whctrs(ratio_anchors[i])[2],
                whctrs(ratio_anchors[i])[3],
            )
            for i in range(ratio_anchors.shape[0])
        ]
    )
    return anchors.astype(np.float32)


def shifted_anchors(height: int, width: int, feat_stride: int, base_anchors: np.ndarray) -> np.ndarray:
    """All anchors of a (height, width) feature map, (height*width*A, 4),
    row-major over the map and the A base anchors."""
    shift_x = np.arange(width) * feat_stride
    shift_y = np.arange(height) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.vstack((sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel())).T
    A = base_anchors.shape[0]
    K = shifts.shape[0]
    anchors = base_anchors.reshape(1, A, 4) + shifts.reshape(K, 1, 4)
    return anchors.reshape(K * A, 4).astype(np.float32)


def _rank(score: torch.Tensor) -> torch.Tensor:
    """The rank of each entry in a stable ascending sort of `score`."""
    order = torch.sort(score, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(score.shape[0], device=score.device)
    return rank


def _random_subsample(noise: torch.Tensor, eligible: torch.Tensor, max_keep: int) -> torch.Tensor:
    """Keep at most max_keep of the eligible entries: those whose uniform
    `noise` ranks below max_keep among the eligible (ineligible entries sort
    last at 2.0). Returns a bool mask."""
    score = torch.where(eligible, noise, torch.full((), 2.0, device=noise.device))
    return eligible & (_rank(score) < max_keep)


class AnchorTargets(NamedTuple):
    labels: torch.Tensor  # (A,) int32 in {-1, 0, 1}
    bbox_targets: torch.Tensor  # (A,4)
    bbox_inside_weights: torch.Tensor
    bbox_outside_weights: torch.Tensor


def anchor_target_layer(
    draws,
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    im_info: Tuple[int, int],
    rpn_batchsize: int = 256,
    fg_fraction: float = 0.5,
    positive_overlap: float = 0.7,
    negative_overlap: float = 0.3,
    clobber_positives: bool = False,
    positive_weight: float = -1.0,
) -> AnchorTargets:
    """RPN labels and regression targets of every anchor (reference
    anchor_target_layer.py:18, fixed shapes). anchors (A,4); gt_boxes (G,5)
    [x1,y1,x2,y2,cls] zero-padded (rows with cls <= 0 are ignored)."""
    A = anchors.shape[0]
    dev = anchors.device
    h, w = im_info
    gt_valid = gt_boxes[:, 4] > 0
    inside = (anchors[:, 0] >= 0) & (anchors[:, 1] >= 0) & (anchors[:, 2] < w) & (anchors[:, 3] < h)
    neg1 = torch.full((), -1.0, device=dev)

    overlaps = bbox_overlaps(anchors, gt_boxes[:, :4])
    overlaps = torch.where(gt_valid[None, :], overlaps, neg1)
    argmax_gt = torch.argmax(overlaps, dim=1)  # the first maximum, as jnp.argmax
    max_overlaps = overlaps.amax(dim=1)
    gt_max = torch.where(inside[:, None], overlaps, neg1).amax(dim=0)  # per gt
    is_gt_best = ((overlaps >= gt_max[None, :] - 1e-5) & gt_valid[None, :] & (gt_max[None, :] > 0)).any(dim=1)

    def where_(cond, v, x):
        return torch.where(cond, torch.full((), v, dtype=torch.int32, device=dev), x)

    labels = torch.full((A,), -1, dtype=torch.int32, device=dev)
    if not clobber_positives:
        labels = where_(max_overlaps < negative_overlap, 0, labels)
    labels = where_(is_gt_best, 1, labels)
    labels = where_(max_overlaps >= positive_overlap, 1, labels)
    if clobber_positives:
        labels = where_(max_overlaps < negative_overlap, 0, labels)
    labels = torch.where(inside, labels, torch.full((), -1, dtype=torch.int32, device=dev))

    num_fg = int(fg_fraction * rpn_batchsize)
    fg_keep = _random_subsample(draws.uniform("rpn/anchor_fg", (A,), dev), labels == 1, num_fg)
    labels = where_((labels == 1) & ~fg_keep, -1, labels)
    n_fg = (labels == 1).sum()
    # keep only rpn_batchsize - n_fg backgrounds
    noise = draws.uniform("rpn/anchor_bg", (A,), dev)
    bg_score = torch.where(labels == 0, noise, torch.full((), 2.0, device=dev))
    labels = where_((labels == 0) & (_rank(bg_score) >= rpn_batchsize - n_fg), -1, labels)

    targets = bbox_transform(anchors, gt_boxes[argmax_gt, :4])
    ones = torch.ones((1, 4), device=dev)
    inside_w = (labels == 1).float()[:, None] * ones
    n_examples = torch.clamp((labels >= 0).sum(), min=1)
    if positive_weight < 0:
        pos_w = 1.0 / n_examples
        neg_w = 1.0 / n_examples
    else:
        pos_w = positive_weight / torch.clamp((labels == 1).sum(), min=1)
        neg_w = (1.0 - positive_weight) / torch.clamp((labels == 0).sum(), min=1)
    zero = torch.zeros((), device=dev)
    outside_w = torch.where(
        (labels == 1)[:, None], pos_w, torch.where((labels == 0)[:, None], neg_w, zero)
    ) * ones
    return AnchorTargets(labels, targets, inside_w, outside_w)


def proposal_layer(
    rpn_cls_prob: torch.Tensor,
    rpn_bbox_pred: torch.Tensor,
    anchors: torch.Tensor,
    im_info: Tuple[int, int],
    num_anchors: int,
    pre_nms_top_n: int = 6000,
    post_nms_top_n: int = 300,
    nms_thresh: float = 0.7,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode, top-k, NMS (reference proposal_layer.py:15, fixed shape).
    rpn_cls_prob (H,W,2A) with the fg probabilities in the last A channels;
    rpn_bbox_pred (H,W,4A); anchors (H*W*A,4). Returns rois
    (post_nms_top_n, 5) [0, x1, y1, x2, y2] and their scores, the rows past
    the survivors zero. NMS runs on `ops.nms.nms_keep_sorted` (the kernel on
    a card)."""
    scores = rpn_cls_prob[:, :, num_anchors:].reshape(-1)
    deltas = rpn_bbox_pred.reshape(-1, 4)
    proposals = clip_boxes(bbox_transform_inv(anchors, deltas), im_info)

    n = scores.shape[0]
    k = min(pre_nms_top_n, n)
    top = torch.sort(scores, descending=True, stable=True)
    top_scores, top_idx = top.values[:k], top.indices[:k]
    top_boxes = proposals[top_idx]
    # the top-k rows are sorted already, so nms_jax's stable argsort(-scores)
    # leaves them in place: the keep mask of the sorted boxes is the mask
    keep = nms_keep_sorted(top_boxes.detach(), nms_thresh)
    rank = torch.cumsum(keep.to(torch.int32), dim=0) - 1
    sel = keep & (rank < post_nms_top_n)
    dest = torch.where(sel, rank, torch.full((), post_nms_top_n, dtype=rank.dtype, device=rank.device)).long()
    dev = scores.device
    out_boxes = torch.zeros((post_nms_top_n + 1, 4), dtype=top_boxes.dtype, device=dev).index_put(
        (dest,), top_boxes)[:post_nms_top_n]
    out_scores = torch.zeros((post_nms_top_n + 1,), dtype=top_scores.dtype, device=dev).index_put(
        (dest,), top_scores)[:post_nms_top_n]
    rois = torch.cat([torch.zeros((post_nms_top_n, 1), dtype=out_boxes.dtype, device=dev), out_boxes], dim=1)
    return rois, out_scores


class ProposalTargets(NamedTuple):
    rois: torch.Tensor  # (R,5)
    scores: torch.Tensor  # (R,)
    labels: torch.Tensor  # (R,) int32
    bbox_targets: torch.Tensor  # (R,4C)
    bbox_inside_weights: torch.Tensor
    bbox_outside_weights: torch.Tensor
    poses_target: torch.Tensor  # (R,4C)
    poses_weight: torch.Tensor


def proposal_target_layer(
    draws,
    rois: torch.Tensor,
    scores: torch.Tensor,
    gt_boxes: torch.Tensor,
    poses: torch.Tensor,
    num_classes: int,
    batch_size: int = 128,
    fg_fraction: float = 0.25,
    fg_thresh: float = 0.5,
    bg_thresh_hi: float = 0.5,
    bg_thresh_lo: float = 0.1,
    bbox_normalize_stds=(0.1, 0.1, 0.2, 0.2),
) -> ProposalTargets:
    """Sample `batch_size` rois and their targets (reference
    proposal_target_layer.py:17, fixed output size). gt_boxes (G,5)
    [x1,y1,x2,y2,cls] zero-padded; poses (G,13). Rows past the sampled ones
    are background with zero weights; fg rows come first, in roi order."""
    R = rois.shape[0]
    dev = rois.device
    gt_valid = gt_boxes[:, 4] > 0
    overlaps = bbox_overlaps(rois[:, 1:5], gt_boxes[:, :4])
    overlaps = torch.where(gt_valid[None, :], overlaps, torch.full((), -1.0, device=dev))
    gt_assignment = torch.argmax(overlaps, dim=1)
    max_overlaps = overlaps.amax(dim=1)
    labels_all = gt_boxes[gt_assignment, 4].to(torch.int32)
    quats = poses[gt_assignment, 6:10]

    fg = max_overlaps >= fg_thresh
    bg = (max_overlaps < bg_thresh_hi) & (max_overlaps >= bg_thresh_lo)
    n_fg_target = int(fg_fraction * batch_size)
    fg_keep = _random_subsample(draws.uniform("rpn/target_fg", (R,), dev), fg, n_fg_target)
    n_fg = fg_keep.sum()
    noise = draws.uniform("rpn/target_bg", (R,), dev)
    bg_score = torch.where(bg, noise, torch.full((), 2.0, device=dev))
    bg_keep = bg & (_rank(bg_score) < batch_size - n_fg)

    sampled = fg_keep | bg_keep
    # pack the sampled rows into a fixed batch_size block, fg first
    ar = torch.arange(R, device=dev)
    sort_key = torch.where(fg_keep, 0, torch.where(bg_keep, 1, 2)) * R + ar
    take = torch.sort(sort_key, stable=True).indices[:batch_size]
    valid_row = torch.arange(batch_size, device=dev) < sampled.sum()

    zero = torch.zeros((), device=dev)
    out_rois = torch.where(valid_row[:, None], rois[take], zero)
    out_scores = torch.where(valid_row, scores[take], zero)
    out_labels = torch.where(valid_row & fg_keep[take], labels_all[take],
                             torch.zeros((), dtype=torch.int32, device=dev))
    out_quats = quats[take]

    # per-class bbox regression targets
    targets = bbox_transform(out_rois[:, 1:5], gt_boxes[gt_assignment[take], :4])
    targets = targets / torch.tensor(bbox_normalize_stds, dtype=torch.float32, device=dev)
    cls_onehot = torch.nn.functional.one_hot(out_labels.long(), num_classes).float()  # (R,C)
    bbox_targets = (cls_onehot[:, :, None] * targets[:, None, :]).reshape(batch_size, 4 * num_classes)
    is_fg_row = (out_labels > 0)[:, None, None]
    ones = torch.ones((1, 1, 4), device=dev)
    bbox_iw = torch.where(is_fg_row, cls_onehot[:, :, None] * ones, zero).reshape(batch_size, 4 * num_classes)
    bbox_ow = (bbox_iw > 0).float()

    poses_target = (cls_onehot[:, :, None] * out_quats[:, None, :]).reshape(batch_size, 4 * num_classes)
    poses_weight = torch.where(is_fg_row, cls_onehot[:, :, None] * ones, zero).reshape(batch_size, 4 * num_classes)
    poses_target = torch.where((out_labels > 0)[:, None], poses_target, zero)
    return ProposalTargets(out_rois, out_scores, out_labels, bbox_targets, bbox_iw, bbox_ow, poses_target,
                           poses_weight)
