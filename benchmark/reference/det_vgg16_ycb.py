"""The plain reference of the detection network's training step (PoseCNN's
VGG16DET, `lib/networks/vgg16_det.py` and `train_net_det` of yuxng/PoseCNN;
its RPN and RoI head after Ren et al., arXiv:1506.01497;
`configs/det_vgg16_ycb.json`), in float32.

From the raw frame files and the step's random draws it works out the
batch (the frame, its GT boxes from the label's extents, its pose rows),
the VGG16 trunk, the RPN (a 3x3 conv, the anchor class and box heads), the
anchors and their targets, the proposals (decode, clip, top-k, a greedy
NMS, the first kept), the proposal targets (fg and bg RoIs sampled, their
box and quaternion targets), the crop pool of conv5_3, fc6 and fc7 with
their dropout, the class, box and quaternion heads, the losses (the RPN's
and the head's cross entropies and smooth L1 terms, ADD, L2) and momentum
SGD without clipping. Nothing on the proposal path is detached: the RoIs
carry the box deltas' gradient into the crops and the box targets.

What it takes from the side it judges (`follow`): the discrete selections
that the last bit of the arithmetic can move, as the flagship reference
takes its Hough inputs. The top-k order and NMS's keep set are the judged
side's (its scores sorted, its keep mask applied), and so are the sampled
RoIs (which of the kept proposals, and their labels). The reference's own
values go through those selections. It checks them by itself, row by
row, in the first step's heads beside the RPN maps and the head's outputs
(`checked_selections`): its own top-k and greedy NMS over the judged side's
scores and decoded boxes must keep the judged side's kept proposals
(`heads["proposals"]`), and its own sampling of those proposals with the
same draws must pick the judged side's RoIs with the judged side's labels
(`heads["roi_rows"]`). A pair of boxes whose IoU lies within NMS_BAND of
the threshold is decided as the judged side decided it: two correct
float32 IoUs may fall on either side there.

Departures from the reference's own code, as the program runs it:
  * one image a step (the detection trainer's batch, whatever
    IMS_PER_BATCH says), the raw frame with the pixel means subtracted and
    no jitter or noise;
  * GT boxes from each class's label extent (classes of at least
    GT_MIN_PIXELS pixels, in class order, at most MAX_GT); the pose rows in
    the frame's object order, and a fg RoI's quaternion target is the pose
    row at its GT box's index, as the program indexes them;
  * the RPN's and the head's sampling draws are uniforms by name, and a
    sample keeps the eligible anchors or RoIs of the lowest draws;
  * a fg RoI's box and pose targets come from the GT box of its label's
    class (a batch holds one box a class).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import _plain as P
from benchmark.reference import posecnn_vgg16_ycb as Y

GT_MIN_PIXELS = 10
# IoUs within this of the NMS threshold are decided as the judged side decided
NMS_BAND = 1e-5


# ------------------------------------------------------------------ weights


def num_anchors(cfg: Dict) -> int:
    return len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])


def param_specs(cfg: Dict) -> List:
    """(name, shape, std) of every parameter, in the order the weights are
    drawn (`_plain.make_weights`)."""
    C, A = cfg["NUM_CLASSES"], num_anchors(cfg)
    scale, fc = cfg.get("trunk_scale", 1.0), cfg["fc_dim"]
    c5 = P.scaled(512, scale)
    init = cfg["init_std"]
    return (P.trunk_specs("trunk.", scale, init["input_std"])
            + P.conv_spec("conv_rpn", c5, c5, 3)
            + P.conv_spec("rpn_cls_score", c5, 2 * A, 1, init["rpn_cls_score"])
            + P.conv_spec("rpn_bbox_pred", c5, 4 * A, 1, init["rpn_bbox_pred"])
            + P.fc_spec("fc6", 7 * 7 * c5, fc) + P.fc_spec("fc7", fc, fc)
            + P.fc_spec("cls_score", fc, C, init["cls_score"])
            + P.fc_spec("bbox_pred", fc, 4 * C, init["bbox_pred"])
            + P.fc_spec("poses_pred_unnormalized", fc, 4 * C, init["poses_pred_unnormalized"]))


# ------------------------------------------------------------------- frames


def load_frame(frames_dir: str, i: int, max_gt: int) -> Dict[str, np.ndarray]:
    """Frame i as the detection step reads it: data (1,H,W,3) uint8 BGR,
    gt_boxes (max_gt,5) [x1,y1,x2,y2,cls] from the label's extents, poses
    (max_gt,13) the frame's pose rows."""
    f = Y.load_frame(frames_dir, i)
    label = f["label"]
    boxes = np.zeros((max_gt, 5), np.float32)
    k = 0
    for c in np.unique(label):
        if c <= 0 or k >= max_gt:
            continue
        ys, xs = np.nonzero(label == c)
        if len(xs) >= GT_MIN_PIXELS:
            boxes[k] = [xs.min(), ys.min(), xs.max(), ys.max(), c]
            k += 1
    poses = np.zeros((max_gt, 13), np.float32)
    rows = f["rows"][:max_gt]
    poses[:rows.shape[0]] = rows
    return {"data": f["data"][None], "gt_boxes": boxes, "poses": poses}


# ------------------------------------------------------------------ anchors


def base_anchors(stride: int, ratios, scales) -> np.ndarray:
    """(A,4) anchors of one cell (generate_anchors.py): the stride's square
    box reshaped to each aspect ratio (rounded widths), then scaled."""
    def whc(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def boxes(ws, hs, cx, cy):
        ws, hs = np.asarray(ws, np.float64)[:, None], np.asarray(hs, np.float64)[:, None]
        return np.hstack([cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1), cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)])

    w, h, cx, cy = whc(np.array([0, 0, stride - 1, stride - 1], np.float64))
    ws = np.round(np.sqrt(w * h / np.asarray(ratios, np.float64)))
    hs = np.round(ws * np.asarray(ratios, np.float64))
    out = []
    for r in boxes(ws, hs, cx, cy):
        rw, rh, rx, ry = whc(r)
        out.append(boxes(rw * np.asarray(scales, np.float64), rh * np.asarray(scales, np.float64), rx, ry))
    return np.vstack(out).astype(np.float32)


def all_anchors(Hf: int, Wf: int, stride: int, base: np.ndarray, device) -> torch.Tensor:
    """(Hf*Wf*A, 4): each cell's anchors (row-major cells, then the A)."""
    sx, sy = np.meshgrid(np.arange(Wf) * stride, np.arange(Hf) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1).astype(np.float32)
    return torch.from_numpy((shifts[:, None, :] + base[None]).reshape(-1, 4)).to(device)


# -------------------------------------------------------------------- boxes


def box_targets(ex: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(dx, dy, dw, dh) from boxes ex to gt, "+1" widths."""
    ew, eh = ex[:, 2] - ex[:, 0] + 1.0, ex[:, 3] - ex[:, 1] + 1.0
    gw, gh = gt[:, 2] - gt[:, 0] + 1.0, gt[:, 3] - gt[:, 1] + 1.0
    ecx, ecy = ex[:, 0] + 0.5 * ew, ex[:, 1] + 0.5 * eh
    gcx, gcy = gt[:, 0] + 0.5 * gw, gt[:, 1] + 0.5 * gh
    return torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh, torch.log(gw / ew), torch.log(gh / eh)], 1)


def decode(anchors: torch.Tensor, deltas: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The anchors moved by the deltas (N,4), clipped to the image."""
    w, h = anchors[:, 2] - anchors[:, 0] + 1.0, anchors[:, 3] - anchors[:, 1] + 1.0
    cx, cy = anchors[:, 0] + 0.5 * w, anchors[:, 1] + 0.5 * h
    px, py = deltas[:, 0] * w + cx, deltas[:, 1] * h + cy
    pw, ph = torch.exp(deltas[:, 2]) * w, torch.exp(deltas[:, 3]) * h
    x1, x2 = torch.clamp(px - 0.5 * pw, 0, W - 1), torch.clamp(px + 0.5 * pw, 0, W - 1)
    y1, y2 = torch.clamp(py - 0.5 * ph, 0, H - 1), torch.clamp(py + 0.5 * ph, 0, H - 1)
    return torch.stack([x1, y1, x2, y2], 1)


def overlaps(boxes: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(N,G) IoU of boxes with the GT rows, -1 against a padding row."""
    ov = Y.iou(boxes[:, None, :], gt[None, :, :4])
    return torch.where(gt[None, :, 4] > 0, ov, torch.full((), -1.0, device=boxes.device))


def lowest_draws(eligible: torch.Tensor, u: torch.Tensor, n) -> torch.Tensor:
    """The eligible entries of the n lowest draws (ties: the lower index)."""
    idx = torch.nonzero(eligible)[:, 0]
    order = torch.sort(u[idx], stable=True).indices
    keep = torch.zeros_like(eligible)
    keep[idx[order[:int(n)]]] = True
    return keep


def smooth_l1(pred, target, w_in, w_out, sigma: float) -> torch.Tensor:
    """Smooth L1 of the inside-weighted difference (quadratic below
    1/sigma^2), outside-weighted, summed."""
    s2 = sigma * sigma
    d = w_in * (pred - target)
    a = d.abs()
    quad = (a < 1.0 / s2).float()
    return (w_out * (d * d * (s2 / 2.0) * quad + (a - 0.5 / s2) * (1.0 - quad))).sum()


# ---------------------------------------------------------------------- NMS


def suppression(boxes: torch.Tensor, thresh: float, chunk: int = 1024) -> np.ndarray:
    """(N,N) IoU on the host, float32, computed in chunks of rows."""
    rows = []
    for r0 in range(0, boxes.shape[0], chunk):
        rows.append(Y.iou(boxes[r0:r0 + chunk, None, :], boxes[None, :, :]).cpu())
    return torch.cat(rows).numpy() if rows else np.zeros((0, 0), np.float32)


def greedy_nms(boxes: torch.Tensor, thresh: float, judged: Optional[np.ndarray] = None) -> np.ndarray:
    """Keep mask of boxes sorted by score: a box is kept unless a kept box
    before it overlaps it by IoU > thresh. With `judged` (the judged side's
    keep mask), a box whose only reasons to go lie within NMS_BAND of the
    threshold is kept or not as the judged side kept it."""
    iou = suppression(boxes.detach().float(), thresh)
    n = iou.shape[0]
    hi = iou > thresh + (NMS_BAND if judged is not None else 0.0)
    lo = iou > thresh - NMS_BAND if judged is not None else hi
    keep = np.zeros(n, bool)
    gone_hi, gone_lo = np.zeros(n, bool), np.zeros(n, bool)
    for j in range(n):
        if gone_hi[j] or (gone_lo[j] and not judged[j]):
            continue
        keep[j] = True
        gone_hi |= hi[j]
        gone_lo |= lo[j]
    return keep


def top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The k highest scores' indices, highest first (ties: the lower index)."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


# --------------------------------------------------------------------- step


def anchor_targets(anchors, gt, H: int, W: int, draws, rc: Dict):
    """Each anchor's label (1 fg, 0 bg, -1 none), box targets and the
    inside and outside weights (anchor_target_layer.py)."""
    dev = anchors.device
    inside = (anchors[:, 0] >= 0) & (anchors[:, 1] >= 0) & (anchors[:, 2] < W) & (anchors[:, 3] < H)
    valid = gt[:, 4] > 0
    ov = overlaps(anchors, gt)
    assign, best = torch.argmax(ov, 1), ov.amax(1)
    gt_best = torch.where(inside[:, None], ov, torch.full((), -1.0, device=dev)).amax(0)
    is_best = ((ov >= gt_best[None] - 1e-5) & valid[None] & (gt_best[None] > 0)).any(1)
    labels = torch.full((anchors.shape[0],), -1, dtype=torch.int64, device=dev)
    labels[best < rc["negative_overlap"]] = 0
    labels[is_best] = 1
    labels[best >= rc["positive_overlap"]] = 1
    labels[~inside] = -1
    fg = lowest_draws(labels == 1, draws["rpn/anchor_fg"], int(rc["fg_fraction"] * rc["batchsize"]))
    labels[(labels == 1) & ~fg] = -1
    bg = lowest_draws(labels == 0, draws["rpn/anchor_bg"], rc["batchsize"] - int((labels == 1).sum()))
    labels[(labels == 0) & ~bg] = -1
    targets = box_targets(anchors, gt[assign, :4])
    w_in = (labels == 1).float()[:, None].expand(-1, 4)
    w_out = (labels >= 0).float()[:, None].expand(-1, 4) / max(int((labels >= 0).sum()), 1)
    return labels, targets, w_in, w_out


def own_rois(rois: torch.Tensor, gt: torch.Tensor, draws, tc: Dict, batch: int):
    """The RoIs this side samples (proposal_target_layer.py): the rows (an
    index into `rois`, -1 past the sampled) and their labels."""
    ov = overlaps(rois[:, 1:5], gt)
    assign, best = torch.argmax(ov, 1), ov.amax(1)
    fg = lowest_draws(best >= tc["fg_thresh"], draws["rpn/target_fg"], int(tc["fg_fraction"] * batch))
    bg = lowest_draws((best < tc["bg_thresh_hi"]) & (best >= tc["bg_thresh_lo"]), draws["rpn/target_bg"],
                      batch - int(fg.sum()))
    take = torch.cat([torch.nonzero(fg)[:, 0], torch.nonzero(bg)[:, 0]])[:batch]
    rows = torch.full((batch,), -1, dtype=torch.int64, device=rois.device)
    rows[:take.shape[0]] = take
    labels = torch.zeros((batch,), dtype=torch.int64, device=rois.device)
    labels[:take.shape[0]] = torch.where(fg[take], gt[assign[take], 4].long(), 0)
    return rows, labels


def roi_targets(rois, rows, labels, gt, poses, C: int, stds, follow: bool):
    """The sampled RoIs (R,5) and their box and quaternion targets and
    weights (R,4C) in each row's class block; a bg row has none."""
    valid = rows >= 0
    out = torch.where(valid[:, None], rois[rows.clamp(min=0)], torch.zeros((), device=rois.device))
    assign = torch.argmax(overlaps(out[:, 1:5].detach(), gt), 1)
    if follow:  # a fg row's targets are those of its label's GT box
        assign = torch.where(labels > 0, torch.argmax((gt[None, :, 4].long() == labels[:, None]).to(torch.uint8), 1),
                             assign)
    fg = (labels > 0)[:, None]
    onehot = torch.nn.functional.one_hot(labels, C).float()
    t = box_targets(out[:, 1:5], gt[assign, :4]) / torch.tensor(stds, device=rois.device)
    block = lambda x: (onehot[:, :, None] * x[:, None, :]).reshape(-1, 4 * C)  # noqa: E731
    w = torch.where(fg, block(torch.ones_like(t)), torch.zeros((), device=rois.device))
    return out, torch.where(fg, block(t), 0.0), w, torch.where(fg, block(poses[assign, 6:10]), 0.0)


def step_loss(params, cfg: Dict, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor], consts,
              follow: Optional[Dict], q: P.Quant, first: bool):
    """The detection loss of one step; `follow` the judged side's
    selections (`_selections`), None to make this side's own. Returns
    (loss, terms, extra: this side's selections, and at the first step the
    heads)."""
    C, A, keep = cfg["NUM_CLASSES"], num_anchors(cfg), cfg["keep_prob"]
    scale, stride = cfg.get("trunk_scale", 1.0), cfg["feature_stride"]
    points, symmetry = consts
    dev = batch["data"].device
    x = batch["data"].float() - torch.tensor(cfg["PIXEL_MEANS"], dtype=torch.float32, device=dev)
    H, W = x.shape[1:3]
    gt, poses = batch["gt_boxes"], batch["poses"]

    c5 = P.trunk(params, x, scale, q)["conv5_3"]
    head = lambda name, inp, relu: P.conv2d(params[name + ".weight"], params[name + ".bias"], inp, relu, q)  # noqa
    rpn = head("conv_rpn", c5, True)
    rpn_cls, rpn_box = head("rpn_cls_score", rpn, False), head("rpn_bbox_pred", rpn, False)
    Hf, Wf = rpn.shape[1:3]
    anchors = all_anchors(Hf, Wf, stride, base_anchors(stride, cfg["anchor_ratios"], cfg["anchor_scales"]), dev)
    logits = rpn_cls.reshape(-1, 2)  # each anchor's (bg, fg) pair
    scores = P.softmax(logits)[:, 1]
    boxes = decode(anchors, rpn_box.reshape(-1, 4), H, W)

    # the RPN's targets and losses
    labels, targets, w_in, w_out = anchor_targets(anchors, gt, H, W, draws, cfg["rpn_targets"])
    on = labels >= 0
    ce = -torch.gather(P.log_softmax(logits), 1, labels.clamp(min=0)[:, None])[:, 0]
    terms = {"loss_rpn_cls": torch.where(on, ce, 0.0).sum() / max(int(on.sum()), 1),
             "loss_rpn_box": smooth_l1(rpn_box.reshape(-1, 4), targets, w_in, w_out, cfg["rpn_box_sigma"])}

    # the proposals: top-k, NMS, the first kept
    k, post = min(cfg["RPN_PRE_NMS_TOP_N"], scores.shape[0]), cfg["RPN_POST_NMS_TOP_N"]
    top = top_k(follow["scores"] if follow is not None else scores.detach(), k)
    nms_keep = (follow["keep"].to(dev) if follow is not None
                else torch.from_numpy(greedy_nms(boxes.detach()[top], cfg["RPN_NMS_THRESH"])).to(dev))
    kept = top[nms_keep][:post]
    n = kept.shape[0]
    rois = torch.cat([torch.zeros((post, 1), device=dev),
                      torch.cat([boxes[kept], torch.zeros((post - n, 4), device=dev)])], 1)

    # the sampled RoIs and their targets
    R = cfg["ROI_BATCH_SIZE"]
    if follow is not None:
        rows, roi_labels = follow["rows"].to(dev), follow["labels"].to(dev).long()
    else:
        rows, roi_labels = own_rois(rois.detach(), gt, draws, cfg["roi_targets"], R)
    out_rois, bbox_t, bbox_w, pose_t = roi_targets(rois, rows, roi_labels, gt, poses, C,
                                                   cfg["roi_targets"]["bbox_normalize_stds"], follow is not None)

    # the RCNN head
    z = torch.zeros((R, 1), device=dev)
    rois7 = torch.cat([out_rois[:, :1], z, out_rois[:, 1:5], z], 1)
    pool = Y.crop_pool(c5, rois7[None], 1.0 / stride)[0]
    fc = lambda name, inp, relu: P.linear(params[name + ".weight"], params[name + ".bias"], inp, relu, q)  # noqa
    f6 = P.dropout(fc("fc6", pool.reshape(R, -1), True), keep, draws["dropout/fc6"])
    f7 = P.dropout(fc("fc7", f6, True), keep, draws["dropout/fc7"])
    cls_score, bbox_pred = fc("cls_score", f7, False), fc("bbox_pred", f7, False)
    poses_tanh = torch.tanh(fc("poses_pred_unnormalized", f7, False))
    mul = poses_tanh * bbox_w
    pred = mul * torch.rsqrt(torch.clamp((mul * mul).sum(1, keepdim=True), min=1e-12))

    terms["loss_cls"] = -torch.gather(P.log_softmax(cls_score), 1, roi_labels[:, None])[:, 0].mean()
    terms["loss_box"] = smooth_l1(bbox_pred, bbox_t, bbox_w, (bbox_w > 0).float(), 1.0) / R
    terms["loss_pose"] = cfg["POSE_W"] * Y.add_loss(pred, pose_t, bbox_w, points, symmetry, cfg["POSE_MARGIN"])
    terms["loss_regu"] = P.l2_term(params, cfg["WEIGHT_REG"])
    loss = sum(terms.values())
    terms["loss"] = loss

    extra = {"follow": {"scores": scores.detach(), "boxes": boxes.detach(), "keep": nms_keep,
                        "kept": rois[:, 1:5].detach(), "rows": rows, "labels": roi_labels}}
    if first:
        extra["heads"] = {"rpn_cls_score": rpn_cls.detach(), "rpn_bbox_pred": rpn_box.detach(),
                          "cls_score": cls_score.detach(), "bbox_pred": bbox_pred.detach(),
                          "poses_tanh": poses_tanh.detach()}
        if follow is not None:
            extra["heads"].update(checked_selections(follow, k, cfg["RPN_NMS_THRESH"], gt, draws,
                                                     cfg["roi_targets"], R))
        else:  # this side's selections are its own
            extra["heads"].update(proposals=torch.ones(post, device=dev), roi_rows=torch.ones(R, device=dev))
    return loss, {kk: v.detach() for kk, v in terms.items()}, extra


def checked_selections(judged: Dict, k: int, thresh: float, gt, draws, tc: Dict, R: int) -> Dict:
    """The judged side's selections checked row by row against this side's
    own over the judged side's inputs: 1 where a row agrees, 0 where not,
    so that one wrong row reads 1/sqrt(rows - 1) in `heads_gap`.
    "proposals": each kept proposal (zero rows past the kept) against this
    side's top-k and greedy NMS of the judged side's scores and decoded
    boxes. "roi_rows": each sampled RoI (its row among the kept proposals
    and its label) against this side's sampling of the judged side's kept
    proposals with the same draws (`own_rois`)."""
    top = top_k(judged["scores"], k)
    boxes = judged["boxes"][top]
    keep = torch.from_numpy(greedy_nms(boxes, thresh, judged["keep"].cpu().numpy())).to(boxes.device)
    kept, post = boxes[keep], judged["kept"].shape[0]
    own = torch.cat([kept[:post], torch.zeros((max(post - kept.shape[0], 0), 4), device=boxes.device)])
    rois = torch.cat([torch.zeros((post, 1), device=boxes.device), judged["kept"]], 1)
    rows, labels = own_rois(rois, gt, draws, tc, R)
    return {"proposals": (own == judged["kept"]).all(1).float(),
            "roi_rows": ((rows == judged["rows"]) & (labels == judged["labels"].long())).float()}


def run(cfg: Dict, weights: Dict[str, torch.Tensor], steps: List[Dict], device, follow: Optional[List] = None,
        precision: Optional[str] = None) -> Dict:
    """The reference's first len(steps) training steps from `weights` (the
    dict is updated in place). steps[s]: {"frames": [the frame id], "draws":
    the step's draws by name}; follow[s]: the judged side's selections
    (`step_loss`). Returns `_plain.train_steps`' readings."""
    P.strict_float32()
    q = P.Quant(precision)
    pts, sym, _, _ = Y.object_models(cfg)
    consts = tuple(torch.from_numpy(a).to(device) for a in (pts, sym))

    def loss_fn(params, s):
        st = steps[s]
        f = load_frame(cfg["frames_dir"], int(st["frames"][0]), cfg["MAX_GT"])
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in f.items()}
        draws = {k: v.to(device) for k, v in st["draws"].items()}
        fol = None if follow is None else {k: v.to(device) for k, v in follow[s].items()}
        return step_loss(params, cfg, batch, draws, consts, fol, q, s == 0)

    lr = cfg["LEARNING_RATE"]
    return P.train_steps(weights, loss_fn, len(steps), lambda s: lr * cfg["GAMMA"] ** (s // cfg["STEPSIZE"]),
                         cfg["MOMENTUM"], 0.0)
