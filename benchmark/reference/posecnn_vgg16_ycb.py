"""The plain reference of PoseCNN's training step on YCB-Video frames
(Xiang et al., RSS 2018; `configs/posecnn_vgg16_ycb.json`).

From the raw frame files and the step's random draws it works out the
batch (the frames, the GT pose rows and centres), the chromatic jitter and
the noise, the VGG16 trunk, the label and vertex heads with their dropout,
the vertex targets, the Hough voting (class slots, samples, coarse votes,
the refine window, the inlier box, the 9 rows a detection, the GT
quaternion targets), the crop pool and fc6-fc8, the losses (hard-label
cross entropy, vertex smooth L1, ADD/ADD-S, the quaternion term, L2) and
momentum SGD with global-norm clipping, in float32.

One thing it takes from the side it judges: the label map and the vertex
map that feed Hough voting on the images whose `hough_gt_mix` draw picks
the network's own maps. An argmax over nearly equal random logits moves
with the last bit of the arithmetic, so no float32 recomputation can
expect the same pixels; the reference votes on that side's maps, and
compares the votes (`hough` in the readings) by itself. On the images that
vote from the ground truth it votes from its own targets.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import _plain as P

INLIER_THRESHOLD = 0.9
CORNER_SIGNS = ((1, 1, 1), (-1, 1, 1), (1, -1, 1), (-1, -1, 1), (1, 1, -1), (-1, 1, -1), (1, -1, -1), (-1, -1, -1))
JITTER = ((0, 0), (-1, -1), (1, -1), (-1, 1), (1, 1), (0, -1), (-1, 0), (0, 1), (1, 0))


# ------------------------------------------------------------------ weights


def param_specs(cfg: Dict) -> List:
    """(name, shape, std) of every parameter, in the order the weights are
    drawn (`_plain.make_weights`)."""
    C, U = cfg["NUM_CLASSES"], cfg["NUM_UNITS"]
    scale, fc = cfg.get("trunk_scale", 1.0), cfg["fc_dim"]
    c5 = P.scaled(512, scale)
    init = cfg["init_std"]
    return (P.trunk_specs("trunk.", scale, cfg["init_std"]["input_std"])
            + P.conv_spec("score_conv5", c5, U, 1) + P.conv_spec("score_conv4", c5, U, 1)
            + P.conv_spec("score", U, C, 1, init["score"])
            + P.conv_spec("score_conv5_vertex", c5, 128, 1) + P.conv_spec("score_conv4_vertex", c5, 128, 1)
            + P.conv_spec("vertex_pred", 128, 3 * C, 1, init["vertex_pred"])
            + P.fc_spec("fc6", 7 * 7 * c5, fc) + P.fc_spec("fc7", fc, fc) + P.fc_spec("fc8", fc, 4 * C, init["fc8"]))


# ------------------------------------------------------------ object models


def object_models(cfg: Dict):
    """(points (C,P,3) scaled for the ADD loss, symmetry (C,), extents (C,3),
    raw points), numpy float32: the stand-in models of the configuration
    (`object_models` in its file): `extent` m boxes, points drawn uniformly
    inside them from numpy's RandomState(seed), class 0 at the origin."""
    om = cfg["object_models"]
    C, n = cfg["NUM_CLASSES"], om["points"]
    ext = float(om["extent"])
    extents = np.full((C, 3), ext, np.float32)
    symmetry = np.asarray(om["symmetry"][:C], np.float32)
    raw = np.random.RandomState(om["seed"]).uniform(-ext / 2, ext / 2, (C, n, 3)).astype(np.float32)
    raw[0] = 0.0
    pts = raw.copy()
    for i in range(1, C):
        w = max(10.0, 2.0 / float(np.amax(extents[i])))
        pts[i] = (4 * w if symmetry[i] > 0 else w) * raw[i]
    return pts, symmetry, extents, raw


# ------------------------------------------------------------------- frames


def mat2quat(M: np.ndarray) -> np.ndarray:
    """A rotation matrix's unit quaternion (w, x, y, z), w >= 0, from the
    eigenvector of the largest eigenvalue of Bar-Itzhack's symmetric K."""
    M = np.asarray(M, np.float64)
    Qxx, Qyx, Qzx, Qxy, Qyy, Qzy, Qxz, Qyz, Qzz = M.flatten()
    K = np.array([
        [Qxx - Qyy - Qzz, 0, 0, 0],
        [Qyx + Qxy, Qyy - Qxx - Qzz, 0, 0],
        [Qzx + Qxz, Qzy + Qyz, Qzz - Qxx - Qyy, 0],
        [Qyz - Qzy, Qzx - Qxz, Qxy - Qyx, Qxx + Qyy + Qzz],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def meta_data(K: np.ndarray) -> np.ndarray:
    """(48,) float32: K row-major in [0:9], its inverse in [9:18]."""
    K = np.asarray(K, np.float64).copy()
    K[2, 2] = 1
    m = np.zeros(48, np.float32)
    m[0:9] = K.flatten()
    m[9:18] = np.linalg.pinv(K).flatten()
    return m


def load_frame(frames_dir: str, i: int) -> Dict[str, np.ndarray]:
    """Frame i of the frozen set, packed: data (H,W,3) uint8 BGR and label
    (H,W) padded to multiples of 16, its GT rows [cls, cx, cy, z] and pose
    rows [0, cls, 0 x 4, quaternion, t], and meta (48,)."""
    with np.load(os.path.join(frames_dir, f"{i:06d}.npz")) as d:
        color, label, cls = d["color"], d["label"], d["cls_indexes"]
        poses, center, K = d["poses"], d["center"], d["intrinsic_matrix"]
    H, W = color.shape[:2]
    ph, pw = -H % 16, -W % 16
    n = poses.shape[2]
    centers = np.zeros((n, 4), np.float32)
    rows = np.zeros((n, 13), np.float32)
    for j in range(n):
        centers[j] = [cls[j], center[j, 0], center[j, 1], poses[2, 3, j]]
        rows[j, 1] = cls[j]
        rows[j, 6:10] = mat2quat(poses[:, :3, j])
        rows[j, 10:] = poses[:, 3, j]
    data = np.pad(np.clip(np.round(color[..., :3]), 0, 255).astype(np.uint8), ((0, ph), (0, pw), (0, 0)))
    return {"data": data, "label": np.pad(label.astype(np.uint8), ((0, ph), (0, pw))), "centers": centers,
            "rows": rows, "meta": meta_data(K)}


def make_batch(frames: Sequence[Dict[str, np.ndarray]], max_gt: int, device) -> Dict[str, torch.Tensor]:
    """The step's batch from its frames: gt_centers (B,G,4) zero-padded,
    the batch's pose rows (max_gt,13) with column 0 the image index, the
    images' real rows first in image order."""
    B = len(frames)
    G = max(1, max(f["centers"].shape[0] for f in frames))
    centers = np.zeros((B, G, 4), np.float32)
    rows = []
    for b, f in enumerate(frames):
        centers[b, :f["centers"].shape[0]] = f["centers"]
        r = f["rows"].copy()
        r[:, 0] = b
        rows.append(r[r[:, 1] > 0])
    rows = np.concatenate(rows)[:max_gt]
    poses = np.zeros((max_gt, 13), np.float32)
    poses[:rows.shape[0]] = rows
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {"data": t(np.stack([f["data"] for f in frames])), "label": t(np.stack([f["label"] for f in frames])),
            "centers": t(centers), "poses": t(poses), "meta": t(np.stack([f["meta"] for f in frames]))}


# ---------------------------------------------------------- augmentation


def bgr_to_hls(bgr: torch.Tensor) -> torch.Tensor:
    """BGR in [0,255] -> HLS with cv2's 8-bit scaling (H/2 in [0,180))."""
    b, g, r = bgr[..., 0] / 255.0, bgr[..., 1] / 255.0, bgr[..., 2] / 255.0
    mx = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    l = (mx + mn) * 0.5
    c = mx - mn
    one = torch.ones((), device=bgr.device)
    safe = torch.where(c > 0, c, one)
    den = torch.where(l <= 0.5, mx + mn, 2.0 - mx - mn)
    s = torch.where(c > 0, c / torch.where(den > 0, den, one), 0.0)
    h = torch.where(mx == r, 60.0 * (g - b) / safe,
                    torch.where(mx == g, 120.0 + 60.0 * (b - r) / safe, 240.0 + 60.0 * (r - g) / safe))
    h = torch.where(c > 0, torch.remainder(h, 360.0), 0.0)
    return torch.stack([h * 0.5, l * 255.0, s * 255.0], dim=-1)


def _hue(m1, m2, h):
    h = torch.remainder(h, 360.0)
    return torch.where(h < 60.0, m1 + (m2 - m1) * h / 60.0,
                       torch.where(h < 180.0, m2, torch.where(h < 240.0, m1 + (m2 - m1) * (240.0 - h) / 60.0, m1)))


def hls_to_bgr(hls: torch.Tensor) -> torch.Tensor:
    h, l, s = hls[..., 0] * 2.0, hls[..., 1] / 255.0, hls[..., 2] / 255.0
    m2 = torch.where(l <= 0.5, l * (1.0 + s), l + s - l * s)
    m1 = 2.0 * l - m2
    return torch.stack([_hue(m1, m2, h - 120.0), _hue(m1, m2, h), _hue(m1, m2, h + 120.0)], dim=-1) * 255.0


def augment(data_u8: torch.Tensor, draws: Dict[str, torch.Tensor], pixel_means) -> torch.Tensor:
    """Per-image HLS jitter (deltas U(-.5,.5) x (3.6, 51.2, 51.2); hue wraps
    mod 180, L and S clip), then on 90% of the images N(0,1) noise shared by
    the channels at sigma sqrt(U(0,1) * 0.3 * 256), clipped to [0,255];
    minus the pixel means."""
    x = data_u8.float()
    d = (draws["chroma"] - 0.5) * torch.tensor([0.02 * 180.0, 0.2 * 256.0, 0.2 * 256.0], device=x.device)
    hls = bgr_to_hls(x)
    d = d[:, None, None, :]
    h = torch.remainder(hls[..., 0] + d[..., 0], 180.0)
    l = torch.clamp(hls[..., 1] + d[..., 1], 0.0, 255.0)
    s = torch.clamp(hls[..., 2] + d[..., 2], 0.0, 255.0)
    x = torch.clamp(hls_to_bgr(torch.stack([h, l, s], dim=-1)), 0.0, 255.0)
    sigma = torch.where(draws["noise/gate"] < 0.9, torch.sqrt(draws["noise/sigma"] * 0.3 * 256.0),
                        torch.zeros((), device=x.device))
    x = torch.clamp(x + sigma[:, None, None, None] * draws["noise/field"][..., None], 0.0, 255.0)
    return x - torch.tensor(pixel_means, dtype=torch.float32, device=x.device)


# ------------------------------------------------------------ vertex targets


def direction_targets(label: torch.Tensor, centers: torch.Tensor):
    """Each pixel's unit direction to the nearest GT centre of its class and
    that centre's log depth (B,H,W,3), and whether it has one (B,H,W)."""
    B, H, W = label.shape
    cls = centers[..., 0].long()
    xs = torch.arange(W, dtype=torch.float32, device=label.device)
    ys = torch.arange(H, dtype=torch.float32, device=label.device)
    d2 = (centers[..., 2][:, :, None, None] - ys[:, None]) ** 2 + (centers[..., 1][:, :, None, None] - xs) ** 2
    match = (cls[:, :, None, None] == label[:, None].long()) & (cls > 0)[:, :, None, None]
    g = torch.argmin(torch.where(match, d2, torch.full((), float("inf"), device=label.device)), dim=1)
    found = match.any(dim=1)
    e = torch.gather(centers[..., 1:4], 1, g.reshape(B, -1, 1).expand(B, H * W, 3)).reshape(B, H, W, 3)
    dx, dy = e[..., 0] - xs, e[..., 1] - ys[:, None]
    n = torch.sqrt(dx * dx + dy * dy) + 1e-10
    return torch.stack([dx / n, dy / n, torch.log(torch.clamp(e[..., 2], min=1e-10))], dim=-1), found


def vertex_targets(label: torch.Tensor, centers: torch.Tensor, C: int) -> torch.Tensor:
    """(B,H,W,3C): each foreground pixel's 3 targets in its class's block."""
    t3, found = direction_targets(label, centers)
    fg = (label > 0) & found
    onehot = torch.nn.functional.one_hot(torch.where(fg, label.long(), 0), C).float() * fg[..., None]
    return (onehot[..., None] * t3[..., None, :]).reshape(*label.shape, 3 * C)


def vertex_loss(pred: torch.Tensor, label: torch.Tensor, centers: torch.Tensor, C: int, w_in: float) -> torch.Tensor:
    """Smooth L1 (sigma 1) of each foreground pixel's 3 predictions of its
    class, weighted w_in, over 3 x the weights' sum."""
    t3, found = direction_targets(label, centers)
    B, H, W = label.shape
    w = torch.where((label > 0) & found, torch.tensor(w_in, device=label.device), 0.0)
    lab = label.long().clamp(0, C - 1)
    p3 = torch.gather(pred.reshape(B, H, W, C, 3), 3, lab[..., None, None].expand(B, H, W, 1, 3))[..., 0, :]
    diff = w[..., None] * (p3 - t3)
    a = diff.abs()
    quad = (a < 1.0).float()
    return (diff * diff * 0.5 * quad + (a - 0.5) * (1 - quad)).sum() / (3.0 * w.sum() + 1e-10)


def hard_label_ce(score: torch.Tensor, gt: torch.Tensor, threshold: float) -> torch.Tensor:
    """Cross entropy of log_softmax(score) at the GT class over the pixels
    whose GT is a foreground class or whose GT probability is below the
    threshold (the gate is not differentiated)."""
    C = score.shape[-1]
    logp = torch.gather(P.log_softmax(score), -1, gt.long().clamp(0, C - 1)[..., None])[..., 0]
    gate = ((gt != -1) & ((gt > 0) | (torch.exp(logp) < threshold))).float().detach()
    return -(gate * logp).sum() / (gate.sum() + 1e-10)


# -------------------------------------------------------------------- Hough


def quat2mat(q: torch.Tensor) -> torch.Tensor:
    s, u, v, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([s * s + u * u - v * v - w * w, 2 * (u * v - s * w), 2 * (u * w + s * v)], -1),
        torch.stack([2 * (u * v + s * w), s * s - u * u + v * v - w * w, 2 * (v * w - s * u)], -1),
        torch.stack([2 * (u * w - s * v), 2 * (v * w + s * u), s * s - u * u - v * v + w * w], -1),
    ], -2)


def corners(extent: torch.Tensor) -> torch.Tensor:
    return torch.tensor(CORNER_SIGNS, dtype=torch.float32, device=extent.device) * (extent * 0.5)[..., None, :]


def box_threshold(extent, fx, fy, px, py, distance):
    """0.6 x the larger side of the extent box projected at each distance."""
    c = corners(extent)
    X, Y, Z = c[:, None, :, 0], c[:, None, :, 1], c[:, None, :, 2] + distance[..., None]
    x, y = fx * (X / Z) + px, fy * (Y / Z) + py
    return torch.maximum(x.amax(-1) - x.amin(-1) + 1, y.amax(-1) - y.amin(-1) + 1) * 0.6


def votes(samples: torch.Tensor, centers: torch.Tensor, chunk: int = 2048):
    """Each (slot, centre)'s count of valid samples whose direction points
    at it within the inlier cosine and whose box holds it, and the sum of
    their depths. samples (S,8,P); centers (1 or S, 2, N)."""
    px, py, u, v, d, thr, tsq, val = [samples[:, i, :, None] for i in range(8)]
    vs, ds = [], []
    for c0 in range(0, centers.shape[2], chunk):
        dx = centers[:, 0, None, c0:c0 + chunk] - px
        dy = centers[:, 1, None, c0:c0 + chunk] - py
        dot = u * dx + v * dy
        ok = ((dot > 0) & (dot * dot > tsq * (dx * dx + dy * dy)) & (dx.abs() < thr) & (dy.abs() < thr)
              & (val > 0)).float()
        vs.append(ok.sum(1))
        ds.append((ok * d).sum(1))
    return torch.cat(vs, 1), torch.cat(ds, 1)


def iou(a, b):
    w = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]) + 1, min=0.0)
    h = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]) + 1, min=0.0)
    inter = w * h
    sa = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    sb = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    return inter / (sa + sb - inter)


def hough(label: torch.Tensor, vert: torch.Tensor, extents: torch.Tensor, meta: torch.Tensor, gt: torch.Tensor,
          hc: Dict) -> Dict[str, torch.Tensor]:
    """One detection a class slot, 9 rows a detection: label (B,H,W), vert
    (B,H,W,3C), gt (G,13). Returns rois (R,7), poses_init (R,7),
    poses_target and poses_weight (R,4C), valid (R,)."""
    if hc["sampler"] != "approx":
        raise ValueError(f"the reference votes with the approx sampler, not {hc['sampler']!r}")
    dev = label.device
    B, H, W = label.shape
    C, S, Pm, cs, RW = hc["num_classes"], hc["slots"], hc["samples"], hc["center_stride"], hc["refine_window"]
    g = hc["pixel_stride"]
    t2 = INLIER_THRESHOLD ** 2
    gxs = torch.arange(0, W, cs, device=dev).float()
    gys = torch.arange(0, H, cs, device=dev).float()
    gw = gxs.shape[0]
    coarse = torch.stack([gxs.repeat(gys.shape[0]), gys.repeat_interleave(gw)])[None]
    cand = (torch.arange(0, H, g, device=dev)[:, None] * W + torch.arange(0, W, g, device=dev)).reshape(-1)
    sl = torch.arange(S, device=dev)
    per = []
    for b in range(B):
        lab, vv, m = label[b].reshape(-1), vert[b].reshape(H * W, 3 * C), meta[b]
        fx, px0, fy, py0 = m[0], m[2], m[4], m[5]
        ids = torch.arange(C, device=dev)
        counts = (lab[None] == ids[:, None]).sum(1)
        act = (counts > hc["label_threshold"]) & (ids > 0)
        order = torch.sort(torch.where(act, ids, torch.full_like(ids, C))).values
        if S > C:
            order = torch.cat([order, torch.full((S - C,), C, dtype=order.dtype, device=dev)])
        slot_valid = order[:S] < C
        cls = torch.where(slot_valid, order[:S], torch.zeros_like(order[:S]))
        ext = extents[cls]
        # the first Pm pixels of the slot's class on the candidate grid, row-major
        mk = (lab[cand][None] == cls[:, None]) & slot_valid[:, None]
        rank = torch.cumsum(mk, 1) - 1
        keep = mk & (rank < Pm)
        samp = torch.zeros((S, Pm + 1), dtype=torch.int64, device=dev)
        samp.scatter_(1, torch.where(keep, rank, torch.full_like(rank, Pm)), cand.expand(S, -1))
        idx = samp[:, :Pm]
        sval = torch.arange(Pm, device=dev)[None] < keep.sum(1)[:, None]
        sx, sy = (idx % W).float(), (idx // W).float()
        col = 3 * cls[:, None]
        su = torch.where(sval, vv[idx, col], 0.0)
        sv = torch.where(sval, vv[idx, col + 1], 0.0)
        sd = torch.where(sval, torch.exp(vv[idx, col + 2]), 0.0)
        sthr = box_threshold(ext, fx, fy, px0, py0, sd)
        packed = torch.stack([sx, sy, su, sv, sd, sthr, t2 * (su * su + sv * sv), sval.float()], 1)
        vt, _ = votes(packed, coarse)
        best = torch.argmax(vt, 1)
        bx, by = gxs[best % gw], gys[best // gw]
        half = (RW - cs) // 2
        x0 = torch.clamp(bx - half, 0, W - RW)
        y0 = torch.clamp(by - half, 0, H - RW)
        off = torch.arange(RW, device=dev).float()
        cxs, cys = x0[:, None] + off, y0[:, None] + off
        win = torch.stack([cxs.repeat(1, RW), cys.repeat_interleave(RW, 1)], 1)
        v2, d2 = votes(packed, win)
        j = torch.argmax(v2, 1)
        cx, cy = cxs[sl, j % RW], cys[sl, j // RW]
        vb, db = v2[sl, j], d2[sl, j]
        dist = torch.where(vb > 0, db / torch.clamp(vb, min=1.0), 0.0)
        thr = box_threshold(ext, fx, fy, px0, py0, dist[:, None])
        dx, dy = sx - cx[:, None], sy - cy[:, None]
        dot = su * (cx[:, None] - sx) + sv * (cy[:, None] - sy)
        inl = (dot > 0) & (dot * dot > (t2 * (su * su + sv * sv)) * (dx * dx + dy * dy))
        okb = (dx.abs() < thr) & (dy.abs() < thr) & inl & sval
        bw = torch.where(vb > 0, 2.0 * torch.where(okb, dx.abs(), -1.0).amax(1), 0.0)
        bh = torch.where(vb > 0, 2.0 * torch.where(okb, dy.abs(), -1.0).amax(1), 0.0)
        box = torch.stack([cx - bw * 0.55, cy - bh * 0.55, cx + bw * 0.55, cy + bh * 0.55], 1)
        one, zero = torch.ones_like(dist), torch.zeros_like(dist)
        pose = torch.stack([one, zero, zero, zero, (cx - px0) / fx * dist, (cy - py0) / fy * dist, dist], 1)
        # the GT quaternion of the first GT row of the class and image whose
        # projected extent box overlaps the detection's by IoU > 0.2
        gcls = gt[:, 1]
        pc = corners(extents[torch.clamp(gcls.long(), 0, C - 1)]) @ quat2mat(gt[:, 6:10]).transpose(-1, -2) \
            + gt[:, None, 10:13]
        gx_, gy_ = fx * pc[..., 0] / pc[..., 2] + px0, fy * pc[..., 1] / pc[..., 2] + py0
        gbox = torch.stack([gx_.amin(-1), gy_.amin(-1), gx_.amax(-1), gy_.amax(-1)], 1)
        match = ((gcls.long()[None] == cls[:, None]) & (gt[:, 0].long()[None] == b) & (gcls[None] > 0)
                 & (iou(box[:, None], gbox[None]) > 0.2))
        found = match.any(1)
        quat = gt[torch.argmax(match.to(torch.uint8), 1), 6:10] * found[:, None]
        cols = 4 * cls[:, None] + torch.arange(4, device=dev)
        tgt = torch.zeros((S, 4 * C), device=dev).scatter(1, cols, quat)
        wgt = torch.zeros((S, 4 * C), device=dev).scatter(1, cols, (found & slot_valid).float()[:, None].expand(S, 4))
        per.append((cls, slot_valid, box, vb, pose, torch.where(slot_valid[:, None], tgt, 0.0), wgt))
    cls, valid, box, score, pose, tgt, wgt = [torch.stack(t) for t in zip(*per)]
    J = len(JITTER)
    sh = torch.tensor(JITTER, dtype=torch.float32, device=dev)
    ww, hh = (box[..., 2] - box[..., 0])[..., None], (box[..., 3] - box[..., 1])[..., None]
    x1, y1 = box[..., None, 0] + sh[:, 0] * 0.05 * ww, box[..., None, 1] + sh[:, 1] * 0.05 * hh
    boxes = torch.stack([x1, y1, x1 + ww, y1 + hh], -1)
    R = B * S * J

    def rows(x):
        return x[:, :, None].expand(B, S, J, *x.shape[2:]).reshape(R, *x.shape[2:])

    bcol = torch.arange(B, device=dev).float()[:, None].expand(B, S)
    rois = torch.cat([rows(bcol)[:, None], rows(cls.float())[:, None], boxes.reshape(R, 4), rows(score)[:, None]], -1)
    v = rows(valid)
    z = lambda x: torch.where(v[:, None], x, 0.0)  # noqa: E731
    return {"rois": z(rois), "poses_init": z(rows(pose)), "poses_target": z(rows(tgt)),
            "poses_weight": z(rows(wgt)), "valid": v}


# --------------------------------------------------------- pose branch


def crop_pool(feat: torch.Tensor, rois: torch.Tensor, scale: float, p: int = 7) -> torch.Tensor:
    """Each roi cropped bilinearly to (2p)^2 samples at the cells' centres
    (coordinates clipped to the map), then 2x2 max pooled: feat (B,H,W,C),
    rois (B,D,7) -> (B,D,p,p,C)."""
    B, H, W, Cf = feat.shape
    D, n = rois.shape[1], 2 * p
    x1, y1, x2, y2 = (rois[..., k] * scale for k in (2, 3, 4, 5))
    t = (torch.arange(n, dtype=torch.float32, device=feat.device) + 0.5) / n
    sx, sy = x1[..., None] + t * (x2 - x1)[..., None], y1[..., None] + t * (y2 - y1)[..., None]
    x0, y0 = torch.clamp(torch.floor(sx).long(), 0, W - 1), torch.clamp(torch.floor(sy).long(), 0, H - 1)
    xa, ya = torch.clamp(x0 + 1, 0, W - 1), torch.clamp(y0 + 1, 0, H - 1)
    zero, one = torch.zeros((), device=feat.device), torch.ones((), device=feat.device)
    ax = torch.minimum(torch.maximum(sx - x0, zero), one)[:, :, None, :, None]
    ay = torch.minimum(torch.maximum(sy - y0, zero), one)[:, :, :, None, None]
    flat = feat.reshape(B, H * W, Cf)

    def at(yy, xx):
        i = (yy[..., :, None] * W + xx[..., None, :]).reshape(B, D * n * n, 1)
        return torch.gather(flat, 1, i.expand(B, D * n * n, Cf)).reshape(B, D, n, n, Cf)

    crops = (at(y0, x0) * (1 - ax) + at(y0, xa) * ax) * (1 - ay) + (at(ya, x0) * (1 - ax) + at(ya, xa) * ax) * ay
    pooled = torch.nn.functional.max_pool2d(crops.reshape(B * D, n, n, Cf).permute(0, 3, 1, 2), 2, 2)
    return pooled.permute(0, 2, 3, 1).reshape(B, D, p, p, Cf)


def add_loss(pred, target, weight, points, symmetry, margin: float) -> torch.Tensor:
    """ADD (ADD-S for a symmetric class: each point to its nearest GT
    point) hinge loss: sum over rows and points of max(d^2 - margin, 0) / 2
    over rows x points, on each row's first weighted class."""
    N, C = pred.shape[0], points.shape[0]
    act = weight.reshape(N, C, 4)[:, :, 0] > 0
    has = act.any(1)
    ci = torch.argmax(act.to(torch.uint8), 1)
    i4 = ci[:, None] * 4 + torch.arange(4, device=pred.device)
    pts = points[ci]
    x1 = torch.einsum("nij,npj->npi", quat2mat(torch.gather(pred, 1, i4)), pts)
    x2 = torch.einsum("nij,npj->npi", quat2mat(torch.gather(target, 1, i4)), pts)
    m = torch.arange(pts.shape[1], device=pred.device)[None].repeat(N, 1)
    sym = torch.nonzero(symmetry[ci] > 0)[:, 0]
    if sym.numel():
        d_all = ((x1.detach()[sym, :, None, :] - x2[sym, None, :, :]) ** 2).sum(-1)
        m[sym] = torch.argmin(d_all, dim=2)
    x2 = torch.gather(x2, 1, m[..., None].expand(-1, -1, 3))
    d2 = ((x1 - x2) ** 2).sum(-1)
    on = (d2 >= margin) & has[:, None]
    return torch.where(on, (d2 - margin) / (2.0 * N * pts.shape[1]), torch.zeros((), device=pred.device)).sum()


# --------------------------------------------------------------------- step


def step_loss(params, cfg: Dict, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor], consts,
              follow: Optional[Dict[str, torch.Tensor]], q: P.Quant):
    """The flagship loss of one step. `follow`: the judged side's Hough
    inputs (label (B,H,W), vert (B,H,W,3C)) for the images that vote from
    the network's maps; None to vote from this side's own maps. Returns
    (loss, terms, extra: the Hough inputs and outputs)."""
    C, keep, scale = cfg["NUM_CLASSES"], cfg["keep_prob"], cfg.get("trunk_scale", 1.0)
    points, symmetry, extents = consts
    x = augment(batch["data"], draws, cfg["PIXEL_MEANS"])
    net = P.trunk(params, x, scale, q)
    c5, c4 = net["conv5_3"], net["conv4_3"]

    def head(name, inp, relu):
        return P.conv2d(params[name + ".weight"], params[name + ".bias"], inp, relu, q)

    s5 = head("score_conv5", c5, True)
    s4 = head("score_conv4", c4, True)
    add = P.dropout(s4 + P.upsample(s5, 4, 2), keep, draws["dropout/add_score"])
    score = torch.relu(P.upsample(P.conv2d(params["score.weight"], None, add, False, q), 16, 8) + params["score.bias"])
    v5 = head("score_conv5_vertex", c5, False)
    v4 = head("score_conv4_vertex", c4, False)
    addv = P.dropout(v4 + P.upsample(v5, 4, 2), keep, draws["dropout/addv"])
    vert = P.upsample(P.conv2d(params["vertex_pred.weight"], None, addv, False, q), 16, 8) + params["vertex_pred.bias"]
    label = batch["label"].long()

    with torch.no_grad():
        pick_gt = draws["hough_gt_mix"] < cfg["hough"]["gt_mix"]
        own_label, own_vert = torch.argmax(P.softmax(score), -1), vert.detach()
        if follow is not None:
            own_label, own_vert = follow["label"].long(), follow["vert"].float()
        h_label = torch.where(pick_gt[:, None, None], label, own_label)
        h_vert = torch.where(pick_gt[:, None, None, None], vertex_targets(label, batch["centers"], C), own_vert)
        hc = dict(cfg["hough"], num_classes=C)
        hout = hough(h_label, h_vert, extents, batch["meta"], batch["poses"], hc)

    B = x.shape[0]
    R = hout["rois"].shape[0]
    rb = hout["rois"].reshape(B, R // B, 7)
    pool = (crop_pool(c5, rb, 1.0 / 16.0) + crop_pool(c4, rb, 1.0 / 8.0)).reshape(R, 7, 7, -1)
    f6 = P.dropout(P.linear(params["fc6.weight"], params["fc6.bias"], pool, True, q), keep, draws["dropout/fc6"])
    f7 = P.dropout(P.linear(params["fc7.weight"], params["fc7.bias"], f6, True, q), keep, draws["dropout/fc7"])
    f8 = P.linear(params["fc8.weight"], params["fc8.bias"], f7, False, q)
    mul = torch.tanh(f8) * hout["poses_weight"]
    pred = mul * torch.rsqrt(torch.clamp((mul * mul).sum(1, keepdim=True), min=1e-12))

    hp = cfg["loss"]
    terms = {"loss_regu": P.l2_term(params, cfg["WEIGHT_REG"]),
             "loss_cls": hard_label_ce(score, label, cfg["threshold_label"]),
             "loss_vertex": hp["vertex_w"] * vertex_loss(vert, label, batch["centers"], C, hp["vertex_w_inside"])}
    n_valid = torch.clamp(hout["valid"].float().sum(), min=1.0)
    pose = add_loss(pred, hout["poses_target"], hout["poses_weight"], points, symmetry, cfg["POSE_MARGIN"])
    if cfg["POSE_NORM_VALID"]:
        pose = pose * (R / n_valid)
    terms["loss_pose"] = hp["pose_w"] * pose
    Cq = pred.shape[1] // 4
    qp, qt = pred.reshape(-1, Cq, 4), hout["poses_target"].reshape(-1, Cq, 4)
    wq = hout["poses_weight"].reshape(-1, Cq, 4)[..., 0]
    per = torch.minimum(((qp - qt) ** 2).sum(-1), ((qp + qt) ** 2).sum(-1)) * wq * (symmetry[:Cq] <= 0).float()[None]
    terms["loss_quat"] = cfg["QUAT_AUX_W"] * per.sum() / n_valid
    loss = sum(terms.values())
    terms["loss"] = loss
    extra = {"hough": {k: hout[k].detach() for k in ("rois", "poses_init", "valid")},
             "follow": {"label": own_label.to(torch.int32), "vert": own_vert},
             "heads": {"score": score.detach(), "vert": vert.detach()}}
    return loss, {k: v.detach() for k, v in terms.items()}, extra


def run(cfg: Dict, weights: Dict[str, torch.Tensor], steps: List[Dict], device, follow: Optional[List] = None,
        precision: Optional[str] = None) -> Dict:
    """The reference's first len(steps) training steps from `weights` (the
    dict is updated in place). steps[s]: {"frames": frame ids, "draws":
    the step's draws by name}; follow[s]: the judged side's Hough inputs
    (`step_loss`). Returns `_plain.train_steps`' readings."""
    P.strict_float32()
    q = P.Quant(precision)
    pts, sym, ext, _ = object_models(cfg)
    consts = tuple(torch.from_numpy(a).to(device) for a in (pts, sym, ext))
    frames_dir = cfg["frames_dir"]
    cache: Dict[int, Dict] = {}

    def frame(i):
        if i not in cache:
            cache[i] = load_frame(frames_dir, i)
        return cache[i]

    def loss_fn(params, s):
        st = steps[s]
        batch = make_batch([frame(int(i)) for i in st["frames"]], cfg["MAX_GT"], device)
        draws = {k: v.to(device) for k, v in st["draws"].items()}
        fol = None if follow is None else {k: v.to(device) for k, v in follow[s].items()}
        loss, terms, extra = step_loss(params, cfg, batch, draws, consts, fol, q)
        if s > 0:
            del extra["heads"]  # the heads are compared at the first step
        return loss, terms, extra

    lr = cfg["LEARNING_RATE"]
    return P.train_steps(weights, loss_fn, len(steps), lambda s: lr * cfg["GAMMA"] ** (s // cfg["STEPSIZE"]),
                         cfg["MOMENTUM"], cfg["GRAD_CLIP"])
