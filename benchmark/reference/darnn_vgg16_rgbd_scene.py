"""The plain reference of the DA-RNN video segmenter's training step
(Xiang & Fox, RSS 2017; `configs/darnn_vgg16_rgbd_scene.json`).

A window of T frames, B videos: each frame's VGG16 trunk, the two-scale
label fusion (1x1 convolutions of conv5_3 and conv4_3, the fixed bilinear
upsamplings), the recurrent state warped from the previous frame (each
pixel's camera point moved into the frame by the camera motion in its
meta data, projected, and the state averaged over the previous frame's
pixels within `flow_kernel` of it whose depth agrees within
`flow_threshold`, the weights capped at `flow_max_weight`), the GRU's
weighted fusion, the 1x1 score; the mean over the frames of each frame's
cross entropy, the L2 term, and momentum SGD, in float32.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import _plain as P


def param_specs(cfg: Dict) -> List:
    C, U = cfg["NUM_CLASSES"], cfg["NUM_UNITS"]
    scale = cfg.get("trunk_scale", 1.0)
    c5 = P.scaled(512, scale)
    return (P.trunk_specs("trunk.", scale, cfg["init_std"]["input_std"]) + P.conv_spec("score_conv5", c5, U, 1)
            + P.conv_spec("score_conv4", c5, U, 1) + P.conv_spec("score", U, C, 1, cfg["init_std"]["score"])
            + P.conv_spec("gru2d.Gates", 2 * U, U, 1))


def fold_labels(label: np.ndarray, fold: Dict) -> np.ndarray:
    """The frames' class ids folded into the configuration's classes: 0
    stays 0, class c > 0 becomes 1 + (c - 1) % (classes - 1)."""
    k = fold["classes"] - 1
    lab = label.astype(np.int64)
    return np.where(lab > 0, 1 + (lab - 1) % k, 0).astype(np.int32)


def load_frame(frames_dir: str, i: int, cfg: Dict) -> Dict[str, np.ndarray]:
    """Frame i: data (H,W,3) float32 BGR minus the pixel means, its folded
    label, depth in metres, and meta (48,) with K, its inverse and the
    camera motion to the window's first frame (none: these frames carry no
    camera pose, so both motions are [I | 0])."""
    with np.load(os.path.join(frames_dir, f"{i:06d}.npz")) as d:
        color, label, depth, K = d["color"], d["label"], d["depth"], d["intrinsic_matrix"]
        factor = float(d["factor_depth"])
    Kd = np.asarray(K, np.float64).copy()
    Kd[2, 2] = 1
    meta = np.zeros(48, np.float32)
    meta[0:9] = Kd.flatten()
    meta[9:18] = np.linalg.pinv(Kd).flatten()
    eye = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32).flatten()
    meta[18:30] = eye
    meta[30:42] = eye
    means = np.asarray(cfg["PIXEL_MEANS"], np.float64)
    return {"data": (color.astype(np.float32) - means).astype(np.float32),
            "label": fold_labels(label, cfg["label_fold"]), "depth": depth.astype(np.float32) / factor,
            "meta": meta}


def _to_int(x: torch.Tensor) -> torch.Tensor:
    """float -> int as XLA converts: NaN to 0, out of range clamped,
    truncated toward zero."""
    lim = 2.0 ** 31
    return torch.nan_to_num(x.double(), nan=0.0, posinf=lim - 1, neginf=-lim).clamp(-lim, lim - 1).long()


def warp(state, weights, points, depth, meta, k: int, threshold: float, max_weight: float):
    """The previous frame's (state, weights) averaged at each pixel over
    the matching pixels of a (2k+1)^2 window around where its point lands
    in the previous frame; (0, 1) where none matches. Returns (state,
    weights, this frame's points)."""
    B, H, W, U = state.shape
    K, Kinv, l2w = meta[:, 0:9].reshape(B, 3, 3), meta[:, 9:18].reshape(B, 3, 3), meta[:, 30:42].reshape(B, 3, 4)
    ws = torch.arange(W, dtype=torch.float32, device=depth.device)
    hs = torch.arange(H, dtype=torch.float32, device=depth.device)
    ones = torch.ones((H, W), device=depth.device)
    rays = torch.stack([ws[None, :].expand(H, W), hs[:, None].expand(H, W), ones], -1)
    with torch.no_grad():
        pts = depth[..., None] * torch.einsum("bij,hwj->bhwi", Kinv, rays)
        world = torch.einsum("bij,bhwj->bhwi", l2w[:, :, :3], pts) + l2w[:, None, None, :, 3]
        pix = torch.einsum("bij,bhwj->bhwi", K, world)
        px, py = _to_int(torch.round(pix[..., 0] / pix[..., 2])), _to_int(torch.round(pix[..., 1] / pix[..., 2]))
        has = depth > 0
        z_prev = points[..., 2].reshape(B, H * W)
    src = torch.cat([state, torch.minimum(weights, torch.tensor(max_weight, device=state.device))], -1)
    src = src.reshape(B, H * W, 2 * U)
    acc = torch.zeros((B, H, W, 2 * U), device=state.device)
    count = torch.zeros((B, H, W), device=state.device)
    for dx in range(-k, k + 1):
        for dy in range(-k, k + 1):
            x, y = px + dx, py + dy
            lin = y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
            with torch.no_grad():
                zp = torch.gather(z_prev, 1, lin.reshape(B, -1)).reshape(B, H, W)
                m = ((x >= 0) & (x < W) & (y >= 0) & (y < H) & has & ((zp - world[..., 2]).abs() < threshold)).float()
            taken = torch.gather(src, 1, lin.reshape(B, -1, 1).expand(B, H * W, 2 * U)).reshape(B, H, W, 2 * U)
            acc = acc + m[..., None] * taken
            count = count + m
    mean = acc / torch.clamp(count, min=1.0)[..., None]
    hit = (count > 0)[..., None]
    new_pts = torch.where(has[..., None], pts, torch.full((), float("nan"), device=depth.device))
    return (torch.where(hit, mean[..., :U], 0.0), torch.where(hit, mean[..., U:], 1.0), new_pts)


def step_loss(params, cfg: Dict, batch: Dict[str, torch.Tensor], q: P.Quant):
    """The mean over the T frames of each frame's cross entropy, plus L2."""
    T, B, H, W, _ = batch["data"].shape
    C, U, scale = cfg["NUM_CLASSES"], cfg["NUM_UNITS"], cfg.get("trunk_scale", 1.0)
    fk = cfg["flow"]
    dev = batch["data"].device
    state = torch.zeros((B, H, W, U), device=dev)
    weights = torch.ones((B, H, W, U), device=dev)
    points = torch.full((B, H, W, 3), float("nan"), device=dev)
    classes = torch.arange(C, device=dev)
    ce, scores, frame_grads = 0.0, [], [0.0] * T
    for t in range(T):
        net = P.trunk(params, batch["data"][t], scale, q)
        s5 = P.conv2d(params["score_conv5.weight"], params["score_conv5.bias"], net["conv5_3"], True, q)
        s4 = P.conv2d(params["score_conv4.weight"], params["score_conv4.bias"], net["conv4_3"], True, q)
        up = P.upsample(s4 + P.upsample(s5, 4, 2), 16, 8)
        ws, ww, points = warp(state, weights, points, batch["depth"][t], batch["meta"][t], fk["kernel"],
                              fk["threshold"], fk["max_weight"])
        u = torch.sigmoid(P.conv2d(params["gru2d.Gates.weight"], params["gru2d.Gates.bias"],
                                   torch.cat([up, ws], -1), False, q))
        weights = ww + u
        state = torch.relu((ww * ws + u * up) / weights)
        score = P.conv2d(params["score.weight"], params["score.bias"], state, True, q)
        scores.append(score.detach())
        if score.requires_grad:  # each frame's dL/dscore norm, in the backward
            score.register_hook(lambda g, t=t: frame_grads.__setitem__(t, float(torch.linalg.vector_norm(g.double()))))
        onehot = (batch["label"][t].long()[..., None] == classes).float()
        ce = ce + P.cross_entropy_onehot(P.log_softmax(score), onehot)
    terms = {"loss_cls": ce / T, "loss_regu": P.l2_term(params, cfg["WEIGHT_REG"])}
    loss = terms["loss_cls"] + terms["loss_regu"]
    terms["loss"] = loss
    return loss, {k: v.detach() for k, v in terms.items()}, {"heads": {"score": torch.stack(scores),
                                                                      "state": state.detach()},
                                                            "frame_grads": frame_grads}


def run(cfg: Dict, weights: Dict[str, torch.Tensor], steps: List[Dict], device, follow: Optional[List] = None,
        precision: Optional[str] = None) -> Dict:
    """The reference's first len(steps) training steps from `weights`
    (updated in place); steps[s]["frames"] is the (T, B) array of frame ids
    of step s's window. Returns `_plain.train_steps`' readings."""
    P.strict_float32()
    q = P.Quant(precision)

    def loss_fn(params, s):
        ids = np.asarray(steps[s]["frames"])
        fr = [[load_frame(cfg["frames_dir"], int(i), cfg) for i in row] for row in ids]
        batch = {k: torch.from_numpy(np.stack([np.stack([f[k] for f in row]) for row in fr])).to(device)
                 for k in ("data", "label", "depth", "meta")}
        loss, terms, extra = step_loss(params, cfg, batch, q)
        return loss, terms, extra if s == 0 else {}

    lr = cfg["LEARNING_RATE"]
    return P.train_steps(weights, loss_fn, len(steps), lambda s: lr * cfg["GAMMA"] ** (s // cfg["STEPSIZE"]),
                         cfg["MOMENTUM"], cfg["GRAD_CLIP"])
