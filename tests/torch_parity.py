"""Shared helpers of the PyTorch port's parity tests (holds no tests).

Inputs are made with numpy and handed to both packages; JAX stays on the
CPU. `goldens()` loads tools/make_torch_goldens.py, which writes (and the
tests regenerate) the JAX goldens under tests/golden/. The golden checks
(`check_hough_golden`, `check_slice_golden`, `check_train_golden`,
`check_render_golden`, `check_host_images` with the bilateral filter's
limits of `check_bilateral`), the
bf16 limit of the conv3x3 kernel (`bf16_ulp_excess`) and the GT pose rows
put at a forward's detections (`gt_rows_at_detections`) are shared by the
CPU tests, tests/test_torch_cuda.py and chip_smoke.py, so all hold the
port to one limit. So are the dataset trees (`write_lov_tree`,
`write_syn_tree`, `write_linemod_tree`, `write_scene_tree`): each dataset's
on-disk layout, written with the port's PNG writer and scipy from the
frozen frames of data/lov_syn_val_v4/, the same bytes on every host. The
module imports no JAX at module level.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def goldens():
    """The tools/make_torch_goldens.py module."""
    path = os.path.join(ROOT, "tools", "make_torch_goldens.py")
    spec = importlib.util.spec_from_file_location("make_torch_goldens", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_npz(path: str) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def slice_cfgs(golden: dict, jax_dtype, torch_dtype, **over):
    """(JAX PoseCNNConfig, port PoseCNNConfig) from a small-slice golden."""
    from posecnn_tpu.models.posecnn import PoseCNNConfig as JaxCfg
    from posecnn_torch.config import PoseCNNConfig

    kw = {k[len("cfg/"):]: golden[k].item() for k in golden if k.startswith("cfg/")}
    kw.update(over)
    return JaxCfg(compute_dtype=jax_dtype, **kw), PoseCNNConfig(compute_dtype=torch_dtype, **kw)


def golden_weights(golden: dict) -> dict:
    """The golden's weights, flat npz key paths (`['params']['conv1_1']['weights']`)."""
    return {k[len("weights/"):]: golden[k] for k in golden if k.startswith("weights/")}


def vote_samples(rng: np.random.RandomState, S: int, P: int, W: int, H: int) -> np.ndarray:
    """(S, 8, P) packed Hough samples in the range the front end produces:
    integer pixel coordinates, unit directions, depths, box thresholds,
    (0.9*|uv|)^2 and a validity row with some invalid samples."""
    px = rng.randint(0, W, (S, P)).astype(np.float32)
    py = rng.randint(0, H, (S, P)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (S, P)).astype(np.float32)
    u, v = np.cos(ang), np.sin(ang)
    d = rng.uniform(0.5, 2.0, (S, P)).astype(np.float32)
    thr = rng.uniform(2.0, 0.5 * max(W, H), (S, P)).astype(np.float32)
    tsq = np.float32(0.81) * (u * u + v * v)
    val = (rng.rand(S, P) > 0.2).astype(np.float32)
    return np.stack([px, py, u, v, d, thr, tsq, val], axis=1).astype(np.float32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def vote_inputs_from_gt(label, vert, meta, extents, settings: dict, max_samples: int, device="cpu") -> dict:
    """The vote kernel's inputs on the main path for a frame's ground truth
    (label (H,W), vertex field (H,W,3C), meta (48,), extents (C,3), numpy)
    at Hough `settings` (`make_torch_goldens.HOUGH_SETTINGS`' keys) with
    `max_samples` samples a slot, made by the functions `hough_voting`
    calls: the packed samples (S, 8, P), the coarse grid (1, 2, NC) and its
    width, and the refine windows (S, 2, RW*RW) around the coarse argmax of
    the plain version's votes."""
    from posecnn_torch.ops import hough_voting as HV
    from posecnn_torch.ops.voting import accumulate_votes_plain

    s = settings
    H, W = label.shape
    cand = HV.candidate_pixels(H, W, s["pixel_grid_stride"], device)
    _, _, _, samples = HV.slot_samples(
        t(label).reshape(-1).to(device), t(vert).reshape(H * W, -1).to(device), t(meta).to(device),
        t(extents).to(device), cand, W, num_classes=s["num_classes"], class_slots=s["class_slots"],
        label_threshold=s["label_threshold"], skip=1 if s["sampler"] == "approx" else s["skip_pixels"],
        max_samples=max_samples,
    )
    gxs, gys, coarse = HV.coarse_centers(H, W, s["center_stride"], device)
    best = torch.argmax(accumulate_votes_plain(samples, coarse)[0], dim=1)
    gw = gxs.shape[0]
    _, _, window = HV.refine_window_centers(gxs[best % gw], gys[best // gw], H, W, s["center_stride"],
                                            s["refine_window"])
    return {"samples": samples, "coarse": coarse, "grid_w": gw, "window": window}


def path_vote_inputs(frame: str, max_samples: int, device="cpu") -> dict:
    """`vote_inputs_from_gt` for one frozen frame's ground truth at the
    Hough golden's flagship settings (512 samples in inference, 1024 in
    training)."""
    G = goldens()
    label, vert, extents, meta = G.hough_inputs(frame)
    return vote_inputs_from_gt(label, vert, meta, extents, G.HOUGH_SETTINGS, max_samples, device)


# the toy path's Hough settings (experiments/cfgs/toy_pose.yml over the
# TPU defaults and PoseCNNConfig's label_threshold): 96x128 frames, a
# 24x32 coarse grid at stride 4
TOY_HOUGH_SETTINGS = dict(num_classes=4, skip_pixels=1, label_threshold=500, class_slots=8, max_samples=1024,
                          center_stride=4, refine_window=16, pixel_grid_stride=3, sampler="approx")


def toy_vote_inputs(index: int, device="cpu") -> dict:
    """`vote_inputs_from_gt` on the ground truth of toy_train frame `index`
    at the toy path's settings (`TOY_HOUGH_SETTINGS`)."""
    from posecnn_torch.data.toy import toy
    from posecnn_torch.utils.frames import gt_vertex_field
    from posecnn_torch.utils.meta import build_meta_data

    d = toy("train")
    f = d.load_frame(index)
    s = TOY_HOUGH_SETTINGS
    vert = gt_vertex_field(f.label, f.cls_indexes, f.center, f.poses, s["num_classes"])
    return vote_inputs_from_gt(f.label.astype(np.int32), vert, build_meta_data(f.intrinsic_matrix), d._extents, s,
                               s["max_samples"], device)


def vote_edge_cases() -> list:
    """(name, samples (S, 8, P), centers (Sc, 2, NC), grid_w) cases at the
    edges of the vote kernel's per-block box pruning: a sample whose box
    edge lies exactly on a block's extreme centre (|dx| == thr) and one
    ulp inside, non-integer coordinates, an all-invalid slot, every sample
    on one pixel, P of 1, 700 and 1500 (past one and two shared-memory
    chunks of 512), NC
    of 1 and 257, the coarse grid with and without its width, and refine
    windows at the image's corners. numpy float32, from fixed seeds."""
    f32 = np.float32
    cases = []

    def grid(gw, gh, step=4.0, x0=0.0, y0=0.0):
        gx = x0 + np.arange(gw, dtype=f32) * f32(step)
        gy = y0 + np.arange(gh, dtype=f32) * f32(step)
        return np.stack([np.tile(gx, gh), np.repeat(gy, gw)])[None].astype(f32)

    # box edges on the extreme centres of a 40x24 grid at stride 4 (x in
    # [0, 156], y in [0, 92]): samples due left, right, above and below,
    # their box exactly reaching the grid's edge (pruned: no centre can
    # vote) and one ulp wider (kept: the edge centre votes), pointing at it
    rng = np.random.RandomState(11)
    rows = []
    for px, py, u, v, edge in ((-10.0, 40.0, 1.0, 0.0, 10.0), (166.0, 40.0, -1.0, 0.0, 10.0),
                               (60.0, -7.5, 0.0, 1.0, 7.5), (60.0, 99.25, 0.0, -1.0, 7.25),
                               (158.5, 93.5, -0.6, -0.8, 2.5)):
        for thr in (f32(edge), np.nextafter(f32(edge), f32(np.inf))):
            rows.append([px, py, u, v, 1.0 + 0.1 * len(rows), thr, 0.81 * (u * u + v * v), 1.0])
    edge = np.asarray(rows, f32).T[None]  # (1, 8, 10)
    cases.append(("box_edge", edge, grid(40, 24), 40))
    cases.append(("box_edge_consecutive", edge, grid(40, 24), 0))

    # non-integer coordinates, centres and samples, one invalid slot
    s = vote_samples(rng, 4, 300, 160, 96)
    s[:, 0] += rng.uniform(-0.5, 0.5, (4, 300)).astype(f32)
    s[:, 1] += rng.uniform(-0.5, 0.5, (4, 300)).astype(f32)
    s[2, 7] = 0.0  # all-invalid slot
    cases.append(("fractional", s, grid(53, 31, 3.1, 0.37, 0.61), 53))
    cases.append(("fractional_consecutive", s, grid(53, 31, 3.1, 0.37, 0.61), 0))

    # every sample on one pixel
    s = vote_samples(rng, 3, 256, 160, 96)
    s[:, 0], s[:, 1] = 77.0, 41.0
    cases.append(("one_pixel", s, grid(40, 24), 40))

    # sample counts: one sample, 700 and 1500 (two chunks)
    for P in (1, 700, 1500):
        cases.append((f"P{P}", vote_samples(rng, 3, P, 160, 96), grid(40, 24), 40))

    # centre counts: one centre, and 257 (a ragged tile) shared and per slot
    s = vote_samples(rng, 3, 200, 160, 96)
    cases.append(("NC1", s, np.asarray([[[80.0], [48.0]]], f32), 0))
    c257 = np.stack([rng.uniform(0, 160, (3, 257)), rng.uniform(0, 96, (3, 257))], axis=1).astype(f32)
    cases.append(("NC257_per_slot", s, c257, 0))
    cases.append(("NC257_ragged_grid", s, grid(257, 1, 0.5), 257))

    # refine windows (16x16 per slot) at the four corners of a 640x480 image
    s = vote_samples(rng, 4, 512, 640, 480)
    off = np.arange(16, dtype=f32)
    x0 = np.asarray([0, 624, 0, 624], f32)
    y0 = np.asarray([0, 0, 464, 464], f32)
    win = np.stack([np.tile(x0[:, None] + off, (1, 16)), np.repeat(y0[:, None] + off, 16, axis=1)], axis=1)
    s[:, 0] = np.where(np.arange(512) % 2 == 0, x0[:, None] + 8.0, s[:, 0])  # half the samples near
    s[:, 1] = np.where(np.arange(512) % 2 == 0, y0[:, None] + 8.0, s[:, 1])  # their corner
    cases.append(("refine_corners", s, win, 0))
    return [(name, np.ascontiguousarray(s, f32), np.ascontiguousarray(c, f32), gw) for name, s, c, gw in cases]


def hough_on_golden_frame(device="cpu"):
    """The port's `hough_voting` at the Hough golden's flagship settings on
    frame v4/000000's ground truth, on `device`."""
    from posecnn_torch.ops.hough_voting import hough_voting

    G = goldens()
    label, vert, extents, meta = G.hough_inputs()
    s = G.HOUGH_SETTINGS
    return hough_voting(
        t(label[None]).to(device), t(vert[None]).to(device), t(extents).to(device), t(meta[None]).to(device),
        torch.zeros((1, 13), device=device), num_classes=s["num_classes"], is_train=False,
        skip_pixels=s["skip_pixels"], label_threshold=s["label_threshold"], class_slots=s["class_slots"],
        max_samples=s["max_samples"], center_stride=s["center_stride"], refine_window=s["refine_window"],
        pixel_grid_stride=s["pixel_grid_stride"], sampler=s["sampler"],
    )


def check_hough_golden(out) -> dict:
    """Holds a `hough_on_golden_frame` result to the JAX golden: valid rows,
    batch and class exact, rois atol 1e-3, poses_init atol 1e-4 (the mean
    depth is a float sum taken in another order). Returns the max |err|s."""
    g = load_npz(goldens().HOUGH_GOLDEN)
    valid, rois, poses = (x.cpu().numpy() for x in (out.valid, out.rois, out.poses_init))
    np.testing.assert_array_equal(valid, g["valid"])
    np.testing.assert_array_equal(rois[:, :2], g["rois"][:, :2])
    np.testing.assert_allclose(rois, g["rois"], atol=1e-3)
    np.testing.assert_allclose(poses, g["poses_init"], atol=1e-4)
    return {"detections": int(valid.sum()), "classes": rois[valid > 0, 1].astype(int).tolist(),
            "rois": float(np.abs(rois - g["rois"]).max()), "poses_init": float(np.abs(poses - g["poses_init"]).max())}


def small_slice_on_golden(device="cpu"):
    """(port endpoints, golden): the small float32 slice on the golden's
    weights and frame, on `device`."""
    from posecnn_torch.config import PIXEL_MEANS, PoseCNNConfig
    from posecnn_torch.core.convert import make_model
    from posecnn_torch.models.posecnn import posecnn_forward

    g = load_npz(goldens().SLICE_GOLDEN)
    cfg = PoseCNNConfig(compute_dtype=torch.float32,
                        **{k[len("cfg/"):]: g[k].item() for k in g if k.startswith("cfg/")})
    model = make_model(cfg, golden_weights(g), device)
    means = torch.tensor(PIXEL_MEANS, device=device).reshape(1, 1, 1, 3)
    with torch.inference_mode():
        out = posecnn_forward(model, cfg, t(g["raw"]).to(device).float() - means,
                              t(g["extents"]).to(device), t(g["meta"]).to(device))
    return out, g


def check_slice_golden(out, g) -> dict:
    """Holds the small float32 slice to the JAX golden: score and vertex_pred
    within 1e-5 of the golden's largest magnitude (TF32 would miss it by
    ~100x); label_2d, valid rows, batch and class exact; rois atol 1e-3,
    poses_init atol 1e-4, poses_tanh atol 1e-5. Returns the max |err|s."""
    o = {k: v.cpu().numpy() for k, v in out.items() if torch.is_tensor(v)}
    err = {}
    for k in ("score", "vertex_pred"):
        ref = g[f"out/{k}"]
        np.testing.assert_allclose(o[k], ref, atol=1e-5 * np.abs(ref).max(), rtol=0, err_msg=k)
        err[k] = float(np.abs(o[k] - ref).max())
    np.testing.assert_array_equal(o["label_2d"], g["out/label_2d"])
    np.testing.assert_array_equal(o["rois_valid"], g["out/rois_valid"])
    np.testing.assert_array_equal(o["rois"][:, :2], g["out/rois"][:, :2])
    for k, atol in (("rois", 1e-3), ("poses_init", 1e-4), ("poses_tanh", 1e-5)):
        np.testing.assert_allclose(o[k], g[f"out/{k}"], atol=atol, err_msg=k)
        err[k] = float(np.abs(o[k] - g[f"out/{k}"]).max())
    return err


def full_on_golden(device="cpu"):
    """(port outputs, golden): VGG16FULL's inference function
    (`engine.test.make_inference_fn` with `posecnn_full_forward`) at the
    FULL golden's float32 config, its seeded weights, frames, meta and
    extents, on `device`, with prob_normalized and vertex_pred beside the
    outputs the engine keeps."""
    from posecnn_torch.config import PIXEL_MEANS, PoseCNNConfig
    from posecnn_torch.engine.test import make_inference_fn
    from posecnn_torch.models import posecnn_full as PF

    G = goldens()
    g = load_npz(G.FULL_GOLDEN)
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **{k[len("cfg/"):]: g[k].item() for k in g if k.startswith("cfg/")})
    model = PF.make_full_model(cfg, PF.init_posecnn_full_params_numpy(int(g["seed"]), cfg), device)
    dense = {}

    def forward(*a, **k):  # the engine's forward, keeping the dense maps it drops
        out = PF.posecnn_full_forward(*a, **k)
        dense.update(prob_normalized=out["prob_normalized"], vertex_pred=out["vertex_pred"])
        return out

    infer = make_inference_fn(cfg, PIXEL_MEANS, device, forward_fn=forward)
    out = infer(model, t(g["raw"]).to(device), t(g["meta"]).to(device), t(g["extents"]).to(device))
    out.update(dense)
    return out, g


def check_full_golden(out, g) -> dict:
    """Holds VGG16FULL's float32 inference to the JAX golden at the slice
    golden's limits: prob_normalized and vertex_pred within 1e-5 of the
    golden's largest magnitude; label_2d, valid rows, num_rois, batch and
    class exact; rois atol 1e-3, poses_init atol 1e-4, poses_tanh atol
    1e-5. Returns the max |err|s."""
    o = {k: v.cpu().numpy() for k, v in out.items()}
    err = {}
    for k in ("prob_normalized", "vertex_pred"):
        ref = g[f"out/{k}"]
        np.testing.assert_allclose(o[k], ref, atol=1e-5 * np.abs(ref).max(), rtol=0, err_msg=k)
        err[k] = float(np.abs(o[k] - ref).max())
    for k in ("label_2d", "rois_valid", "num_rois"):
        np.testing.assert_array_equal(o[k], g[f"out/{k}"], err_msg=k)
    np.testing.assert_array_equal(o["rois"][:, :2], g["out/rois"][:, :2])
    for k, atol in (("rois", 1e-3), ("poses_init", 1e-4), ("poses_tanh", 1e-5)):
        np.testing.assert_allclose(o[k], g[f"out/{k}"], atol=atol, err_msg=k)
        err[k] = float(np.abs(o[k] - g[f"out/{k}"]).max())
    return err


def resnet50_on_golden(device="cpu"):
    """(port outputs, golden): `resnet50_forward` at float32 on the
    ResNet-50 golden's frames and seeded weights (its score biases), on
    `device` (TF32 off)."""
    from posecnn_torch.config import PIXEL_MEANS
    from posecnn_torch.engine.test import set_float32_precision
    from posecnn_torch.models.resnet50 import make_resnet50, resnet50_forward

    G = goldens()
    g = load_npz(G.RESNET50_GOLDEN)
    n = int(g["num_classes"])
    model = make_resnet50(n, G.resnet50_golden_params(int(g["seed"]), n, g["score_bias"]), device)
    set_float32_precision()
    data = t(g["raw"]).to(device).float() - torch.tensor(PIXEL_MEANS, device=device).reshape(1, 1, 1, 3)
    with torch.no_grad():
        out = resnet50_forward(model, data, n, compute_dtype=torch.float32)
    return out, g


def check_resnet50_golden(out, g, limit: float = 1e-4) -> dict:
    """Holds ResNet-50's float32 forward to the JAX golden: score within
    `limit` of its largest magnitude; label_2d equal wherever the golden's
    two best scores are more than 2 x that limit apart (elsewhere a
    rounding may swap them). Returns score's max |err| and the labels'
    agreement."""
    score, ref = out["score"].cpu().numpy(), g["out/score"]
    tol = limit * np.abs(ref).max()
    np.testing.assert_allclose(score, ref, atol=tol, rtol=0, err_msg="score")
    top = np.sort(ref, axis=-1)
    clear = top[..., -1] - top[..., -2] > 2 * tol
    lab, ref_lab = out["label_2d"].cpu().numpy(), g["out/label_2d"]
    np.testing.assert_array_equal(lab[clear], ref_lab[clear], err_msg="label_2d")
    return {"score": float(np.abs(score - ref).max()), "score_max": float(np.abs(ref).max()),
            "label_agreement": float((lab == ref_lab).mean()), "ties": int((~clear).sum())}


def roi_pool_masked_max(feat: torch.Tensor, rois: torch.Tensor, pooled: int = 7,
                        spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """The port's `roi_pool_batched` forward before it carried JAX's
    doubling table: the same bins (`ops/roi_pool.py:bin_edges`) and a
    separable masked max, over W per output column, then over H per output
    row, image by image. A max is exact in any order, so its values equal
    the table's; kept to hold the two forwards equal and to time them."""
    from posecnn_torch.ops.roi_pool import NEG, bin_edges

    B, H, W, C = feat.shape
    D = rois.shape[1]
    wstart, wend, hstart, hend = bin_edges(rois.reshape(B * D, 7), pooled, spatial_scale, H, W)
    wstart, wend = wstart.reshape(B, D, pooled), wend.reshape(B, D, pooled)
    hstart, hend = hstart.reshape(B, D, pooled), hend.reshape(B, D, pooled)
    ws = torch.arange(W, device=feat.device)
    hs = torch.arange(H, device=feat.device)
    neg = torch.tensor(NEG, dtype=feat.dtype, device=feat.device)
    out = []
    for b in range(B):
        f = feat[b]  # (H, W, C)
        cols = []
        for pw in range(pooled):  # W stage, one output column at a time
            wmask = (ws[None, :] >= wstart[b, :, pw, None]) & (ws[None, :] < wend[b, :, pw, None])  # (D, W)
            cols.append(torch.where(wmask[:, None, :, None], f[None], neg).amax(dim=2))  # (D, H, C)
        colmax = torch.stack(cols, dim=1)  # (D, pw, H, C)
        hmask = (hs[None, None, :] >= hstart[b, :, :, None]) & (hs[None, None, :] < hend[b, :, :, None])
        o = torch.where(hmask[:, :, None, :, None], colmax[:, None], neg).amax(dim=3)  # (D, ph, pw, C)
        empty = (hend[b] <= hstart[b])[:, :, None] | (wend[b] <= wstart[b])[:, None, :]
        out.append(torch.where(empty[..., None], torch.zeros((), dtype=feat.dtype, device=feat.device), o))
    return torch.stack(out)


def gt_rows_at_detections(out: dict, poses: np.ndarray, seed: int = 0) -> np.ndarray:
    """A batch's GT pose rows (max_gt, 13) put at a training forward's own
    detections: for each valid detection (the first of its 9 jittered
    rows), its image and class, a rotation from RandomState(seed) and the
    translation of its `poses_init`; the rows past the detections 0. From
    random weights Hough's detections meet no GT row of the batch, so the
    pose branch gets no target and no gradient; with these rows it gets
    both. `out` is the forward's endpoints (`rois`, `rois_valid`,
    `poses_init`; any device), `poses` the batch's rows."""
    valid = out["rois_valid"].cpu().numpy()
    rois = out["rois"].detach().cpu().numpy()[valid][::9]
    init = out["poses_init"].detach().cpu().numpy()[valid][::9]
    q = np.random.RandomState(seed).randn(len(rois), 4)
    rows = np.zeros_like(poses)
    n = min(len(rois), len(rows))
    rows[:n, :2] = rois[:n, :2]
    rows[:n, 6:10] = q[:n] / np.linalg.norm(q[:n], axis=1, keepdims=True)
    rows[:n, 10:] = init[:n, 4:]
    return rows


def bf16_ulp_excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| in units of one bf16 ulp, the ulp taken at the
    larger magnitude of the two and no finer than at 2**-8 of ref's largest
    magnitude. Two bf16 results of the same f32 sum taken in different
    orders differ by at most 1: the sums part by ~1e-6 of the terms, then
    each is rounded to bf16 once. Returns the largest ratio; <= 1 passes."""
    got, ref = got.detach().float(), ref.detach().float()
    floor = ref.abs().max() / 256.0
    mag = torch.maximum(torch.maximum(got.abs(), ref.abs()), floor)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return float(((got - ref).abs() / ulp).max())


def small_train_on_golden(device="cpu", g=None):
    """The port's small training step (f32) on the training golden's
    weights (`init_params_numpy(seed)`), batch and points, on `device`
    (`g`: a golden of that layout, default the training golden).
    Returns (losses, grads by state_dict name, params after the update,
    the lr, the gradient's global norm, the params before, golden)."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.engine.train import TrainHParams, compute_losses, create_train_state, lr_schedule, train_update

    g = load_npz(goldens().TRAIN_GOLDEN) if g is None else g
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **{k[4:]: g[k].item() for k in g if k.startswith("cfg/")})
    hp = TrainHParams(**{k[3:]: g[k].item() for k in g if k.startswith("hp/")})
    model = make_model(cfg, init_params_numpy(int(g["seed"]), cfg), device)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, hp)
    batch = {k[len("batch/"):]: t(g[k]).to(device) for k in g if k.startswith("batch/")}
    loss, losses = compute_losses(model, cfg, hp, batch, t(g["points"]).to(device), t(g["symmetry"]).to(device),
                                  t(g["extents"]).to(device))
    lr = lr_schedule(hp)(state.step)
    g_norm = train_update(state, loss, lr)
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    after = {k: v.detach() for k, v in model.state_dict().items()}
    return {k: float(v.detach()) for k, v in losses.items()}, grads, after, lr, float(g_norm), before, g


def matching_on_golden(device="cpu", g=None):
    """The port's compute_losses with TRAIN.MATCHING (f32) on the matching
    golden's weights (`init_params_numpy(seed)`), batch, points and raw
    clouds, on `device`, and its backward. Returns (losses, grads by
    state_dict name, the gradient's global norm, golden)."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.engine.train import TrainHParams, compute_losses, create_train_state

    g = load_npz(goldens().MATCHING_GOLDEN) if g is None else g
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **{k[4:]: g[k].item() for k in g if k.startswith("cfg/")})
    hp = TrainHParams(**{k[3:]: g[k].item() for k in g if k.startswith("hp/")})
    model = make_model(cfg, init_params_numpy(int(g["seed"]), cfg), device)
    state = create_train_state(model, hp)
    batch = {k[len("batch/"):]: t(g[k]).to(device) for k in g if k.startswith("batch/")}
    consts = [t(g[k]).to(device) for k in ("points", "symmetry", "extents")]
    loss, losses = compute_losses(model, cfg, hp, batch, *consts, points_raw=t(g["points_raw"]).to(device))
    loss.backward()
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    g_norm = float(state.optimizer.global_norm([p.grad for p in state.optimizer.params]))
    return {k: float(v.detach()) for k, v in losses.items()}, grads, g_norm, g


# the matching step against JAX: each loss term within 1e-5 relative (of
# 1e-3 at least), the gradient's global norm within 1e-5 relative, each
# kept gradient within 5e-5 of its largest magnitude (f32 sums in other
# orders, as the training golden's)
MATCHING_LOSS_RTOL, MATCHING_GRAD_TOL = 1e-5, 5e-5


def check_matching_golden(losses, grads, g_norm, g) -> dict:
    """Holds the matching step to the JAX golden at MATCHING_LOSS_RTOL and
    MATCHING_GRAD_TOL. Returns the errors (relative)."""
    from posecnn_torch.core.convert import params_from_numpy

    err = {}
    for k in (k[len("loss/"):] for k in g if k.startswith("loss/")):
        ref = float(g[f"loss/{k}"])
        err[k] = abs(losses[k] - ref) / max(abs(ref), 1e-3)
        assert err[k] <= MATCHING_LOSS_RTOL, (k, losses[k], ref)
    assert losses["loss_matching"] > 0
    err["grad_norm"] = abs(g_norm - float(g["grad_norm"])) / float(g["grad_norm"])
    assert err["grad_norm"] <= MATCHING_LOSS_RTOL, (g_norm, float(g["grad_norm"]))
    for k, ref in params_from_numpy({k[len("grads/"):]: g[k] for k in g if k.startswith("grads/")}).items():
        err[k] = float((grads[k].cpu() - ref).abs().max()) / float(ref.abs().max())
        assert err[k] <= MATCHING_GRAD_TOL, (k, err[k])
    return err


def gan_on_golden(device="cpu") -> dict:
    """The port's GAN models (float32) on the GAN golden's inputs and
    weights (`make_torch_goldens.gan_inputs`, `gan_params`), on `device`,
    in the golden's layout (its keys)."""
    from posecnn_torch.models import gan

    G = goldens()
    x = {k: t(v).to(device) for k, v in G.gan_inputs().items()}
    dc, vg, fd = G.gan_params()
    g = {}
    with torch.no_grad():
        m = gan.make_dcgan(dc, device)
        out, gstats = gan.dcgan_generator(m, x["z"], x["image"], train=True, return_stats=True)
        logit, dstats = gan.dcgan_discriminator(m, x["pair"], train=True, return_stats=True)
        g["dcgan/train/gen"], g["dcgan/train/disc"] = out, logit
        for name, st in {**gstats, **dstats}.items():
            for leaf, v in st.items():
                g[f"dcgan/stats/{name}/{leaf}"] = v
        gan.merge_bn_stats(gan.merge_bn_stats(m, gstats), dstats)
        g["dcgan/eval/gen"] = gan.dcgan_generator(m, x["z"], x["image"], train=False)
        g["dcgan/eval/disc"] = gan.dcgan_discriminator(m, x["pair"], train=False)
        v = gan.make_vgg16_gan(G.GAN_CLASSES, vg, device)
        o = gan.vgg16_gan_forward(v, x["data"], G.GAN_CLASSES, vertex_targets=x["vertex_targets"],
                                  compute_dtype=torch.float32)
        for k in ("score", "label_2d", "vertex_pred"):
            g[f"vgg16_gan/{k}"] = o[k]
        g["vgg16_gan/d_fake"], g["vgg16_gan/d_real"] = o["outputs_d"]
        g["feature_d"] = gan.feature_discriminator(gan.make_feature_discriminator(fd, device), x["feat"])
        g["gan_losses"] = torch.stack(gan.gan_losses(o["outputs_d"][1][..., 1].mean(), o["outputs_d"][0][..., 1].mean()))
    return {k: v.cpu().numpy() for k, v in g.items()}


# the GAN models against JAX in float32: each output within GAN_TOL of its
# largest magnitude (f32 convolutions summed in other orders), the label map
# exact; DCGAN's train mode and vgg16_gan's label score within
# GAN_LOOSE_TOL: train-mode batch norm at 32x32 normalizes the B=2 values of
# the 1x1 deepest level, where 1e-7 apart before it is 1e-5 apart after
# (measured 4.6e-5 on the generator's output); the score's largest
# magnitude is 0.013, and its 2.4e-7 is the f32 trunk's (1.8e-5 of it)
GAN_TOL, GAN_LOOSE_TOL = 1e-5, 1e-4
GAN_LOOSE = ("dcgan/train/gen", "dcgan/train/disc", "vgg16_gan/score")


def check_gan_golden(got: dict, g: dict) -> dict:
    """Holds the port's GAN outputs (`gan_on_golden`) to the golden. Returns
    the errors (relative to each output's largest magnitude)."""
    assert sorted(got) == sorted(g), sorted(set(got) ^ set(g))
    err = {}
    for k, ref in g.items():
        if ref.dtype.kind != "f":
            assert np.array_equal(got[k], ref), k
            continue
        err[k] = float(np.abs(got[k] - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
        assert err[k] <= (GAN_LOOSE_TOL if k in GAN_LOOSE else GAN_TOL), (k, err[k])
    return err


def rgbd_train_on_golden(device="cpu"):
    """`small_train_on_golden` on the input-modes golden's RGBD step."""
    g = load_npz(goldens().INPUT_MODES_GOLDEN)
    return small_train_on_golden(device, {k[len("step/"):]: v for k, v in g.items() if k.startswith("step/")})


# the bilateral filter against cv2 (with Intel's IPP, as the cv2 wheels
# call it): at least this share of values exact, none off by more than one
# level (the port's C++ is OpenCV's own arithmetic; IPP rounds about one
# value in 10^5 the other way)
BILATERAL_EXACT, BILATERAL_MAX_DIFF = 0.999, 1


def check_bilateral(got: np.ndarray, ref: np.ndarray) -> dict:
    """Holds a filtered image to cv2's at the bilateral limits. Returns the
    share of exact values and the largest difference."""
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    exact, worst = float((diff == 0).mean()), int(diff.max())
    assert got.shape == ref.shape and exact >= BILATERAL_EXACT and worst <= BILATERAL_MAX_DIFF, (exact, worst)
    return {"exact": exact, "max_diff": worst}


def port_host_images(path: str) -> dict:
    """The port's counterparts of `make_torch_goldens.host_images` on one
    frozen frame: the same digests, and `bilateral` whole."""
    from posecnn_torch.data import minibatch as M
    from posecnn_torch.native import bilateral_filter
    from posecnn_torch.utils import blob

    G = goldens()
    d_h, d_l, d_s = G.INPUT_CHROMA
    with np.load(os.path.join(ROOT, path)) as f:
        color, depth, fd, K = f["color"], f["depth"], float(f["factor_depth"]), f["intrinsic_matrix"]
    normals = M.normals_np(depth.astype(np.float32) / fd, K)
    normal_u8 = np.ascontiguousarray((127.5 * normals + 127.5).astype(np.uint8)[:, :, (2, 1, 0)])
    return {"hls": G.digest(blob.bgr_to_hls(color)),
            "chroma": G.digest(blob.chromatic_transform(color, d_h=d_h, d_l=d_l, d_s=d_s)),
            "depth_image": G.digest(M.depth_input_image(depth)), "normals": G.digest(normals),
            "normal_u8": G.digest(normal_u8), "bilateral": bilateral_filter(normal_u8, 9, 75, 75)}


def check_host_images(got: dict, g: dict, i: int) -> dict:
    """Holds `port_host_images` of frame i to the input-modes golden: the
    digests equal, the bilateral filter at its limits. Returns the
    filter's share of exact values and largest difference."""
    for k, v in got.items():
        if k != "bilateral":
            assert v == str(g[f"frame{i}/{k}"]), (i, k)
    return check_bilateral(got["bilateral"], g[f"frame{i}/bilateral"])


def check_train_golden(losses, grads, after, lr, g_norm, before, g) -> dict:
    """Holds the small training step to the JAX golden: every loss term and
    the gradient's global norm within 1e-5 relative; each parameter's
    gradient within 5e-5 of its largest magnitude (f32 sums over thousands
    of pixels in other orders, with cancellation in the bias sums: the port
    reads 2.1e-6 on the CPU and 1.7e-5 on the H100, trunk.conv2_2.bias);
    the lr exactly; the update
    p - lr * clip(g) (momentum starts at zero) made from the golden's
    gradients within 2e-5 of the step's largest move (and two f32 ulps of
    the parameter). Returns the max |err|s."""
    from posecnn_torch.core.convert import params_from_numpy

    err = {}
    for k in (k[len("loss/"):] for k in g if k.startswith("loss/")):
        ref = float(g[f"loss/{k}"])
        assert abs(losses[k] - ref) <= 1e-5 * max(abs(ref), 1e-3), (k, losses[k], ref)
        err[k] = abs(losses[k] - ref)
    assert abs(g_norm - float(g["grad_norm"])) <= 1e-5 * float(g["grad_norm"]), (g_norm, float(g["grad_norm"]))
    assert lr == float(np.float32(g["lr"])) or abs(lr - float(g["lr"])) <= 1e-9, (lr, float(g["lr"]))
    ref_grads = params_from_numpy({k[len("grads/"):]: g[k] for k in g if k.startswith("grads/")})
    assert set(ref_grads) == set(grads), sorted(set(ref_grads) ^ set(grads))
    clip = float(g["hp/clip_grad_norm"])
    scale = min(1.0, clip / float(g["grad_norm"])) if clip > 0 else 1.0
    worst_g = worst_p = 0.0
    worst_name = ""
    for k, ref in ref_grads.items():
        got = grads[k].cpu()
        tol = 5e-5 * float(ref.abs().max())
        e = float((got - ref).abs().max())
        assert e <= tol, (k, e, tol)
        if e / max(float(ref.abs().max()), 1e-30) > worst_g:
            worst_g, worst_name = e / max(float(ref.abs().max()), 1e-30), k
        move = lr * scale * ref
        e = float((after[k].cpu() - (before[k].cpu() - move)).abs().max())
        # plus two f32 ulps of the parameter: p - move is rounded once
        assert e <= 2e-5 * float(move.abs().max()) + 2.4e-7 * float(before[k].abs().max()), (k, e)
        worst_p = max(worst_p, e)
    err["grads (relative)"] = worst_g
    err[f"worst grad: {worst_name}"] = worst_g
    err["params after the update"] = worst_p
    return err


# the eval battery's ICP, held to the eval golden (jitted JAX `refine_poses`)
# and between devices: translation atol 2e-4 m, quaternion atol 5e-3 (the
# CPU port read 6.0e-5 m and 5.3e-4, tests/test_torch_eval.py; the H100
# 2.5e-3 in the quaternion of the golden's least-supported detection, a
# 6 cm cube seen by 140 pixels), poses_new atol 1e-6
ICP_T_ATOL, ICP_Q_ATOL = 2e-4, 5e-3


def check_icp(new, icp, ref_new, ref_icp) -> dict:
    """Holds (poses_new, poses_icp) to a reference pair at the ICP limits.
    Returns the max |err|s of the translation and the quaternion."""
    q, r = icp[:, :4], ref_icp[:, :4]
    r = np.where((q * r).sum(axis=1, keepdims=True) < 0, -r, r)  # q and -q: w = 0 has no canonical sign
    np.testing.assert_allclose(new, ref_new, atol=1e-6)
    np.testing.assert_allclose(icp[:, 4:], ref_icp[:, 4:], atol=ICP_T_ATOL)
    np.testing.assert_allclose(q, r, atol=ICP_Q_ATOL)
    return {"poses_new": float(np.abs(new - ref_new).max()), "icp_t": float(np.abs(icp[:, 4:] - ref_icp[:, 4:]).max()),
            "icp_q": float(np.abs(q - r).max())}


def icp_on_eval_golden(device="cpu") -> dict:
    """The port's refine_poses on the eval golden's scene at each plane
    weight, on `device`, held to the golden. Returns the max |err|s."""
    from posecnn_torch.engine.test import refine_poses

    G = goldens()
    g = load_npz(G.EVAL_GOLDEN)
    s = G.eval_scene()
    err = {}
    for w in G.EVAL_PLANE_WEIGHTS:
        new, icp = refine_poses(s["rois"], s["poses"], s["depth"], s["label"], t(s["points_all"]).to(device),
                                s["meta"], plane_weight=w)
        err[f"plane {w:g}"] = check_icp(new, icp, g[f"plane{w:g}/poses_new"], g[f"plane{w:g}/poses_icp"])
        np.testing.assert_array_equal(icp[3], s["poses"][3])  # no depth support: the pose comes back
    return err


def flagship_icp_scene(n_objects: int = 6) -> dict:
    """A 640x480 ICP scene at the flagship K, numpy: n_objects 10 cm cube
    surfaces (classes 1..n, 1014 points each) splatted into one depth and
    label map at 0.6-1.2 m, and 2 detections an object (rotations 10 and
    20 degrees off, translations 2-4 cm off) plus one of a class with no
    depth: the ICP path's shapes (32 padded rows, 1014 model points, 512
    target points) on a well-posed problem."""
    from posecnn_torch.utils.meta import build_meta_data
    from posecnn_torch.utils.quaternion_np import mat2quat

    G = goldens()
    rng = np.random.RandomState(5)
    H, W = 480, 640
    K = np.array([[1066.8, 0, 312.99], [0, 1067.5, 241.31], [0, 0, 1.0]])
    cube = G.box_surface(0.05, n=13)
    dense = G.box_surface(0.05, n=60)
    C = n_objects + 2
    points_all = np.zeros((C, cube.shape[0], 3), np.float32)
    depth = np.zeros((H, W), np.float32)
    label = np.zeros((H, W), np.int32)
    rois, poses = [], []
    for c in range(1, n_objects + 1):
        points_all[c] = cube
        R = G.axis_angle(rng.randn(3), rng.uniform(0, 180))
        u, v, z = 100 + 85 * (c - 1), rng.uniform(150, 330), rng.uniform(0.6, 1.2)
        t = np.array([(u - K[0, 2]) * z / K[0, 0], (v - K[1, 2]) * z / K[1, 1], z])
        G.splat(dense.astype(np.float64) @ R.T + t, K, depth, label, c)
        for deg, dt in ((10, 0.02), (20, 0.04)):
            rois.append([0, c, 0, 0, 10, 10, rng.uniform(0.5, 1.0)])
            poses.append(np.concatenate([mat2quat(G.axis_angle(rng.randn(3), deg) @ R), t + rng.randn(3) * dt / 1.7]))
    points_all[C - 1] = cube
    rois.append([0, C - 1, 0, 0, 10, 10, 0.5])
    poses.append(np.array([1.0, 0, 0, 0, 0, 0, 1.0]))
    return dict(depth=depth, label=label, points_all=points_all, meta=build_meta_data(K),
                rois=np.asarray(rois, np.float32), poses=np.asarray(poses, np.float32))


def summary_rel_err(got, ref) -> float:
    """Largest relative difference between two evaluator summaries (nested
    dicts of numbers with the same keys; equal infinities count 0)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), sorted(set(got) ^ set(ref))
        return max((summary_rel_err(got[k], ref[k]) for k in ref), default=0.0)
    if got == ref:
        return 0.0
    return abs(got - ref) / max(abs(got), abs(ref))


def check_evaluator_golden() -> float:
    """The port's PoseEvaluator on the eval golden's fixed detections, held
    to the golden's summary within 1e-6 relative: the same numpy code, but
    it transforms the model points in float32, which another BLAS rounds
    otherwise (the H100's machine read 2.5e-8). Returns the largest
    relative difference."""
    import json

    from posecnn_torch.data.imdb import PoseEvaluator

    G = goldens()
    err = summary_rel_err(G.score_detections(PoseEvaluator), json.loads(str(load_npz(G.EVAL_GOLDEN)["summary"])))
    assert err <= 1e-6, err
    return err


def toy_train_on_golden(device="cpu"):
    """The port's host-fed steps (`make_train_step`, f32) on the toy golden's
    weights (`init_params_numpy(seed)`), batches and points, on `device`.
    Returns (per-step outputs as floats, the flat parameters before and
    after, golden)."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import init_params_numpy, make_model, params_to_numpy
    from posecnn_torch.engine.train import Draws, TrainHParams, create_train_state, make_train_step, to_device

    g = load_npz(goldens().TOY_TRAIN_GOLDEN)
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **{k[4:]: g[k].item() for k in g if k.startswith("cfg/")})
    hp = TrainHParams(**{k[3:]: g[k].item() for k in g if k.startswith("hp/")})
    params = init_params_numpy(int(g["seed"]), cfg)
    state = create_train_state(make_model(cfg, params, device), hp)
    step = make_train_step(cfg, hp, *(t(g[k]).to(device) for k in ("points", "symmetry", "extents")))
    outs, n = [], 0
    while f"batch{n}/data" in g:
        batch = {k.split("/", 1)[1]: g[k] for k in g if k.startswith(f"batch{n}/")}
        outs.append({k: float(v) for k, v in step(state, to_device(batch, device), Draws()).items()})
        n += 1

    def flat(nested):
        return {f"['{layer}']['{leaf}']": a for layer, leaves in nested.items() for leaf, a in leaves.items()}

    return outs, flat(params), flat(params_to_numpy(state.model.state_dict())), g


def check_toy_train_golden(outs, before, after, g) -> dict:
    """Holds the host-fed toy steps to the JAX golden: every loss term and
    each step's gradient norm within 1e-5 relative (the CPU port read
    1.1e-6, loss_pose of step 2); each step's lr within 1e-9 (the golden's
    is float32); each parameter slice after the second step within 1e-3 of
    its largest move from the start, plus two float32 ulps of the
    parameter (the CPU port read 1.0e-4 on fc6's biases, which only the
    second step's single pose row moves, through sums over the RoI rows
    with cancellation; 6e-5 or less elsewhere). Returns the largest
    errors."""
    err = {}
    for n, out in enumerate(outs):
        for k, v in out.items():
            ref = float(g[f"step{n}/{k}"])
            if k == "lr":
                assert abs(v - ref) <= 1e-9, (n, v, ref)
                continue
            e = abs(v - ref) / max(abs(ref), 1e-3)
            assert e <= 1e-5, (n, k, v, ref)
            err[k] = max(err.get(k, 0.0), e)
    for k in (k[len("after/"):] for k in g if k.startswith("after/")):
        ref, sl = g[f"after/{k}"], goldens().TOY_SLICES[k]
        got, start = after[k][sl], before[k][sl]
        move = float(np.abs(ref - start).max())
        e = float(np.abs(got - ref).max())
        assert e <= 1e-3 * move + 2.4e-7 * float(np.abs(start).max()), (k, e, move)
        err[f"params {k} (relative to the move)"] = e / max(move, 1e-30)
    return err


def port_renders() -> dict:
    """The port's renders of the render golden's scenes
    (`make_torch_goldens.RENDER_SCENES`), in its layout."""
    from posecnn_torch.data import synthetic
    from posecnn_torch.data.toy import toy

    G = goldens()
    return G.render_scenes(G.render_synthesizers(synthetic, toy))


# the renders of another machine against the golden (its compiler, CPU and
# Qhull may round or order faces otherwise): labels agree on this share of
# the pixels; where they agree, depth within this relative error and colour
# within this many levels
RENDER_LABEL_AGREE, RENDER_DEPTH_REL, RENDER_COLOR_LEVELS = 0.999, 1e-5, 2


def check_render_golden(got: dict, g: dict) -> dict:
    """Holds renders to the render golden scene by scene: the same classes,
    poses within 1e-6, and RENDER_LABEL_AGREE, RENDER_DEPTH_REL and
    RENDER_COLOR_LEVELS. Returns {scene: (label agreement, largest depth
    error, largest colour error)}."""
    out = {}
    for name in sorted({k.split("/")[0] for k in g}):
        r = {k: got[f"{name}/{k}"] for k in ("color", "label", "depth", "cls_indexes", "poses")}
        assert np.array_equal(r["cls_indexes"], g[f"{name}/cls_indexes"]), name
        assert np.allclose(r["poses"], g[f"{name}/poses"], rtol=0, atol=1e-6), name
        agree = r["label"] == g[f"{name}/label"]
        dg = g[f"{name}/depth"]
        depth_err = float((np.abs(r["depth"] - dg) / np.maximum(dg, 1e-9))[agree & (dg > 0)].max(initial=0.0))
        color_err = int(np.abs(r["color"].astype(int) - g[f"{name}/color"].astype(int))[agree].max(initial=0))
        out[name] = (float(agree.mean()), depth_err, color_err)
        assert out[name][0] >= RENDER_LABEL_AGREE and depth_err <= RENDER_DEPTH_REL \
            and color_err <= RENDER_COLOR_LEVELS, (name, out[name])
    return out


def det_on_golden(device="cpu") -> tuple:
    """(port outputs, golden): the small float32 detection network
    (`DET_CFG`, the seeded weights) on the det golden's frame, the
    golden's two proposal_layer calls, and ransac_pose with the golden's
    triplets, on `device`. NMS runs on the kernel on a card."""
    from posecnn_torch.config import PIXEL_MEANS
    from posecnn_torch.engine.ransac import hypothesis_index, ransac_pose
    from posecnn_torch.engine.train import Draws
    from posecnn_torch.models.detection import DetConfig, init_vgg16_det_params_numpy, make_det_model, \
        vgg16_det_forward
    from posecnn_torch.ops.rpn import proposal_layer

    G = goldens()
    g = load_npz(G.DET_GOLDEN)
    cfg = DetConfig(compute_dtype=torch.float32, is_train=False, keep_prob=1.0, trunk_scale=G.DET_TRUNK_SCALE,
                    **G.DET_CFG)
    model = make_det_model(cfg, init_vgg16_det_params_numpy(G.DET_SEED, cfg), device)
    means = torch.tensor(PIXEL_MEANS, device=device).reshape(1, 1, 1, 3)
    out = {}
    with torch.inference_mode():
        o = vgg16_det_forward(model, cfg, t(g["raw"]).to(device).float() - means)
        out.update({f"out/{k}": o[k] for k in ("rpn_cls_prob", "rpn_bbox_pred", "rois", "rpn_scores", "cls_prob",
                                               "bbox_pred", "poses_tanh")})
        args = [t(g[f"prop/{k}"]).to(device) for k in ("prob", "deltas", "anchors")]
        for name, (pre, post, thr) in (("a", (6000, 300, 0.7)), ("b", (200, 50, 0.5))):
            rois, scores = proposal_layer(*args, G.DET_PROPOSAL_HW, 9, pre_nms_top_n=pre, post_nms_top_n=post,
                                          nms_thresh=thr)
            out[f"prop/{name}/rois"], out[f"prop/{name}/scores"] = rois, scores
        oc, cam, valid, _, _ = G.det_ransac_inputs()
        valid_t = t(valid[None]).to(device)
        idx = hypothesis_index(Draws(replay={"ransac": t(g["ransac/idx"][None])}), valid_t)
        q, tr, n = ransac_pose(t(oc[None]).to(device), t(cam[None]).to(device), valid_t, idx)
        out.update({"ransac/q": q[0], "ransac/t": tr[0], "ransac/n": n[0]})
    return out, g


def check_det_golden(out, g) -> dict:
    """Holds the detection network to the JAX golden: each float output of
    the forward within 1e-5 of the golden's largest magnitude; the
    proposals' scores exact and boxes within 2e-5 px (the decode's exp, a
    few ulps of the image's size); RANSAC's inlier count exact, its
    translation within 2e-4 m and its quaternion within 5e-3 (1 - |q.q'|,
    the ICP's limits). Returns the max |err|s."""
    o = {k: v.detach().cpu().numpy() for k, v in out.items()}
    err = {}
    for k in ("rpn_cls_prob", "rpn_bbox_pred", "rois", "rpn_scores", "cls_prob", "bbox_pred", "poses_tanh"):
        ref = g[f"out/{k}"]
        np.testing.assert_allclose(o[f"out/{k}"], ref, atol=1e-5 * np.abs(ref).max(), rtol=0, err_msg=k)
        err[k] = float(np.abs(o[f"out/{k}"] - ref).max())
    for name in ("a", "b"):
        np.testing.assert_array_equal(o[f"prop/{name}/scores"], g[f"prop/{name}/scores"])
        np.testing.assert_allclose(o[f"prop/{name}/rois"], g[f"prop/{name}/rois"], atol=2e-5, rtol=0)
        err[f"proposals_{name}"] = float(np.abs(o[f"prop/{name}/rois"] - g[f"prop/{name}/rois"]).max())
    assert int(o["ransac/n"]) == int(g["ransac/n"]), (o["ransac/n"], g["ransac/n"])
    err["ransac_t"] = float(np.abs(o["ransac/t"] - g["ransac/t"]).max())
    err["ransac_q"] = float(1 - abs(np.dot(o["ransac/q"], g["ransac/q"])))
    assert err["ransac_t"] <= 2e-4 and err["ransac_q"] <= 5e-3, err
    return err


def rendered_3d_frames(n: int = 2, seed: int = 0) -> list:
    """`n` scenes of the lov_syn_val_v4 synthesizer (the stand-in hulls,
    640x480) with the rasterizer's object-coordinate buffer as their
    `vertmap` (`native.SceneBuffers.vertmap`), marked as real frames (no
    background composite)."""
    from posecnn_torch.data.lov_syn import LovSynVal
    from posecnn_torch.data.synthetic import build_ycb_synthesizer

    synth = build_ycb_synthesizer(LovSynVal())
    frame_from = synth._frame_from
    synth._frame_from = lambda buf, *a: dataclasses.replace(frame_from(buf, *a), vertmap=buf.vertmap.copy(),
                                                            is_synthetic=False)
    rng = np.random.RandomState(seed)
    return [synth.render_scene(rng) for _ in range(n)]


def ransac_scene() -> tuple:
    """A 96x128 scene for the RANSAC decode: the front faces of two boxes
    (classes 1 and 3, K with f = 400) with their depth and their scaled
    object coordinates in the vertex map's class channels, and a 5x5 patch
    of class 2, under decode_poses_3d's 500-pixel threshold. Returns
    (label, depth, vertex map (H,W,12), extents (4,3), meta (48,))."""
    from posecnn_torch.utils.quaternion_np import quat2mat

    H, W, C = 96, 128, 4
    K = np.array([[400.0, 0, W / 2], [0, 400.0, H / 2], [0, 0, 1]])
    rng = np.random.RandomState(0)
    label = np.zeros((H, W), np.int32)
    depth = np.zeros((H, W), np.float32)
    vp = np.zeros((H, W, 3 * C), np.float32)
    extents = np.zeros((C, 3), np.float32)
    for cls, t_gt, extent in ((1, [0.03, -0.02, 0.8], [0.12, 0.09, 0.06]), (3, [-0.06, 0.03, 0.9], [0.1, 0.1, 0.08])):
        extent = np.array(extent)
        extents[cls] = extent
        q = rng.randn(4)
        R_gt = quat2mat(q / np.linalg.norm(q))
        xs, ys = np.meshgrid(np.arange(-extent[0] / 2, extent[0] / 2, 0.0015),
                             np.arange(-extent[1] / 2, extent[1] / 2, 0.0015))
        model = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, -extent[2] / 2)], 1)
        cam = model @ R_gt.T + np.array(t_gt)
        uv = cam @ K.T
        u, v = (uv[:, 0] / uv[:, 2]).astype(int), (uv[:, 1] / uv[:, 2]).astype(int)
        ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        label[v[ok], u[ok]] = cls
        depth[v[ok], u[ok]] = cam[ok, 2]
        vp[v[ok], u[ok], 3 * cls:3 * cls + 3] = (model / extent + 0.5)[ok]
    label[:5, :5] = 2
    extents[2] = 0.05
    meta = np.zeros(48, np.float32)
    meta[0], meta[2], meta[4], meta[5] = K[0, 0], K[0, 2], K[1, 1], K[1, 2]
    return label, depth, vp, extents, meta


# ------------------------------------------------------------ dataset trees

V4_DIR = os.path.join(ROOT, "data", "lov_syn_val_v4")


def v4_frame(i: int):
    """Frozen frame i of data/lov_syn_val_v4/ (the port's `Frame`)."""
    from posecnn_torch.data.minibatch import load_frozen_frame

    return load_frozen_frame(os.path.join(V4_DIR, f"{i:06d}.npz"))


def write_frame_files(base: str, fr, label=None, sel=None) -> None:
    """`base`-color.png (BGR), -label.png (uint8), -depth.png (uint16) and
    -meta.mat (cls_indexes, poses (3,4,N), center, intrinsic_matrix,
    factor_depth) of frame `fr`; `label` in place of its label, and only
    the objects `sel` in the meta file (a single object's poses are then
    stored (3,4,1), which MATLAB's format reads back as (3,4))."""
    import scipy.io

    from posecnn_torch.utils.png import write_png

    sel = np.arange(len(fr.cls_indexes)) if sel is None else np.asarray(sel)
    os.makedirs(os.path.dirname(base), exist_ok=True)
    write_png(base + "-color.png", fr.color)
    write_png(base + "-label.png", np.asarray(fr.label if label is None else label).astype(np.uint8))
    write_png(base + "-depth.png", fr.depth.astype(np.uint16))
    scipy.io.savemat(base + "-meta.mat", {
        "cls_indexes": np.asarray(fr.cls_indexes)[sel], "poses": fr.poses[:, :, sel], "center": fr.center[sel],
        "intrinsic_matrix": fr.intrinsic_matrix, "factor_depth": np.float64(fr.factor_depth)})


def lov_index(i: int) -> str:
    """The tree's name of v4 frame i: sequence i // 8, frame i % 8 + 1."""
    return f"{i // 8:04d}/{i % 8 + 1:06d}"


def stand_in_models(num_classes: int = 22):
    """(points list, extents (C,3)) of the trees: the stand-in points of
    `data.lov_syn.object_models`, class c cut to 1024 - c points (so the
    loader's cut to the smallest count shows), extents their spans."""
    from posecnn_torch.data.lov_syn import object_models

    pts, _, _ = object_models(num_classes)
    points = [None] + [pts[c, :1024 - c].astype(np.float64) for c in range(1, num_classes)]
    extents = np.array([np.ptp(p, axis=0) for p in points[1:]])
    return points, extents


def write_syn_tree(root: str, frames=range(16, 32)) -> str:
    """A `data_syn` directory: v4 frame `frames[k]` as
    {root}/{k:06d}-{color,label,depth}.png and -meta.mat. Returns root."""
    for k, i in enumerate(frames):
        write_frame_files(os.path.join(root, f"{k:06d}"), v4_frame(i))
    return root


def write_lov_tree(root: str, frames=range(16), syn_frames=range(16, 32)) -> str:
    """A YCB-Video tree under {root}/LOV: data/<seq>/<frame>-* of the v4
    `frames` (`lov_index`), models/<class>/points.xyz and extents.txt
    (`stand_in_models`), train.txt and keyframe.txt (all the frames), and
    data_syn/ of `syn_frames` (`write_syn_tree`). Returns {root}/LOV."""
    from posecnn_torch.data.lov import YCB_CLASSES

    lov = os.path.join(root, "LOV")
    for i in frames:
        write_frame_files(os.path.join(lov, "data", lov_index(i)), v4_frame(i))
    points, extents = stand_in_models(len(YCB_CLASSES))
    for c in range(1, len(YCB_CLASSES)):
        os.makedirs(os.path.join(lov, "models", YCB_CLASSES[c]), exist_ok=True)
        np.savetxt(os.path.join(lov, "models", YCB_CLASSES[c], "points.xyz"), points[c])
    np.savetxt(os.path.join(lov, "extents.txt"), extents)
    for split in ("train", "keyframe"):
        with open(os.path.join(lov, split + ".txt"), "w") as f:
            f.writelines(lov_index(i) + "\n" for i in frames)
    write_syn_tree(os.path.join(lov, "data_syn"), syn_frames)
    return lov


def write_ply(path: str, points: np.ndarray, binary: bool) -> None:
    """A PLY of vertices x, y, z (float) and a uchar property after them,
    ASCII or binary little-endian."""
    head = ("ply\nformat " + ("binary_little_endian" if binary else "ascii") + " 1.0\n"
            f"element vertex {len(points)}\nproperty float x\nproperty float y\nproperty float z\n"
            "property uchar red\nelement face 0\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        if binary:
            rows = np.zeros(len(points), np.dtype([("xyz", "<f4", 3), ("red", "u1")]))
            rows["xyz"], rows["red"] = points, 7
            f.write(rows.tobytes())
        else:
            f.write("".join(f"{x:.9g} {y:.9g} {z:.9g} 7\n" for x, y, z in points).encode("ascii"))


def write_linemod_tree(root: str, cls: str = "ape", frames=range(8), model: str = "ply_binary",
                       layout: str = "indexes") -> str:
    """A LINEMOD tree under {root}/LINEMOD for `cls`: the v4 `frames` as
    data/{i:06d}-*, each frame's first object relabelled as `cls` (its
    label pixels `cls`'s index, the rest 0; the meta file that object
    alone); the model as models/{cls}.xyz, or .ply ASCII or binary
    (`model` "xyz", "ply_ascii", "ply_binary": the stand-in points of class
    1); extents.txt (15 rows); the train and test lists of all the frames
    as indexes/{cls}_{split}.txt or, with `layout` "class_dir",
    {cls}/{split}.txt. Returns {root}/LINEMOD."""
    from posecnn_torch.data.linemod import LINEMOD_CLASSES

    lm = os.path.join(root, "LINEMOD")
    ci = LINEMOD_CLASSES.index(cls)
    for i in frames:
        fr = v4_frame(i)
        k = int(fr.cls_indexes[0])
        label = np.where(fr.label == k, ci, 0)
        fr = dataclasses.replace(fr, cls_indexes=np.full(len(fr.cls_indexes), ci, np.float32))
        write_frame_files(os.path.join(lm, "data", f"{i:06d}"), fr, label=label, sel=[0])
    points, extents = stand_in_models(16)
    os.makedirs(os.path.join(lm, "models"), exist_ok=True)
    if model == "xyz":
        np.savetxt(os.path.join(lm, "models", cls + ".xyz"), points[1])
    else:
        write_ply(os.path.join(lm, "models", cls + ".ply"), points[1].astype(np.float32), model == "ply_binary")
    np.savetxt(os.path.join(lm, "extents.txt"), extents)
    for split in ("train", "test"):
        path = (os.path.join(lm, "indexes", f"{cls}_{split}.txt") if layout == "indexes"
                else os.path.join(lm, cls, f"{split}.txt"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.writelines(f"{i:06d}\n" for i in frames)
    return lm


def write_scene_tree(root: str, dirname: str, num_classes: int, frames=range(4),
                     splits=("train", "val", "trainval")) -> str:
    """A scene dataset's tree under {root}/{dirname} (`data.variants`'
    generic scenes): the v4 `frames` as data/{i:06d}-*, their classes
    folded into 1..num_classes-1 (labels and meta alike), and the split
    lists of all the frames. Returns the tree's root."""
    tree = os.path.join(root, dirname)
    for i in frames:
        fr = v4_frame(i)

        def fold(c):
            return np.where(c > 0, (np.asarray(c, np.int64) - 1) % (num_classes - 1) + 1, 0)

        fr = dataclasses.replace(fr, cls_indexes=fold(fr.cls_indexes).astype(np.float32))
        write_frame_files(os.path.join(tree, "data", f"{i:06d}"), fr, label=fold(fr.label))
    for split in splits:
        with open(os.path.join(tree, split + ".txt"), "w") as f:
            f.writelines(f"{i:06d}\n" for i in frames)
    return tree


# the host batches of lov_color_2d.yml on write_lov_tree's tree (no
# backgrounds): tools/make_torch_goldens.py writes JAX's, chip_smoke.py
# holds the card host's to them
LOV_BATCH_CFG = os.path.join(ROOT, "experiments", "cfgs", "lov_color_2d.yml")
LOV_BATCH_IMDB = "lov_train"
LOV_BATCHES = 2
# the crop kept beside the digest of each image-sized array
LOV_BATCH_CROP = (slice(None), slice(232, 248), slice(312, 328))


def lov_batch_cfg(lov_root: str):
    """lov_color_2d.yml with SYNROOT at the tree's data_syn/ and SYNNUM 16
    (the port's config object)."""
    from posecnn_torch.core import config as C

    return C.cfg_replace(C.cfg_from_file(LOV_BATCH_CFG),
                         TRAIN={"SYNROOT": os.path.join(lov_root, "data_syn"), "SYNNUM": 16})


def port_lov_batches(lov_root: str, n: int = LOV_BATCHES) -> list:
    """The first `n` host batches of `lov_batch_cfg` on lov_train, from the
    layer the port's train_net builds (POSECNN_DATA must hold the tree)."""
    from posecnn_torch.core import config as C
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.train_net import host_layer

    cfg = lov_batch_cfg(lov_root)
    imdb = get_imdb(LOV_BATCH_IMDB)
    layer = host_layer(cfg, imdb, C.minibatch_cfg(cfg, imdb.num_classes), log=lambda m: None)
    return [layer.forward() for _ in range(n)]


def lov_batch_record(batches: list) -> dict:
    """Batches as a golden: each array's dtype and shape; arrays of more
    than 4096 values as their sha256 and the crop LOV_BATCH_CROP, the rest
    whole."""
    import hashlib

    g = {}
    for i, b in enumerate(batches):
        for k, v in b.items():
            key = f"b{i}/{k}"
            g[key + "/dtype"], g[key + "/shape"] = np.array(str(v.dtype)), np.array(v.shape)
            if v.size > 4096:
                g[key + "/sha256"] = np.array(hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest())
                g[key + "/crop"] = np.ascontiguousarray(v[LOV_BATCH_CROP])
            else:
                g[key] = v
    return g


def check_lov_batch_golden(batches: list, g: dict) -> dict:
    """Hold batches to the golden of `lov_batch_record`: the same keys,
    dtypes, shapes, whole arrays and digests. A digest that differs raises
    with the crop's differences, so a mismatch can be read. Returns the
    count of arrays and of digests compared."""
    got = lov_batch_record(batches)
    if sorted(got) != sorted(g):
        raise AssertionError(f"host batch keys {sorted(set(got) ^ set(g))} differ from the golden's")
    n_digest = 0
    for k, v in g.items():
        if k.endswith("/crop"):
            continue
        if k.endswith("/sha256") and str(got[k]) != str(v):
            crop = k[:-len("sha256")] + "crop"
            diff = got[crop].astype(np.float64) - g[crop].astype(np.float64)
            raise AssertionError(f"{k[:-7]}: digest differs; in the crop {int((diff != 0).sum())} of {diff.size} "
                                 f"values differ, by up to {np.abs(diff).max()}")
        if not k.endswith("/sha256") and not np.array_equal(got[k], v):
            raise AssertionError(f"{k}: {got[k]!r} differs from the golden's {v!r}")
        n_digest += k.endswith("/sha256")
    return {"arrays": sum(k.endswith("/dtype") for k in g), "digests": n_digest}


def video_on_golden(device="cpu", three_d: bool = False) -> tuple:
    """The port's `video_forward` (or `video3d_forward`) at float32 on the
    video golden's inputs and weights (`make_torch_goldens.video_params`,
    `video_inputs`): (outputs, final state as a list), numpy."""
    from posecnn_torch.models import video as V

    G = goldens()
    cfg = (V.Video3DConfig(compute_dtype=torch.float32, **G.VIDEO3D_CFG) if three_d
           else V.VideoConfig(compute_dtype=torch.float32, **G.VIDEO_CFG))
    model = V.make_video_model(cfg, G.video_params(three_d=three_d), device)
    x = {k: torch.from_numpy(v).to(device) for k, v in G.video_inputs(three_d=three_d).items()}
    fwd = V.video3d_forward if three_d else V.video_forward
    with torch.no_grad():
        outs, state = fwd(model, cfg, x["data"], x["depth"], x["meta_data"])
    state = [state] if three_d else list(state)
    return {k: v.cpu().numpy() for k, v in outs.items()}, [s.cpu().numpy() for s in state]


def video_step_on_golden(device="cpu") -> tuple:
    """One `make_video_train_step` of the port at float32 on the video
    golden's inputs: (metrics, parameters after it in the JAX layout)."""
    from posecnn_torch.core.convert import params_to_numpy
    from posecnn_torch.engine import train as T
    from posecnn_torch.models import video as V

    G = goldens()
    cfg = V.VideoConfig(compute_dtype=torch.float32, **G.VIDEO_CFG)
    hp = T.TrainHParams(**G.VIDEO_HP)
    state = T.create_train_state(V.make_video_model(cfg, G.video_params(), device), hp)
    x = {k: torch.from_numpy(v).to(device) for k, v in G.video_inputs().items()}
    m = T.make_video_train_step(cfg, hp)(state, x)
    return {k: float(v) for k, v in m.items()}, params_to_numpy(state.model.state_dict())


def kfusion_on_golden(device="cpu") -> dict:
    """The port's KinectFusion on the golden's analytic scene
    (`make_torch_goldens.kfusion_scene`): the world2cam track, the final
    surface and the last camera's raycast depth, numpy."""
    from posecnn_torch.engine.kfusion import KinectFusion

    G = goldens()
    depths, _ = G.kfusion_scene()
    kf = KinectFusion(grid_size=G.KF_GRID, origin=G.KF_ORIGIN, voxel_size=G.KF_VOXEL, device=device)
    track = []
    for j, d in enumerate(depths):
        kf.feed_data(d, G.KF_K)
        if j > 0:
            kf.solve_pose()
        track.append(kf.world2cam.cpu().numpy())
        kf.fuse_depth()
    pts, labels = kf.extract_surface(max_points=4096)
    return {"track": np.stack(track), "surface": pts, "labels": labels, "raycast": kf.render(*G.KF_HW)[0]}


def _label_agreement(got: np.ndarray, ref: np.ndarray, score: np.ndarray, margin: float) -> float:
    """The share of labels equal, after leaving out the pixels whose two
    best scores lie within `margin` of each other (a tie either way)."""
    top2 = np.sort(score, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > margin
    return float((got == ref)[clear].mean()) if clear.any() else 1.0


# limits of the port against the video golden: each float output, state and
# updated parameter within VIDEO_REL of its largest magnitude (float32 sums
# in another order; the CPU reads ~1e-5 at most); labels equal where the two
# best scores are VIDEO_MARGIN apart; the step's loss terms within 1e-5
# relative; the KinectFusion track within KF_TRACK (metres and rotation
# entries), the surface points equal in count and within KF_SURFACE m
VIDEO_REL, VIDEO_MARGIN, KF_TRACK, KF_SURFACE = 1e-4, 1e-4, 1e-4, 1e-5
# the video step's parameters: each update within VIDEO_STEP of its largest move
VIDEO_STEP = 1e-3


def check_video_golden(video: tuple, video3d: tuple, step: tuple, kf: dict, g: dict) -> dict:
    """Hold the port's video paths (`video_on_golden` twice,
    `video_step_on_golden`, `kfusion_on_golden`) to the JAX golden; raises
    AssertionError past a limit. Returns each comparison's error."""
    err = {}

    def rel(name, got, ref):
        e = float(np.abs(got.astype(np.float64) - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
        err[name] = e
        if not e <= VIDEO_REL:
            raise AssertionError(f"{name}: {e:.3g} of its largest magnitude (limit {VIDEO_REL})")

    for prefix, (outs, state) in (("video", video), ("video3d", video3d)):
        for k, v in outs.items():
            ref = g[f"{prefix}/{k}"]
            if k == "label_2d":
                a = _label_agreement(v, ref, g[f"{prefix}/score"], VIDEO_MARGIN)
                err[f"{prefix}/label_2d"] = 1.0 - a
                if a < 1.0:
                    raise AssertionError(f"{prefix}/label_2d: {a:.6f} equal away from ties")
            elif k == "flag_3d":
                if not np.array_equal(v, ref):
                    raise AssertionError("video3d/flag_3d differs")
            else:
                rel(f"{prefix}/{k}", v, ref)
        names = ["state"] if prefix == "video3d" else [f"state{i}" for i in range(3)]
        for name, v in zip(names, state):
            ref = g[f"{prefix}/{name}"]
            if not np.array_equal(np.isnan(v), np.isnan(ref)):
                raise AssertionError(f"{prefix}/{name}: NaN where the golden has none, or the other way")
            rel(f"{prefix}/{name}", np.nan_to_num(v), np.nan_to_num(ref))
    metrics, params = step
    for k in ("loss", "loss_cls", "loss_regu", "lr"):
        e = abs(metrics[k] - float(g[f"step/{k}"])) / max(abs(float(g[f"step/{k}"])), 1e-30)
        err[f"step/{k}"] = e
        if not e <= 1e-5:
            raise AssertionError(f"step/{k}: {metrics[k]} against {float(g['step/' + k])}")
    p0 = goldens().video_params()
    for key in (k for k in g if k.startswith("step/") and k.count("/") >= 2):
        path = key.split("/")[1:]
        v, w0 = params[path[0]], p0[path[0]]
        for p in path[1:]:
            v, w0 = v[p], w0[p]
        ref = g[key]
        # the update against the golden's: within VIDEO_STEP of its largest move
        move = float(np.abs(ref - w0[..., :ref.shape[-1]]).max())
        e = float(np.abs(v[..., :ref.shape[-1]] - ref).max()) / max(move, 1e-30)
        err[key] = e
        if not (move > 0 and e <= VIDEO_STEP):
            raise AssertionError(f"{key}: the update {e:.3g} of its largest move {move:.3g} (limit {VIDEO_STEP})")
    e = float(np.abs(kf["track"] - g["kfusion/track"]).max())
    err["kfusion/track"] = e
    if not e <= KF_TRACK:
        raise AssertionError(f"kfusion/track: {e:.3g} (limit {KF_TRACK})")
    if kf["surface"].shape != g["kfusion/surface"].shape:
        raise AssertionError(f"kfusion/surface: {kf['surface'].shape} points, the golden {g['kfusion/surface'].shape}")
    err["kfusion/surface"] = float(np.abs(kf["surface"] - g["kfusion/surface"]).max())
    if not err["kfusion/surface"] <= KF_SURFACE:
        raise AssertionError(f"kfusion/surface: {err['kfusion/surface']:.3g} m (limit {KF_SURFACE})")
    err["kfusion/raycast"] = float(np.abs(kf["raycast"] - g["kfusion/raycast"]).max())
    if not err["kfusion/raycast"] <= 1e-4:
        raise AssertionError(f"kfusion/raycast: {err['kfusion/raycast']:.3g} m")
    return err


# The flow warp's kernel against its plain version (tests/test_torch_cuda.py,
# chip_smoke.py phase 21) on `flow_warp_case`'s inputs, at the DA-RNN
# cell's window and threshold. The forward, the mask and the divisor are
# bit-equal; the backward within FLOW_GRAD_REL of the plain gradient's norm
# (its atomics add in another order than index_add_, as each run of either
# does).
FLOW_CASES = ("identity", "all_match", "rigid")
FLOW_KERNEL, FLOW_THRESHOLD = 3, 0.02
FLOW_GRAD_REL = 1e-5


def _flow_scene(rng: np.random.RandomState, H: int, W: int, holes: float = 0.05) -> np.ndarray:
    """A depth map (H,W) in metres: a tilted plane at 1.2-2.0 m, six boxes
    in front of it at 0.5-1.2 m (depth edges), `holes` of the pixels 0."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    z = rng.uniform(1.2, 2.0) + rng.uniform(-0.3, 0.3) * xs / W + rng.uniform(-0.3, 0.3) * ys / H
    for _ in range(6):
        w, h = rng.randint(1, max(2, W // 3)), rng.randint(1, max(2, H // 3))
        x0, y0 = rng.randint(0, W - w + 1), rng.randint(0, H - h + 1)
        z[y0:y0 + h, x0:x0 + w] = rng.uniform(0.5, 1.2) + rng.uniform(-0.05, 0.05) * xs[y0:y0 + h, x0:x0 + w] / W
    z[rng.rand(H, W) < holes] = 0.0
    return z


def _rotation(rng: np.random.RandomState, angle: float) -> np.ndarray:
    k = rng.randn(3)
    k /= np.linalg.norm(k)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def flow_warp_case(case: str, B: int, H: int, W: int, C: int, seed: int = 0) -> dict:
    """numpy inputs of `compute_flow` (data, weights, points, depth, meta)
    for one of FLOW_CASES:

    - "identity": the DA-RNN cell's, identity motion over two unrelated
      scenes (`_flow_scene`), so a tap matches only where the two depths
      happen to agree;
    - "all_match": identity motion over a smooth surface, the previous
      points the current frame's own, so every in-bound tap of every pixel
      matches (the backward's most contention: 49 adds a source pixel);
    - "rigid": a camera moved by a 0.02 rad rotation and up to 3 cm over a
      scene with depth edges and pixels without depth, the previous points
      the current ones seen from the previous camera (the nearest where two
      land on one pixel, NaN where none does).

    The camera has a focal length of 1.6 W at the image centre."""
    rng = np.random.RandomState(seed)
    f = 1.6 * W
    K = np.array([[f, 0.0, (W - 1) / 2], [0.0, f, (H - 1) / 2], [0.0, 0.0, 1.0]])
    ys, xs = np.mgrid[0:H, 0:W]
    rays = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64) @ np.linalg.inv(K).T
    depth = np.zeros((B, H, W))
    points = np.full((B, H, W, 3), np.nan)
    meta = np.zeros((B, 48), np.float32)
    for b in range(B):
        R, t = np.eye(3), np.zeros(3)
        if case == "identity":
            depth[b] = _flow_scene(rng, H, W)
            prev = _flow_scene(rng, H, W)
            points[b] = np.where(prev[..., None] > 0, prev[..., None] * rays, np.nan)
        elif case == "all_match":
            depth[b] = 1.0 + 0.05 * xs / W + 0.05 * ys / H
            points[b] = depth[b][..., None] * rays
        elif case == "rigid":
            depth[b] = _flow_scene(rng, H, W)
            R, t = _rotation(rng, 0.02), rng.uniform(-0.03, 0.03, 3)
            valid = depth[b] > 0
            X = (depth[b][..., None] * rays)[valid] @ R.T + t  # in the previous camera
            u = X @ K.T
            with np.errstate(divide="ignore", invalid="ignore"):
                qx, qy = np.round(u[:, 0] / u[:, 2]), np.round(u[:, 1] / u[:, 2])
            inside = (X[:, 2] > 0) & (qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)
            order = np.argsort(-X[inside, 2], kind="stable")  # far first: the nearest written last
            idx = (qy[inside] * W + qx[inside]).astype(np.int64)[order]
            points[b].reshape(-1, 3)[idx] = X[inside][order]
        else:
            raise ValueError(f"no flow warp case {case!r} (cases: {FLOW_CASES})")
        meta[b, 0:9], meta[b, 9:18] = K.ravel(), np.linalg.inv(K).ravel()
        meta[b, 18:30] = np.hstack([R.T, (-R.T @ t)[:, None]]).ravel()  # world2live
        meta[b, 30:42] = np.hstack([R, t[:, None]]).ravel()  # live2world: the current camera into the previous
    return {"data": rng.randn(B, H, W, C).astype(np.float32),
            "weights": rng.uniform(0.5, 60.0, (B, H, W, C)).astype(np.float32),
            "points": points.astype(np.float32), "depth": depth.astype(np.float32), "meta": meta}


def flow_warp_indices(x: dict, device="cpu") -> dict:
    """`flow_warp_case`'s inputs on `device` with the projection of
    `compute_flow` (`project_pixels`): data, weights, points, px, py, z1,
    has_depth."""
    from posecnn_torch.ops.compute_flow import project_pixels

    t_ = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    _, px, py, z1, has_depth = project_pixels(t_["depth"], t_["meta"])
    return {"data": t_["data"], "weights": t_["weights"], "points": t_["points"], "px": px, "py": py, "z1": z1,
            "has_depth": has_depth}


def mask_words(match: torch.Tensor) -> torch.Tensor:
    """The plain version's ((2k+1)^2, B, H, W) match as the kernel's mask
    words: bit o of a pixel's int64 set where offset o matched."""
    bits = torch.arange(match.shape[0], device=match.device).view(-1, 1, 1, 1)
    return (match.long() << bits).sum(0)


def check_flow_warp(got: tuple, ref: tuple) -> dict:
    """got (out_data, out_weights, mask, denom, grad_data, grad_weights)
    from the kernels against ref (the same from the plain version, its
    match as `mask_words`, its denom (B,H,W,1)): bit-equal forward, mask and
    denom; each gradient within FLOW_GRAD_REL of the plain one's norm.
    Returns the gradients' relative gaps."""
    names = ("out_data", "out_weights", "mask", "denom")
    for name, a, b in zip(names, got[:4], ref[:4]):
        if not torch.equal(a, b.reshape(a.shape)):
            n = int((a != b.reshape(a.shape)).sum())
            raise AssertionError(f"flow warp {name}: {n} of {a.numel()} values differ from the plain version's")
    gaps = {}
    for name, a, b in zip(("grad_data", "grad_weights"), got[4:], ref[4:]):
        gaps[name] = float(torch.linalg.vector_norm((a - b).double())) / max(
            float(torch.linalg.vector_norm(b.double())), 1e-30)
        if not gaps[name] <= FLOW_GRAD_REL:
            raise AssertionError(f"flow warp {name}: {gaps[name]:.3g} of the plain gradient's norm "
                                 f"(limit {FLOW_GRAD_REL})")
    return gaps


def flow_warp_both(v: dict, g_data: torch.Tensor, g_weights: torch.Tensor, k: int = FLOW_KERNEL,
                   threshold: float = FLOW_THRESHOLD) -> tuple:
    """(the kernels' outputs, the plain version's) for `check_flow_warp` on
    `flow_warp_indices`' tensors, forward and backward, the backward for
    the cotangents (g_data, g_weights). The kernels need a card."""
    from posecnn_torch.ops import compute_flow as CF

    args = (v["data"], v["weights"], v["px"], v["py"])
    od, ow, mask, denom = CF.launch_forward(*args, v["z1"], v["has_depth"], v["points"], k, threshold)
    gd, gw = CF.launch_backward(g_data, g_weights, v["px"], v["py"], mask, denom, k)
    match = CF.match_plain(v["px"], v["py"], v["z1"], v["has_depth"], v["points"][..., 2].reshape(-1), k, threshold)
    rd, rw, rden = CF.window_mean_plain(*args, match, k)
    rgd, rgw = CF.window_mean_backward_plain(g_data, g_weights, v["px"], v["py"], match, rden, k)
    return (od, ow, mask, denom, gd, gw), (rd, rw, mask_words(match), rden, rgd, rgw)
