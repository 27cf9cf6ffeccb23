"""Write the JAX goldens that the PyTorch port is checked against.

Runs the JAX package (on the CPU) and writes fourteen goldens:

  tests/golden/torch_port_hough_v4_000000.npz
      `hough_voting` at the flagship settings on the ground-truth label map
      and vertex field of the frozen frame data/lov_syn_val_v4/000000.npz
      (extents fixed at 0.1 m): its settings and the JAX rois, poses_init
      and valid rows.
  tests/golden/torch_port_small_slice.npz
      the whole inference slice at a small config (trunk_scale 0.125, C=4,
      fc_dim 64, 96x128, float32): the config, the weights in the
      checkpoint npz layout (`['params']['conv1_1']['weights']`), the input
      frame, meta, extents and the JAX outputs.

  tests/golden/torch_port_small_train.npz
      one flagship training step at a small config (trunk_scale 0.125,
      C=22, fc_dim 64, frames v4/000000 and 000001 at 1/8 scale, 64x80,
      float32, keep_prob 1, hough_gt_mix 1, given chroma deltas, no noise):
      the config and hyper-parameters, the batch, the ADD points, every loss
      term, the lr, the gradient's global norm and every parameter's
      gradient (JAX layout, `['conv1_1']['weights']`). The weights are not
      stored: both sides draw them with `init_params_numpy(TRAIN_SEED)`.
  tests/golden/torch_port_small_eval.npz
      the eval battery's host and ICP parts: `refine_poses` at plane weight
      0 and 1 on a fixed scene (`eval_scene`: two box-surface objects
      splatted into a 96x128 depth and label map, four detections, one of
      a class with no depth support), with the scene, and the
      `PoseEvaluator` summary of fixed detections (`eval_detections`:
      three frames over the 22 YCB classes and the stand-in object models)
      as JSON.
  tests/golden/torch_port_toy_train.npz
      two host-fed training steps (JAX's `make_train_step` on one device)
      under experiments/cfgs/toy_pose.yml at narrow widths (its model: 4
      classes, NUM_UNITS 16, its Hough settings; the trunk at 1/8 width, fc
      64, float32, keep_prob 1, STEPSIZE 1 so the second step runs at
      lr * GAMMA) on the first two batches of `GtSynthesizeLayer` (flipped
      roidb entries included): the config and hyper-parameters, the
      batches, the ADD points, each step's losses, lr and gradient norm,
      and slices of the parameters after the second step (`TOY_SLICES`).
      The weights are `init_params_numpy(TOY_SEED)` on both sides.
  tests/golden/torch_port_renders.npz
      scenes of the JAX package's host renderer (`Synthesizer.render_scene`):
      frames 0-3 of a toy SyntheticDataset (the toy base of 4 classes,
      96x128, 3 objects at most) and the bank refresh's first scene of
      lov_syn_val_v4 (seed REFRESH_SEED0; 640x480 over the stand-in hulls,
      the manifest's render params; it retries and drops objects): colour,
      label, the float32 depth of the last render pass, the classes and
      the poses (`RENDER_SCENES`).
  tests/golden/torch_port_input_modes.npz
      the host images of the DEPTH, NORMAL and RGBD inputs on frames
      v4/000000 and 000001 (640x480; `host_images`: SHA-256 digests of
      cv2's HLS, `chromatic_transform`, `depth_input_image`, `normals_np`
      and the normal image before its filter, and cv2's bilateral filter
      of it, whole), and one RGBD training step in the layout of the small
      training step (`step/`, `RGBD_CFG`: the dual tower at 1/16 width,
      the depth images as `data_p`).

  tests/golden/torch_port_det.npz
      the detection network's inference (`DET_CFG`: 4 classes, fc 64, the
      trunk at 1/4 width, float32) on frame v4/000000 at 192x192 with the
      port's seeded weights (not stored), `proposal_layer` on bf16-rounded
      scores with ties, and `ransac_pose` on a well-posed scene with its
      triplet indices (`det_golden`).
  tests/golden/torch_port_full.npz
      VGG16FULL's inference (`make_inference_fn` with
      `posecnn_full_forward`, every output) at a small config (`FULL_CFG`:
      22 classes, NUM_UNITS 8, the trunk at 1/4 width, fc 64, float32) on
      frames v4/000000 and 000001 at 64x80 with the port's seeded weights
      (`init_posecnn_full_params_numpy(FULL_SEED)`, not stored)
      (`full_golden`).
  tests/golden/torch_port_lov_batch.npz
      the JAX package's first two host batches of
      experiments/cfgs/lov_color_2d.yml (SYNROOT at the tree's data_syn/,
      SYNNUM 16: real and synthetic frames, B=2 at 640x480, device chroma
      and noise rows) on lov_train over the YCB-Video tree of
      `tests/torch_parity.py:write_lov_tree` (`lov_batch_golden`): each
      array whole, or its SHA-256 and a 16x16 crop where it is image-sized.

  tests/golden/torch_port_resnet50.npz
      ResNet-50's forward (`resnet50_forward`, float32) at 5 classes on
      frames v4/000000 and 000001 at 64x80 (`train_frames`) with the
      port's seeded weights, its batch norms moved off the identity
      (`resnet50_golden_params`, not stored; the score layer's 5 biases
      stored): score and label_2d (`resnet50_golden`).

  tests/golden/torch_port_video.npz
      the video models (`video_golden`): JAX's `video_forward` (VIDEO_CFG:
      5 classes, 8 units) and `video3d_forward` (VIDEO3D_CFG: grid 6) at
      the full trunk width on 3 frames of 32x32 with camera motion and a
      hole in the depth, float32, from the port's seeded weights with
      random gates (`video_params`, not stored): their outputs and final
      states; one `make_video_train_step` (its metrics, parameter slices
      after it); and KinectFusion's pose track, raycast and surface on an
      analytic scene under a known camera motion (`kfusion_scene`).

  tests/golden/torch_port_hough_multi.npz
      the multi-instance Hough mode (`hough_voting_multi`, unjitted, at
      `MULTI_SETTINGS`: 8 slots, 1024 samples, VOTING_THRESHOLD 100) on the
      ground-truth label maps and vertex fields of frames v4/000000 and
      000001 (extents 0.1 m): each frame's rois, poses_init and valid rows
      (`hough_multi_golden`).
  tests/golden/torch_port_tf1.ckpt.index, .data-00000-of-00001, and
  tests/golden/torch_port_tf1.npz
      a TF1 Saver checkpoint written by TensorFlow (`write_tf1_golden`): the
      flagship's smaller variables at their full shapes (`TF1_VARS`), a
      Momentum slot, `global_step` and `Variable`; and its twin, each
      variable's values under its name.

`chip_smoke.py` and the tests read them with numpy alone; the tests also
regenerate them here and compare, so a golden cannot go stale unnoticed.

Usage: JAX_PLATFORMS=cpu python tools/make_torch_goldens.py
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
HOUGH_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_hough_v4_000000.npz")
SLICE_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_small_slice.npz")
TRAIN_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_small_train.npz")
EVAL_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_small_eval.npz")
TOY_TRAIN_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_toy_train.npz")
HOUGH_FRAME = "data/lov_syn_val_v4/000000.npz"

# flagship Hough settings (__graft_entry__.py:_flagship_cfg)
HOUGH_SETTINGS = dict(
    num_classes=22, skip_pixels=1, label_threshold=500, class_slots=8, max_samples=512,
    center_stride=4, refine_window=16, pixel_grid_stride=3, sampler="approx", extent=0.1,
)

# the small slice: every module of the flagship path at narrow widths
SLICE_CFG = dict(
    num_classes=4, num_units=8, is_train=False, hough_class_slots=3, hough_max_samples=128,
    hough_center_stride=4, hough_refine_window=8, label_threshold=10, fc_dim=64,
    trunk_scale=0.125, hough_pixel_stride=3, skip_pixels=1, hough_sampler="approx",
)
SLICE_FRAME = "data/lov_syn_val_v4/000000.npz"
SLICE_SUBSAMPLE = 5  # 480x640 -> 96x128
PIXEL_MEANS = (102.9801, 115.9465, 122.7717)


def hough_inputs(frame_path: str = HOUGH_FRAME):
    """(label, vertex, extents, meta) of the Hough golden, numpy."""
    from posecnn_torch.utils.frames import gt_vertex_field
    from posecnn_torch.utils.meta import build_meta_data

    s = HOUGH_SETTINGS
    with np.load(os.path.join(ROOT, frame_path)) as f:
        label = f["label"].astype(np.int32)
        vert = gt_vertex_field(label, f["cls_indexes"], f["center"], f["poses"], s["num_classes"])
        meta = build_meta_data(f["intrinsic_matrix"])
    extents = np.full((s["num_classes"], 3), s["extent"], np.float32)
    return label, vert, extents, meta


def hough_golden() -> dict:
    import jax.numpy as jnp

    from posecnn_tpu.ops.hough_voting import hough_voting

    s = HOUGH_SETTINGS
    label, vert, extents, meta = hough_inputs()
    out = hough_voting(
        jnp.asarray(label[None]), jnp.asarray(vert[None]), jnp.asarray(extents),
        jnp.asarray(meta[None]), jnp.zeros((1, 13), jnp.float32),
        num_classes=s["num_classes"], is_train=False, skip_pixels=s["skip_pixels"],
        label_threshold=s["label_threshold"], class_slots=s["class_slots"],
        max_samples=s["max_samples"], center_stride=s["center_stride"],
        refine_window=s["refine_window"], pixel_grid_stride=s["pixel_grid_stride"],
        sampler=s["sampler"],
    )
    g = {f"settings/{k}": np.asarray(v) for k, v in s.items()}
    g["frame"] = np.asarray(HOUGH_FRAME)
    g["rois"] = np.asarray(out.rois)
    g["poses_init"] = np.asarray(out.poses_init)
    g["valid"] = np.asarray(out.valid)
    return g


def slice_inputs():
    """(raw uint8 (1,H,W,3), meta (1,48), extents (C,3)) of the small slice."""
    from posecnn_torch.utils.meta import build_meta_data

    k = SLICE_SUBSAMPLE
    with np.load(os.path.join(ROOT, SLICE_FRAME)) as f:
        raw = np.ascontiguousarray(f["color"][::k, ::k])[None]
        meta = build_meta_data(f["intrinsic_matrix"], im_scale=1.0 / k)[None]
    extents = np.full((SLICE_CFG["num_classes"], 3), 0.1, np.float32)
    return raw, meta, extents


def small_slice_golden() -> dict:
    import jax
    import jax.numpy as jnp

    from posecnn_tpu.core.checkpoint import _flatten_state
    from posecnn_tpu.models.posecnn import PoseCNNConfig, init_posecnn_params, posecnn_forward

    cfg = PoseCNNConfig(compute_dtype=jnp.float32, **SLICE_CFG)
    params = init_posecnn_params(jax.random.PRNGKey(0), cfg)
    raw, meta, extents = slice_inputs()
    means = jnp.asarray(PIXEL_MEANS, jnp.float32).reshape(1, 1, 1, 3)

    # jit off: under jit XLA rewrites the RoI bin width roi_w / 7, and
    # ceil((p + 1) * bin_w) can then end the last bin one column past the
    # reference op's edge (ROADMAP Queue 3); op by op, JAX keeps the
    # reference's bin edges
    with jax.disable_jit():
        out = posecnn_forward(params, cfg, jnp.asarray(raw).astype(jnp.float32) - means,
                              jnp.asarray(extents), jnp.asarray(meta))
    keys = ("score", "vertex_pred", "label_2d", "rois", "poses_init", "poses_tanh", "rois_valid")
    out = {k: out[k] for k in keys}
    g = {f"cfg/{k}": np.asarray(v) for k, v in SLICE_CFG.items()}
    g.update({f"weights/{k}": v for k, v in _flatten_state({"params": params}).items()})
    g.update(raw=raw, meta=meta, extents=extents)
    g.update({f"out/{k}": np.asarray(v) for k, v in out.items()})
    return g


# the small training step: every module of the flagship step at narrow widths
TRAIN_CFG = dict(
    num_classes=22, num_units=8, is_train=True, keep_prob=1.0, hough_class_slots=4, hough_max_samples=64,
    hough_center_stride=4, hough_refine_window=8, label_threshold=10, fc_dim=64, trunk_scale=0.125,
    hough_pixel_stride=1, skip_pixels=1, hough_sampler="approx", use_crop_pool=True, hough_gt_mix=1.0,
)
TRAIN_HP = dict(
    learning_rate=0.001, momentum=0.9, gamma=0.1, stepsize=40000, weight_reg=0.0001, clip_grad_norm=10.0,
    margin=0.0001, pose_norm_valid=True, quat_w=0.5,
)
TRAIN_FRAMES = ("data/lov_syn_val_v4/000000.npz", "data/lov_syn_val_v4/000001.npz")
# 480x640 -> 64x80: rows 16, 23, ..., 457 and every 8th column (a frame that
# needs no padding: the bank's zero rows would be a flat region, whose 2x2
# max-pool ties break on rounding)
TRAIN_ROWS = (16, 7, 64)  # first, step, count
TRAIN_COLS = (0, 8, 80)
TRAIN_MAX_GT = 8
TRAIN_POINTS = 64
TRAIN_SEED = 1
# HLS deltas (d_h, d_l, d_s) per image, inside the bank step's ranges
TRAIN_CHROMA = ((0.9, -12.0, 7.5), (-1.2, 20.0, -15.0))


def train_frames(paths=TRAIN_FRAMES, depth: bool = False):
    """Frozen frames resampled to 64x80 on the TRAIN_ROWS x TRAIN_COLS grid,
    with K and the centres mapped to the new pixel grid (and the depth on
    the same grid with `depth`)."""
    from posecnn_torch.data.minibatch import Frame, load_frozen_frame

    (r0, rs, rn), (c0, cs, cn) = TRAIN_ROWS, TRAIN_COLS
    rows, cols = r0 + rs * np.arange(rn), c0 + cs * np.arange(cn)
    scale = np.array([1.0 / cs, 1.0 / rs])
    shift = np.array([c0, r0], np.float64)
    out = []
    for p in paths:
        f = load_frozen_frame(os.path.join(ROOT, p))
        K = np.array(f.intrinsic_matrix, np.float64)
        K[0, :] /= cs
        K[1, :] /= rs
        K[:2, 2] -= shift * scale
        centers = ((f.center - shift) * scale).astype(np.float32)
        out.append(Frame(f.color[np.ix_(rows, cols)], f.label[np.ix_(rows, cols)], f.cls_indexes, f.poses, centers, K,
                         depth=f.depth[np.ix_(rows, cols)] if depth else None, factor_depth=f.factor_depth))
    return out


def train_inputs(num_classes: int = TRAIN_CFG["num_classes"]):
    """(batch, points, symmetry, extents), numpy: the bank of the small
    frames as one batch in frame order (pose rows assembled as the step
    does), the given chroma deltas, and P=TRAIN_POINTS seeded ADD points in
    0.1 m boxes, rescaled for the loss."""
    from posecnn_torch.data.device_bank import pack_frames
    from posecnn_torch.data.minibatch import rescale_points
    from posecnn_torch.config import YCB_SYMMETRY

    bank = pack_frames(train_frames(), TRAIN_MAX_GT)
    rows = bank["pose_rows"].copy()
    B, G, _ = rows.shape
    valid = rows[:, :, 1] > 0
    rows[:, :, 0] = np.where(valid, np.arange(B, dtype=np.float32)[:, None], 0.0)
    flat, vflat = rows.reshape(B * G, 13), valid.reshape(B * G)
    poses = np.zeros((TRAIN_MAX_GT, 13), np.float32)
    packed = np.concatenate([flat[vflat], flat[~vflat]])[:TRAIN_MAX_GT]
    poses[: len(packed)] = packed
    batch = {
        "data": bank["data"], "gt_label_2d": bank["label"].astype(np.int32), "meta_data": bank["meta_data"],
        "gt_centers": bank["gt_centers"], "poses": poses, "chroma_dhls": np.asarray(TRAIN_CHROMA, np.float32),
    }
    extents = np.full((num_classes, 3), 0.1, np.float32)
    symmetry = np.asarray(YCB_SYMMETRY[:num_classes], np.float32)
    pts = raw_points(num_classes)
    return batch, rescale_points(pts, extents, symmetry).astype(np.float32), symmetry, extents


def raw_points(num_classes: int = TRAIN_CFG["num_classes"]) -> np.ndarray:
    """The small step's metre-scale clouds (C, TRAIN_POINTS, 3): uniform in
    0.1 m boxes, class 0 (the background) at the origin."""
    pts = np.random.RandomState(0).uniform(-0.05, 0.05, (num_classes, TRAIN_POINTS, 3)).astype(np.float32)
    pts[0] = 0.0
    return pts


def jax_train_steps(cfg_kw: dict, hp_kw: dict, params: dict, batch: dict, points, symmetry, extents, n_steps: int = 1):
    """Run the JAX package's step (compute_losses + value_and_grad + the
    optimizer update at lr_schedule(step)) n_steps times on one batch, f32.
    Returns (losses of the first step, its grads, the lr, the global norm of
    its grads, the params after n_steps), all numpy, JAX layout."""
    import jax
    import jax.numpy as jnp
    import optax

    from posecnn_tpu.engine.train import TrainHParams, compute_losses, lr_schedule, make_optimizer, scale_updates
    from posecnn_tpu.models.posecnn import PoseCNNConfig

    cfg = PoseCNNConfig(compute_dtype=jnp.float32, **cfg_kw)
    hp = TrainHParams(**hp_kw)
    tx, sched = make_optimizer(hp), lr_schedule(hp)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(p)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = (jnp.asarray(points), jnp.asarray(symmetry), jnp.asarray(extents), jax.random.PRNGKey(0))
    grad_fn = jax.jit(jax.value_and_grad(compute_losses, has_aux=True), static_argnums=(1, 2))
    first = None
    for step in range(n_steps):
        (_, losses), grads = grad_fn(p, cfg, hp, jb, *args)
        lr = sched(step)
        if first is None:
            first = (
                {k: float(v) for k, v in losses.items()},
                jax.tree_util.tree_map(np.asarray, grads),
                float(lr),
                float(optax.global_norm(grads)),
            )
        updates, opt = tx.update(grads, opt, p)
        p = optax.apply_updates(p, scale_updates(updates, lr))
    return (*first, jax.tree_util.tree_map(np.asarray, p))


def train_golden(cfg_kw: dict = TRAIN_CFG, inputs=None) -> dict:
    """One step of `jax_train_steps` at `cfg_kw` on `inputs` (batch,
    points, symmetry, extents; default `train_inputs()`)."""
    from posecnn_torch.config import PoseCNNConfig as TorchCfg
    from posecnn_torch.core.convert import init_params_numpy

    params = init_params_numpy(TRAIN_SEED, TorchCfg(**cfg_kw))
    batch, points, symmetry, extents = inputs if inputs is not None else train_inputs()
    losses, grads, lr, g_norm, _ = jax_train_steps(cfg_kw, TRAIN_HP, params, batch, points, symmetry, extents)
    g = {f"cfg/{k}": np.asarray(v) for k, v in cfg_kw.items()}
    g.update({f"hp/{k}": np.asarray(v) for k, v in TRAIN_HP.items()})
    g.update({f"batch/{k}": v for k, v in batch.items()})
    g.update(points=points, symmetry=symmetry, extents=extents, seed=np.asarray(TRAIN_SEED),
             lr=np.asarray(lr), grad_norm=np.asarray(g_norm))
    g.update({f"loss/{k}": np.asarray(v, np.float32) for k, v in losses.items()})
    for layer, leaves in grads.items():
        if layer.startswith("upscore"):
            continue  # fixed bilinear filters: zero gradient, not parameters of the port
        for leaf, v in leaves.items():
            g[f"grads/['{layer}']['{leaf}']"] = v
    return g


def axis_angle(axis, deg: float) -> np.ndarray:
    """Rotation matrix of `deg` degrees about `axis` (Rodrigues)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)


def box_surface(half: float, n: int = 12) -> np.ndarray:
    """(6 * n * n, 3) points on the faces of a cube of half-side `half`."""
    g = np.linspace(-half, half, n)
    xs, ys = np.meshgrid(g, g)
    faces = []
    for s in (-half, half):
        faces += [np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, s)], 1),
                  np.stack([xs.ravel(), np.full(xs.size, s), ys.ravel()], 1),
                  np.stack([np.full(xs.size, s), xs.ravel(), ys.ravel()], 1)]
    return np.concatenate(faces).astype(np.float32)


def splat(cam: np.ndarray, K: np.ndarray, depth: np.ndarray, label: np.ndarray, cls: int) -> None:
    """Project camera-frame points (N,3) through K into the depth and label
    maps in place, keeping the nearest point of each pixel."""
    H, W = depth.shape
    uv = cam @ K.T
    u, v = (uv[:, 0] / uv[:, 2]).astype(int), (uv[:, 1] / uv[:, 2]).astype(int)
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    for ui, vi, z in zip(u[ok], v[ok], cam[ok, 2]):
        if depth[vi, ui] == 0 or z < depth[vi, ui]:
            depth[vi, ui], label[vi, ui] = z, cls


def eval_scene() -> dict:
    """The ICP scene of the eval golden, numpy: the scene of
    tests/test_eval_path.py:test_refine_poses_improves_pose (a 10 cm cube
    surface of class 1 splatted into a 96x128 depth and label map at
    fx = fy = 120, and its perturbed detection) with a 6 cm cube of class
    2 beside it, and three more detections: class 2, a second of class 1
    and one of class 3, which has no depth pixels."""
    from posecnn_torch.utils.quaternion_np import mat2quat

    H, W = 96, 128
    K = np.array([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]])
    points_all = np.zeros((4, 864, 3), np.float32)
    points_all[1], points_all[2], points_all[3] = box_surface(0.05), box_surface(0.03), 0.5 * box_surface(0.05)
    gt = {1: (axis_angle([0.3, 1.0, 0.2], 30), np.array([0.02, -0.03, 0.9])),
          2: (axis_angle([1.0, 0.2, 0.1], -25), np.array([-0.15, 0.05, 0.8]))}
    depth = np.zeros((H, W), np.float32)
    label = np.zeros((H, W), np.int32)
    for cls, (R, t) in gt.items():
        splat(points_all[cls].astype(np.float64) @ R.T + t, K, depth, label, cls)
    dets = [  # (roi, rotation perturbation (axis, deg), translation offset)
        ((0, 1, 30, 20, 100, 80, 0.9), ([0, 0, 1.0], 12), [0.01, -0.01, 0.05]),
        ((0, 2, 30, 45, 55, 65, 0.8), ([1.0, 0, 0], 8), [-0.01, 0.005, -0.04]),
        ((0, 1, 50, 30, 85, 60, 0.7), ([0, 1.0, 0], 20), [0.02, 0.0, 0.08]),
        ((0, 3, 40, 40, 60, 60, 0.6), ([0, 0, 1.0], 5), [0.0, 0.0, 0.1]),
    ]
    rois, poses = [], []
    for roi, (axis, deg), dt in dets:
        R, t = gt.get(roi[1], gt[1])
        rois.append(roi)
        poses.append(np.concatenate([mat2quat(axis_angle(axis, deg) @ R), t + np.asarray(dt)]))
    meta = np.zeros(48, np.float32)
    meta[0], meta[2], meta[4], meta[5] = K[0, 0], K[0, 2], K[1, 1], K[1, 2]
    return dict(depth=depth, label=label, points_all=points_all, meta=meta,
                rois=np.asarray(rois, np.float32), poses=np.asarray(poses, np.float32))


EVAL_PLANE_WEIGHTS = (0.0, 1.0)


def eval_detections():
    """(constructor args, per-frame add_frame kwargs) of the evaluator
    golden, numpy, from seed 7: three frames of 3-5 GT objects over the 22
    YCB classes (two of the ADD-S classes among them) with the stand-in
    object models of `posecnn_torch.data.lov_syn`; detections near every
    GT but the last, which is missed, a duplicate of the first, one of a
    class with no GT, refined and ICP poses (none on the last frame) and K
    for the reprojection error."""
    from posecnn_torch.data.imdb import YCB_SYMMETRIC_EVAL
    from posecnn_torch.data.lov import YCB_CLASSES
    from posecnn_torch.data.lov_syn import object_models
    from posecnn_torch.utils.quaternion_np import mat2quat

    points, _, extents = object_models(len(YCB_CLASSES))
    args = (list(YCB_CLASSES), extents, list(points), list(YCB_SYMMETRIC_EVAL))
    rng = np.random.RandomState(7)
    K = np.array([[1066.8, 0, 312.99], [0, 1067.5, 241.31], [0, 0, 1.0]])
    frames = []
    for f, classes in enumerate(([13, 2, 5, 21], [16, 7, 7], [1, 13, 19, 20, 3])):
        n = len(classes)
        gt = np.zeros((3, 4, n), np.float32)
        for j in range(n):
            gt[:, :3, j] = axis_angle(rng.randn(3), rng.uniform(0, 180))
            gt[:, 3, j] = [rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15), rng.uniform(0.6, 1.2)]
        rois, poses, refined, icp = [], [], [], []
        for j in range(n - 1):
            for noise in ((0.01, 5),) + (((0.05, 30),) if j == 0 else ()):
                R = axis_angle(rng.randn(3), rng.uniform(0, noise[1])) @ gt[:, :3, j]
                t = gt[:, 3, j] + rng.randn(3) * noise[0]
                rois.append([0, classes[j], 0, 0, 10, 10, rng.uniform(0.2, 1.0)])
                poses.append(np.concatenate([mat2quat(R), t]))
                refined.append(np.concatenate([mat2quat(R), gt[:, 3, j] + rng.randn(3) * 0.005]))
                icp.append(np.concatenate([mat2quat(axis_angle(rng.randn(3), 2.0) @ gt[:, :3, j]),
                                           gt[:, 3, j] + rng.randn(3) * 0.002]))
        rois.append([0, 9, 0, 0, 10, 10, 0.5])
        poses.append(np.array([1.0, 0, 0, 0, 0, 0, 1.0]))
        refined.append(poses[-1])
        icp.append(poses[-1])
        labels = rng.randint(0, 22, (2, 8, 8))
        last = f == 2
        frames.append(dict(
            pred_labels=labels[0], gt_labels=labels[1], rois=np.asarray(rois, np.float32),
            poses=np.asarray(poses, np.float32), gt_poses=gt, gt_cls_indexes=np.asarray(classes, np.float32),
            poses_refined=None if last else np.asarray(refined, np.float32),
            poses_icp=None if last else np.asarray(icp, np.float32), intrinsic_matrix=K,
        ))
    return args, frames


def score_detections(evaluator_cls) -> dict:
    """The summary of `evaluator_cls` (either package's PoseEvaluator) on
    `eval_detections`."""
    args, frames = eval_detections()
    ev = evaluator_cls(*args)
    for f in frames:
        ev.add_frame(**f)
    return ev.summary()


def eval_golden() -> dict:
    import json

    import jax.numpy as jnp

    from posecnn_tpu.data.imdb import PoseEvaluator
    from posecnn_tpu.engine.test import refine_poses

    scene = eval_scene()
    g = {f"scene/{k}": v for k, v in scene.items()}
    for w in EVAL_PLANE_WEIGHTS:  # jitted, as the JAX package runs it (no RoI pooling here)
        poses_new, poses_icp = refine_poses(
            scene["rois"], scene["poses"], scene["depth"], scene["label"], jnp.asarray(scene["points_all"]),
            scene["meta"], plane_weight=w,
        )
        g[f"plane{w:g}/poses_new"] = np.asarray(poses_new, np.float32)
        g[f"plane{w:g}/poses_icp"] = np.asarray(poses_icp, np.float32)
    g["summary"] = np.asarray(json.dumps(score_detections(PoseEvaluator), sort_keys=True))
    return g


# the toy host-fed steps: toy_pose.yml's model and solver at narrow widths
TOY_CFG_FILE = "experiments/cfgs/toy_pose.yml"
TOY_NARROW = dict(trunk_scale=0.125, fc_dim=64, keep_prob=1.0)
TOY_STEPSIZE = 1
TOY_STEPS = 2
TOY_SEED = 4  # weights whose labels give the second step a pose row (loss_pose > 0)
# parameter slices held after the second step (JAX layout)
TOY_SLICES = {
    "['conv1_1']['weights']": np.s_[:, :, :, :4],
    "['conv1_2']['weights']": np.s_[1, 1, :8, :8],
    "['conv5_3']['biases']": np.s_[:16],
    "['score']['weights']": np.s_[...],
    "['vertex_pred']['weights']": np.s_[..., :12],
    "['fc6']['biases']": np.s_[:16],
    "['fc8']['weights']": np.s_[:16],
}


def toy_train_inputs():
    """(model config kwargs, hp kwargs, batches, points, symmetry, extents),
    numpy, from the port's config builders (held to the JAX CLI's by the
    tests): toy_pose.yml over `toy_train` with its flipped entries, the
    first TOY_STEPS batches of `GtSynthesizeLayer(seed=RNG_SEED)` (bit-equal
    to JAX's), and the toy models' points rescaled for the ADD loss."""
    from dataclasses import fields

    from posecnn_torch.core import config as C
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.data.layer import GtSynthesizeLayer
    from posecnn_torch.data.minibatch import rescale_points

    cfg = C.cfg_from_file(os.path.join(ROOT, TOY_CFG_FILE))
    imdb = get_imdb("toy_train")
    imdb.append_flipped_images()
    mcfg = C.minibatch_cfg(cfg, imdb.num_classes)
    layer = GtSynthesizeLayer(imdb, mcfg, ims_per_batch=cfg.TRAIN.IMS_PER_BATCH, seed=cfg.RNG_SEED)
    batches = [layer.forward() for _ in range(TOY_STEPS)]
    mc = C.train_model_cfg(cfg, imdb.num_classes)
    cfg_kw = {f.name: getattr(mc, f.name) for f in fields(mc) if f.name != "compute_dtype"}
    cfg_kw.update(TOY_NARROW)
    hp = C.train_hparams(cfg)
    hp_kw = {f.name: getattr(hp, f.name) for f in fields(hp) if f.name != "pixel_means"}
    hp_kw["stepsize"] = TOY_STEPSIZE
    extents, symmetry = np.asarray(imdb._extents, np.float32), np.asarray(imdb._symmetry, np.float32)
    points = rescale_points(np.asarray(imdb._points_all, np.float32), extents, symmetry, mcfg.is_symmetric)
    return cfg_kw, hp_kw, batches, points.astype(np.float32), symmetry, extents


def toy_train_golden() -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    from posecnn_tpu.core.checkpoint import _flatten_state
    from posecnn_tpu.engine.train import TrainHParams, compute_losses, make_optimizer, make_train_step
    from posecnn_tpu.models.posecnn import PoseCNNConfig
    from posecnn_tpu.parallel.mesh import MeshSpec, make_mesh
    from posecnn_torch.config import PoseCNNConfig as TorchCfg
    from posecnn_torch.core.convert import init_params_numpy

    cfg_kw, hp_kw, batches, points, symmetry, extents = toy_train_inputs()
    cfg = PoseCNNConfig(compute_dtype=jnp.float32, **cfg_kw)
    hp = TrainHParams(**hp_kw)
    consts = tuple(jnp.asarray(a) for a in (points, symmetry, extents))
    step = make_train_step(cfg, hp, make_mesh(MeshSpec(data=1, model=1)), *consts, donate=False)
    grad_fn = jax.jit(jax.value_and_grad(compute_losses, has_aux=True), static_argnums=(1, 2))
    params = jax.tree_util.tree_map(jnp.asarray, init_params_numpy(TOY_SEED, TorchCfg(**cfg_kw)))
    state = (params, make_optimizer(hp).init(params), jnp.asarray(0, jnp.int32))
    key = jax.random.PRNGKey(0)  # read by nothing: keep_prob 1, no noise, no GT mix
    g = {f"cfg/{k}": np.asarray(v) for k, v in cfg_kw.items()}
    g.update({f"hp/{k}": np.asarray(v) for k, v in hp_kw.items()})
    g.update(points=points, symmetry=symmetry, extents=extents, seed=np.asarray(TOY_SEED))
    for n, batch in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        _, grads = grad_fn(state[0], cfg, hp, jb, *consts, key)
        state, metrics = step(state, jb, key)
        g.update({f"batch{n}/{k}": v for k, v in batch.items()})
        g.update({f"step{n}/{k}": np.asarray(v, np.float32) for k, v in metrics.items()})
        g[f"step{n}/grad_norm"] = np.asarray(optax.global_norm(grads), np.float32)
    flat = _flatten_state({"params": jax.tree_util.tree_map(np.asarray, state[0])})
    for k, sl in TOY_SLICES.items():
        g[f"after/{k}"] = np.ascontiguousarray(flat[f"['params']{k}"][sl])
    return g


INPUT_MODES_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_input_modes.npz")
# the HLS deltas (d_h, d_l, d_s) of the chromatic golden
INPUT_CHROMA = TRAIN_CHROMA[0]
# the RGBD step: the small training step with the dual tower, at 1/16 width
RGBD_CFG = dict(TRAIN_CFG, input_format="RGBD", trunk_scale=0.0625, fc_dim=32)


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def host_images(path: str) -> dict:
    """The JAX package's host images of the depth inputs on one frozen frame
    (640x480): digests of cv2's HLS of the colour image, of
    `chromatic_transform` at INPUT_CHROMA, of `depth_input_image`, of
    `normals_np` and of the uint8 normal image before its filter, and
    cv2's bilateral filter of that image (`bilateral`, whole)."""
    import cv2

    from posecnn_tpu.data import minibatch as JM
    from posecnn_tpu.utils.blob import chromatic_transform

    d_h, d_l, d_s = INPUT_CHROMA
    with np.load(os.path.join(ROOT, path)) as f:
        color, depth, fd, K = f["color"], f["depth"], float(f["factor_depth"]), f["intrinsic_matrix"]
    normals = JM.normals_np(depth.astype(np.float32) / fd, K)
    normal_u8 = np.ascontiguousarray((127.5 * normals + 127.5).astype(np.uint8)[:, :, (2, 1, 0)])
    return {"hls": digest(cv2.cvtColor(color, cv2.COLOR_BGR2HLS)),
            "chroma": digest(chromatic_transform(color, d_h=d_h, d_l=d_l, d_s=d_s)),
            "depth_image": digest(JM.depth_input_image(depth)), "normals": digest(normals),
            "normal_u8": digest(normal_u8), "bilateral": cv2.bilateralFilter(normal_u8, 9, 75, 75)}


def rgbd_train_inputs():
    """`train_inputs()` for the RGBD step: the batch gains `data_p`, each
    frame's depth image (`depth_input_image`, rounded to uint8), and loses
    the chroma deltas (the host jitters a depth input's colour image)."""
    from posecnn_torch.data.minibatch import _to_u8, depth_input_image

    batch, points, symmetry, extents = train_inputs()
    del batch["chroma_dhls"]
    batch["data_p"] = np.stack([_to_u8(depth_input_image(f.depth)) for f in train_frames(depth=True)])
    return batch, points, symmetry, extents


def input_modes_golden() -> dict:
    g = {}
    for i, path in enumerate(TRAIN_FRAMES):
        g.update({f"frame{i}/{k}": np.asarray(v) for k, v in host_images(path).items()})
    g.update({f"step/{k}": v for k, v in train_golden(RGBD_CFG, rgbd_train_inputs()).items()})
    return g


RENDER_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_renders.npz")
# (name, dataset, seed): the toy SyntheticDataset's frames 0-3 (seeds 0-3 of
# its train split) and the refresh's first lov_syn_val_v4 scene
RENDER_SCENES = tuple((f"toy{i}", "toy", i) for i in range(4)) + (("lov", "lov_syn_val_v4", 50_000_000),)
RENDER_TOY = dict(split="train", num_images=4, width=128, height=96, max_objects=3)


def render_synthesizers(synthetic, toy_cls) -> dict:
    """{dataset: Synthesizer} of one package's `data.synthetic` module: the
    toy SyntheticDataset's, and lov_syn_val_v4's refresh synthesizer over
    the port's stand-in arrays (`data.lov_syn.LovSynVal`, handed to
    `build_ycb_synthesizer` as a plain namespace)."""
    from types import SimpleNamespace

    from posecnn_torch.data.lov_syn import LovSynVal

    lv = LovSynVal()
    base = SimpleNamespace(classes=lv.classes, num_classes=lv.num_classes, _points_all=lv._points_all,
                           _extents=lv._extents, _class_colors=lv._class_colors, K=lv.K)
    toy = synthetic.SyntheticDataset(toy_cls("train", num_classes=4, num_images=4), **RENDER_TOY)
    return {"toy": toy.synth, "lov_syn_val_v4": synthetic.build_ycb_synthesizer(base, **lv.manifest["render_params"])}


def render_scenes(synths: dict) -> dict:
    """Each scene of RENDER_SCENES rendered by `synths`: `<name>/color`,
    `label` (uint8), `depth` (the float32 depth buffer of the render pass
    that made the frame), `cls_indexes` and `poses`."""
    g = {}
    for name, ds, seed in RENDER_SCENES:
        synth, last = synths[ds], []
        orig = synth._render_objects
        synth._render_objects = lambda *a, _o=orig: last.append(_o(*a)) or last[-1]
        try:
            f = synth.render_scene(np.random.RandomState(seed))
        finally:
            del synth._render_objects
        g.update({f"{name}/color": f.color, f"{name}/label": f.label.astype(np.uint8), f"{name}/depth": last[-1].depth,
                  f"{name}/cls_indexes": f.cls_indexes, f"{name}/poses": f.poses})
    return g


def render_golden() -> dict:
    import posecnn_tpu.data.synthetic as JS
    from posecnn_tpu.data.toy import toy

    return render_scenes(render_synthesizers(JS, toy))


DET_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_det.npz")
# the detection network at a small config: 4 classes, fc 64, the trunk at
# 1/4 width (JAX reads the widths from the weights), float32, inference
DET_CFG = dict(num_classes=4, fc_dim=64)
DET_TRUNK_SCALE = 0.25
DET_SEED = 7
DET_FRAME = "data/lov_syn_val_v4/000000.npz"
DET_ROWS, DET_COLS = (48, 2, 192), (128, 2, 192)  # 480x640 -> 192x192 (first, step, count)
# proposal_layer's inputs: a 6x7 map of 9 anchors, bf16-rounded fg
# probabilities (ties) and deltas, a 96x112 image
DET_PROPOSAL_SEED, DET_PROPOSAL_HW = 1, (96, 112)
# RANSAC: a well-posed scene of 512 correspondences (30% outliers, 40
# invalid slots) and JAX's 256 triplets under PRNGKey(DET_RANSAC_KEY)
DET_RANSAC_SEED, DET_RANSAC_KEY = 4, 9


def det_frame() -> np.ndarray:
    """(1,192,192,3) uint8: frozen frame 000000 on the DET_ROWS x DET_COLS grid."""
    from posecnn_torch.data.minibatch import load_frozen_frame

    (r0, rs, rn), (c0, cs, cn) = DET_ROWS, DET_COLS
    f = load_frozen_frame(os.path.join(ROOT, DET_FRAME))
    return np.ascontiguousarray(f.color[np.ix_(r0 + rs * np.arange(rn), c0 + cs * np.arange(cn))][None])


def det_proposal_inputs():
    """(prob (6,7,18), deltas (6,7,36), anchors (378,4)) of the golden's
    proposal_layer call."""
    import jax
    import jax.numpy as jnp

    from posecnn_torch.ops.rpn import generate_anchors, shifted_anchors

    A, Hf, Wf = 9, 6, 7
    rng = np.random.RandomState(DET_PROPOSAL_SEED)
    logits = jnp.asarray(rng.randn(Hf, Wf, A, 2).astype(np.float32)).astype(jnp.bfloat16).astype(jnp.float32)
    prob = jax.nn.softmax(logits, axis=-1)
    prob = np.asarray(jnp.concatenate([prob[..., 0], prob[..., 1]], axis=-1).astype(jnp.bfloat16).astype(jnp.float32))
    deltas = (rng.randn(Hf, Wf, 4 * A) * 0.2).astype(np.float32)
    return prob, deltas, shifted_anchors(Hf, Wf, 16, generate_anchors())


def det_ransac_inputs():
    """(object coordinates (512,3), camera points (512,3), valid (512,),
    the true R and t) of a well-posed scene: coordinates in a 12x8x6 cm
    box, 1 mm noise, 30% outliers moved by 5 cm, the last 40 slots invalid."""
    from posecnn_torch.utils.quaternion_np import quat2mat

    rng = np.random.RandomState(DET_RANSAC_SEED)
    q = rng.randn(4)
    R_gt, t_gt = quat2mat(q / np.linalg.norm(q)), np.array([0.05, -0.03, 0.9])
    n = 512
    oc = (rng.rand(n, 3) - 0.5) * np.array([0.12, 0.08, 0.06])
    cam = oc @ R_gt.T + t_gt + rng.randn(n, 3) * 1e-3
    bad = rng.rand(n) < 0.3
    cam[bad] += rng.randn(int(bad.sum()), 3) * 0.05
    valid = np.arange(n) < n - 40
    return oc.astype(np.float32), cam.astype(np.float32), valid, R_gt, t_gt


def det_golden() -> dict:
    """The detection network's inference outputs on `det_frame()` with the
    port's seeded weights (`init_vgg16_det_params_numpy(DET_SEED)`, not
    stored), `proposal_layer` on `det_proposal_inputs()` (6000/300/0.7 and
    200/50/0.5), and `ransac_pose` on `det_ransac_inputs()` with its
    triplet indices, all from the JAX package run eagerly."""
    import jax
    import jax.numpy as jnp

    from posecnn_torch.models.detection import DetConfig as TorchDet
    from posecnn_torch.models.detection import init_vgg16_det_params_numpy
    from posecnn_tpu.engine.ransac import ransac_pose
    from posecnn_tpu.models.detection import DetConfig, vgg16_det_forward
    from posecnn_tpu.ops.rpn import proposal_layer

    params = init_vgg16_det_params_numpy(DET_SEED, TorchDet(trunk_scale=DET_TRUNK_SCALE, **DET_CFG))
    raw = det_frame()
    data = raw.astype(np.float32) - np.asarray(PIXEL_MEANS, np.float32)
    cfg = DetConfig(compute_dtype=jnp.float32, is_train=False, keep_prob=1.0, **DET_CFG)
    out = {"raw": raw}
    with jax.disable_jit():
        ref = vgg16_det_forward(jax.tree_util.tree_map(jnp.asarray, params), cfg, jnp.asarray(data))
        for k in ("rpn_cls_prob", "rpn_bbox_pred", "rois", "rpn_scores", "cls_prob", "bbox_pred", "poses_tanh"):
            out[f"out/{k}"] = np.asarray(ref[k])
        prob, deltas, anchors = det_proposal_inputs()
        out.update({"prop/prob": prob, "prop/deltas": deltas, "prop/anchors": anchors})
        for name, (pre, post, thr) in (("a", (6000, 300, 0.7)), ("b", (200, 50, 0.5))):
            rois, scores = proposal_layer(jnp.asarray(prob), jnp.asarray(deltas), jnp.asarray(anchors),
                                          DET_PROPOSAL_HW, 9, pre_nms_top_n=pre, post_nms_top_n=post, nms_thresh=thr)
            out[f"prop/{name}/rois"], out[f"prop/{name}/scores"] = np.asarray(rois), np.asarray(scores)
        oc, cam, valid, _, _ = det_ransac_inputs()
        key = jax.random.PRNGKey(DET_RANSAC_KEY)
        p = jnp.asarray(valid / valid.sum(), jnp.float32)
        out["ransac/idx"] = np.asarray(jax.random.choice(key, oc.shape[0], shape=(256, 3), p=p))
        q, t, n = ransac_pose(key, jnp.asarray(oc), jnp.asarray(cam), jnp.asarray(valid))
        out.update({"ransac/q": np.asarray(q), "ransac/t": np.asarray(t), "ransac/n": np.asarray(n)})
    return out


FULL_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_full.npz")
# VGG16FULL at a small config: every scale and both fused branches, Hough
# with the approx sampler at stride 1, the crop-pooled pose branch
FULL_CFG = dict(
    num_classes=22, num_units=8, trunk_scale=0.25, fc_dim=64, is_train=False, hough_class_slots=4,
    hough_max_samples=64, hough_center_stride=4, hough_refine_window=8, label_threshold=10, hough_pixel_stride=1,
    skip_pixels=1, hough_sampler="approx", use_crop_pool=True,
)
FULL_SEED = 3
FULL_OUTPUTS = ("label_2d", "prob_normalized", "vertex_pred", "rois", "poses_init", "rois_valid", "num_rois",
                "poses_tanh")


def full_inputs():
    """(raw uint8 (2,64,80,3), meta (2,48), extents (22,3)): frames
    v4/000000 and 000001 on the small training grid (`train_frames`)."""
    from posecnn_torch.utils.meta import build_meta_data

    frames = train_frames()
    raw = np.stack([f.color for f in frames])
    meta = np.stack([build_meta_data(f.intrinsic_matrix) for f in frames])
    return raw, meta, np.full((FULL_CFG["num_classes"], 3), 0.1, np.float32)


def full_golden() -> dict:
    """JAX's inference function on VGG16FULL (`make_inference_fn` with
    `forward_fn=posecnn_full_forward`, `full_outputs`) on `full_inputs()`
    with the port's seeded weights."""
    import jax
    import jax.numpy as jnp

    from posecnn_torch.config import PoseCNNConfig as TorchCfg
    from posecnn_torch.models.posecnn_full import init_posecnn_full_params_numpy
    from posecnn_tpu.engine.test import make_inference_fn
    from posecnn_tpu.models.posecnn import PoseCNNConfig
    from posecnn_tpu.models.posecnn_full import posecnn_full_forward

    params = init_posecnn_full_params_numpy(FULL_SEED, TorchCfg(**FULL_CFG))
    raw, meta, extents = full_inputs()
    infer = make_inference_fn(PoseCNNConfig(compute_dtype=jnp.float32, **FULL_CFG), PIXEL_MEANS,
                              forward_fn=posecnn_full_forward, full_outputs=True)
    out = infer(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(raw), jnp.asarray(meta), jnp.asarray(extents))
    g = {f"cfg/{k}": np.asarray(v) for k, v in FULL_CFG.items()}
    g.update(raw=raw, meta=meta, extents=extents, seed=np.asarray(FULL_SEED))
    g.update({f"out/{k}": np.asarray(out[k]) for k in FULL_OUTPUTS})
    return g


LOV_BATCH_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_lov_batch.npz")


def lov_batch_golden() -> dict:
    """The JAX package's first host batches of lov_color_2d.yml (SYNROOT at
    the tree's data_syn/, SYNNUM 16) on lov_train over the fixture tree of
    `tests/torch_parity.py:write_lov_tree`, built as tools/train_net.py
    builds its layer (OfflineSynReader, no backgrounds), recorded by
    `lov_batch_record`."""
    import dataclasses
    import tempfile

    from posecnn_tpu.data import factory as JF
    from posecnn_tpu.data import minibatch as JM
    from posecnn_tpu.data.layer import GtSynthesizeLayer, build_background_paths
    from posecnn_tpu.data.synthetic import OfflineSynReader
    from posecnn_torch.core import config as C
    from tests import torch_parity as TP

    with tempfile.TemporaryDirectory() as root:
        lov_root = TP.write_lov_tree(root)
        old = os.environ.get("POSECNN_DATA")
        os.environ["POSECNN_DATA"] = root
        try:
            cfg = TP.lov_batch_cfg(lov_root)
            imdb = JF.get_imdb(TP.LOV_BATCH_IMDB)
            mcfg = C.minibatch_cfg(cfg, imdb.num_classes)
            jmcfg = JM.MinibatchConfig(**{f.name: getattr(mcfg, f.name) for f in dataclasses.fields(mcfg)})
            T_ = cfg.TRAIN
            reader = OfflineSynReader(T_.SYNROOT, num=T_.SYNNUM)
            assert not build_background_paths(root, cfg.INPUT)
            layer = GtSynthesizeLayer(
                imdb, jmcfg, ims_per_batch=T_.IMS_PER_BATCH, synthesize=T_.SYNTHESIZE, syn_ratio=T_.SYN_RATIO,
                syn_frames=lambda i, rng: reader.load_frame((T_.SYNITER + rng.randint(reader.num)) % reader.num),
                seed=cfg.RNG_SEED)
            return TP.lov_batch_record([layer.forward() for _ in range(TP.LOV_BATCHES)])
        finally:
            if old is None:
                del os.environ["POSECNN_DATA"]
            else:
                os.environ["POSECNN_DATA"] = old


RESNET50_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_resnet50.npz")
RESNET50_SEED, RESNET50_CLASSES = 7, 5


def resnet50_golden_params(seed: int = RESNET50_SEED, num_classes: int = RESNET50_CLASSES,
                           score_bias=None) -> dict:
    """`init_resnet50_params_numpy(seed)` with every batch norm moved off
    the identity (mean ~ 0.1 N(0, 1), variance ~ U(0.5, 1.5)), so the
    golden exercises the normalisation, and `score_bias` (the golden's
    `score_bias`, or zero) as the score layer's biases."""
    from posecnn_torch.models.resnet50 import init_resnet50_params_numpy

    p = init_resnet50_params_numpy(seed, num_classes)
    rng = np.random.default_rng(seed + 1)
    for leaves in p.values():
        if "mean" in leaves:
            c = leaves["mean"].shape[0]
            leaves["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            leaves["variance"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    if score_bias is not None:
        p["score"]["biases"] = np.asarray(score_bias, np.float32)
    return p


def resnet50_golden() -> dict:
    """JAX's `resnet50_forward` (float32) on frames v4/000000 and 000001 at
    64x80 with `resnet50_golden_params()`, the score layer's biases set to
    minus each class's mean score at zero bias (`score_bias`), so the label
    map is not one class: from random weights the trunk's features share a
    large mean, whose product with the score weights picks one class for
    every pixel."""
    import jax
    import jax.numpy as jnp

    from posecnn_tpu.models.resnet50 import resnet50_forward

    raw = np.stack([f.color for f in train_frames()])
    data = jnp.asarray(raw.astype(np.float32) - np.asarray(PIXEL_MEANS, np.float32).reshape(1, 1, 1, 3))

    def forward(bias):
        params = jax.tree_util.tree_map(jnp.asarray, resnet50_golden_params(score_bias=bias))
        return resnet50_forward(params, data, RESNET50_CLASSES, compute_dtype=jnp.float32)

    bias = -np.asarray(forward(None)["score"]).mean(axis=(0, 1, 2)).astype(np.float32)
    out = forward(bias)
    return {"raw": raw, "seed": np.asarray(RESNET50_SEED), "num_classes": np.asarray(RESNET50_CLASSES),
            "score_bias": bias, "out/score": np.asarray(out["score"]), "out/label_2d": np.asarray(out["label_2d"])}


VIDEO_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_video.npz")
# the video models at the full trunk width on small frames (the JAX video
# model has no narrow trunk), float32: T frames of 32x32, B=1
VIDEO_CFG = dict(num_classes=5, num_units=8, num_steps=3)
VIDEO3D_CFG = dict(num_classes=4, num_units=8, num_steps=3, grid_size=6, backproject_threshold=0.1)
VIDEO_SEED, VIDEO_HW = 11, (32, 32)
VIDEO_HP = dict(learning_rate=0.01, momentum=0.9, gamma=0.1, stepsize=1, weight_reg=0.0001, clip_grad_norm=10.0)
# the parameters of the video step kept whole, and the rows kept of the rest
VIDEO_STEP_WHOLE = ("gru2d", "score", "score_conv4", "score_conv5")
VIDEO_STEP_ROWS = {"conv1_1": 3, "conv1_2": 2, "conv5_3": 1}
# KinectFusion on an analytic scene: a plane and a sphere seen by a camera
# moving KF_STEP a frame (`kfusion_scene`)
KF_HW, KF_GRID, KF_FRAMES = (48, 64), 32, 4
KF_ORIGIN, KF_VOXEL = (-0.8, -0.6, 0.5), 0.05
KF_STEP = (0.01, 0.005, 0.0)
KF_K = np.array([[60.0, 0.0, 32.0], [0.0, 60.0, 24.0], [0.0, 0.0, 1.0]], np.float32)


def video_params(seed: int = VIDEO_SEED, three_d: bool = False) -> dict:
    """The port's seeded video weights (`init_video_params_numpy` or
    `init_video3d_params_numpy`) with the zero-initialised GRU gates, and
    `score`, drawn from N(0, 0.3) / N(0, 0.05) so the cells and the label
    maps vary (not stored in the golden)."""
    from posecnn_torch.models import video as V

    if three_d:
        p = V.init_video3d_params_numpy(seed, V.Video3DConfig(**VIDEO3D_CFG))
    else:
        p = V.init_video_params_numpy(seed, V.VideoConfig(**VIDEO_CFG))
    rng = np.random.RandomState(seed)
    gates = p["gru3d" if three_d else "gru2d"]["Gates"]
    gates["weights"] = (0.3 * rng.randn(*gates["weights"].shape)).astype(np.float32)
    gates["biases"] = (0.1 * rng.randn(*gates["biases"].shape)).astype(np.float32)
    p["score"]["weights"] = (0.05 * rng.randn(*p["score"]["weights"].shape)).astype(np.float32)
    return p


def video_meta(T: int, B: int, K: np.ndarray, motion: bool = True, grid=None) -> np.ndarray:
    """(T,B,48) meta_data: K, K^-1 and, with `motion`, each frame's camera
    rotated 1 degree about y and moved 1 cm along x from the last
    (world2live [18:30], live2world [30:42]); `grid` (step, origin) in
    [42:48]."""
    meta = np.zeros((T, B, 48), np.float32)
    meta[..., 0:9] = K.ravel()
    meta[..., 9:18] = np.linalg.inv(K).ravel()
    for t in range(T):
        a = np.deg2rad(1.0 * t) if motion else 0.0
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        c = np.array([0.01 * t if motion else 0.0, 0.0, 0.0])
        l2w = np.hstack([R, c[:, None]])
        w2l = np.hstack([R.T, (-R.T @ c)[:, None]])
        meta[t, :, 18:30] = w2l.ravel()
        meta[t, :, 30:42] = l2w.ravel()
    if grid is not None:
        meta[..., 42:45], meta[..., 45:48] = grid
    return meta


def video_inputs(three_d: bool = False, seed: int = VIDEO_SEED) -> dict:
    """(T,B,...) numpy inputs of the video golden: mean-subtracted data
    ~ 50 N(0, 1), depth U(0.8, 1.2) m with a 6x6 hole of no depth, labels,
    meta_data with camera motion (`video_meta`; the 3D model's voxel grid
    of 0.25 m steps from (-0.6, -0.6, 0.4))."""
    T, (H, W) = VIDEO_CFG["num_steps"], VIDEO_HW
    C = (VIDEO3D_CFG if three_d else VIDEO_CFG)["num_classes"]
    rng = np.random.RandomState(seed + (1 if three_d else 0))
    K = np.array([[30.0, 0.0, W / 2], [0.0, 30.0, H / 2], [0.0, 0.0, 1.0]])
    depth = rng.uniform(0.8, 1.2, (T, 1, H, W)).astype(np.float32)
    depth[:, :, 4:10, 20:26] = 0.0
    grid = (np.full(3, 0.25, np.float32), np.array([-0.6, -0.6, 0.4], np.float32)) if three_d else None
    return {"data": (50.0 * rng.randn(T, 1, H, W, 3)).astype(np.float32), "depth": depth,
            "gt_label_2d": rng.randint(0, C, (T, 1, H, W)).astype(np.int32),
            "meta_data": video_meta(T, 1, K, grid=grid)}


def kfusion_scene(hw=KF_HW, K=KF_K, frames: int = KF_FRAMES) -> tuple:
    """Depth maps (N,H,W) float32 of a plane at z = 1.2 m and a sphere of
    radius 0.2 m at (0, 0, 0.9) m, seen by a camera that moves KF_STEP a
    frame from the identity (no rotation); and the true world2cam poses
    (N,3,4)."""
    H, W = hw
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(np.asarray(K, np.float64)).T  # z = 1
    out, poses = [], []
    for i in range(frames):
        R = np.eye(3)
        c = i * np.asarray(KF_STEP, np.float64)
        d = rays @ R.T  # world directions, their camera z 1
        t_plane = (1.2 - c[2]) / d[..., 2]
        oc = c - np.array([0.0, 0.0, 0.9])
        b = (d * oc).sum(-1)
        q = (d * d).sum(-1)
        disc = b * b - q * ((oc * oc).sum() - 0.2 ** 2)
        t_sph = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / q, np.inf)
        out.append(np.minimum(t_plane, np.where(t_sph > 0, t_sph, np.inf)).astype(np.float32))
        poses.append(np.hstack([R.T, (-R.T @ c)[:, None]]).astype(np.float32))
    return np.stack(out), np.stack(poses)


def video_golden() -> dict:
    """JAX's `video_forward` and `video3d_forward` (float32, `video_params`,
    `video_inputs`): every output and the final state; one
    `make_video_train_step` on the video inputs (`VIDEO_HP`): its metrics
    and the parameters after it (`VIDEO_STEP_WHOLE` whole, the first rows
    of `VIDEO_STEP_ROWS`' weights' output channels); and KinectFusion on
    `kfusion_scene` (grid KF_GRID of KF_VOXEL m from KF_ORIGIN): each
    frame's tracked world2cam, the raycast depth of the last camera and the
    final surface."""
    import jax
    import jax.numpy as jnp

    from posecnn_tpu.engine.kfusion import KinectFusion
    from posecnn_tpu.engine.train import TrainHParams, make_optimizer, make_video_train_step
    from posecnn_tpu.models import video as JV
    from posecnn_tpu.parallel.mesh import MeshSpec, make_mesh

    g = {}
    tree = lambda p: jax.tree_util.tree_map(jnp.asarray, p)  # noqa: E731
    cfg = JV.VideoConfig(compute_dtype=jnp.float32, **VIDEO_CFG)
    x = video_inputs()
    outs, state = JV.video_forward(tree(video_params()), cfg, jnp.asarray(x["data"]), jnp.asarray(x["depth"]),
                                   jnp.asarray(x["meta_data"]))
    g.update({f"video/{k}": np.asarray(v) for k, v in outs.items()})
    g.update({f"video/state{i}": np.asarray(v) for i, v in enumerate(state)})
    cfg3 = JV.Video3DConfig(compute_dtype=jnp.float32, **VIDEO3D_CFG)
    x3 = video_inputs(three_d=True)
    outs, state = JV.video3d_forward(tree(video_params(three_d=True)), cfg3, jnp.asarray(x3["data"]),
                                     jnp.asarray(x3["depth"]), jnp.asarray(x3["meta_data"]))
    g.update({f"video3d/{k}": np.asarray(v) for k, v in outs.items()})
    g["video3d/state"] = np.asarray(state)

    hp = TrainHParams(**VIDEO_HP)
    step = make_video_train_step(cfg, hp, make_mesh(MeshSpec(data=1, model=1)))
    params = tree(video_params())
    (params, _, _), m = step((params, make_optimizer(hp).init(params), jnp.asarray(0, jnp.int32)),
                             {k: jnp.asarray(v) for k, v in x.items()})
    g.update({f"step/{k}": np.asarray(v) for k, v in m.items()})
    for name in VIDEO_STEP_WHOLE:
        for path, leaf in jax.tree_util.tree_flatten_with_path(params[name])[0]:
            g[f"step/{name}/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    for name, n in VIDEO_STEP_ROWS.items():
        g[f"step/{name}/weights"] = np.asarray(params[name]["weights"])[..., :n]

    depths, _ = kfusion_scene()
    kf = KinectFusion(grid_size=KF_GRID, origin=KF_ORIGIN, voxel_size=KF_VOXEL)
    track = []
    for j, d in enumerate(depths):
        kf.feed_data(d, KF_K)
        if j > 0:
            kf.solve_pose()
        track.append(np.asarray(kf.world2cam))
        kf.fuse_depth()
    pts, labels = kf.extract_surface(max_points=4096)
    g["kfusion/track"] = np.stack(track)
    g["kfusion/surface"], g["kfusion/labels"] = pts, labels
    g["kfusion/raycast"] = kf.render(*KF_HW)[0]
    return g


MULTI_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_hough_multi.npz")
MULTI_FRAMES = ("data/lov_syn_val_v4/000000.npz", "data/lov_syn_val_v4/000001.npz")
# hough_voting_multi's arguments: the dense grid at 640x480 is S=8 slots,
# 307,200 centres, 1024 samples
MULTI_SETTINGS = dict(num_classes=22, voting_threshold=100.0, per_threshold=0.02, skip_pixels=10,
                      label_threshold=500, class_slots=8, max_samples=1024, max_detections_per_image=16,
                      pixel_grid_stride=1, sampler="exact")


def hough_multi_golden() -> dict:
    """JAX's hough_voting_multi, unjitted, on each MULTI_FRAMES frame's
    ground truth (`hough_inputs`), at inference."""
    import jax.numpy as jnp

    from posecnn_tpu.ops.hough_voting import hough_voting_multi

    out = {f"settings/{k}": np.asarray(v) for k, v in MULTI_SETTINGS.items()}
    for i, path in enumerate(MULTI_FRAMES):
        label, vert, extents, meta = hough_inputs(path)
        r = hough_voting_multi(jnp.asarray(label[None]), jnp.asarray(vert[None]), jnp.asarray(extents),
                               jnp.asarray(meta[None]), jnp.zeros((1, 13), jnp.float32), is_train=False,
                               **MULTI_SETTINGS)
        for k in ("rois", "poses_init", "valid"):
            out[f"{i}/{k}"] = np.asarray(getattr(r, k))
    return out


MATCHING_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_matching.npz")
# TRAIN.MATCHING alone on the pose branch: the ADD and quaternion terms off,
# so fc6-fc8's gradients are the matching loss's (and the L2 term's)
MATCHING_HP = dict(TRAIN_HP, matching_w=1.0, pose_w=0.0, quat_w=0.0)
# the gradients kept in the golden (its size); the tests compare them all
MATCHING_GRADS = ("fc7", "fc8")


def _quat2mat_zero_safe(q, normalize: bool = False):
    """JAX's quat2mat with the quaternion norm's gradient at a zero
    quaternion taken as 0: the same values, and the same gradient wherever
    JAX's is finite. JAX's own is NaN there (0/0), and the matching loss
    normalizes the zero quaternions of the Hough rows without a class, so
    its gradient is NaN on every step (ROADMAP Queue 3 item 57)."""
    import jax.numpy as jnp

    from posecnn_tpu.utils.quaternion import quat2mat

    if normalize:
        ss = jnp.sum(q * q, axis=-1, keepdims=True)
        norm = jnp.where(ss > 0, jnp.sqrt(jnp.where(ss > 0, ss, 1.0)), 0.0)
        q = q / (norm + 1e-12)
    return quat2mat(q)


def jax_matching_losses(cfg_kw: dict, hp_kw: dict, params: dict, batch: dict, points, symmetry, extents,
                        points_raw) -> tuple:
    """JAX's compute_losses with its value_and_grad (jitted) on the raw
    clouds `points_raw` for the matching loss, its quaternion norm's
    gradient at zero taken as 0 (`_quat2mat_zero_safe`): (losses, grads
    (JAX layout), the gradient's global norm), numpy."""
    import jax
    import jax.numpy as jnp
    import optax

    import posecnn_tpu.ops.matching_loss as JM
    from posecnn_tpu.engine.train import TrainHParams, compute_losses
    from posecnn_tpu.models.posecnn import PoseCNNConfig

    cfg = PoseCNNConfig(compute_dtype=jnp.float32, **cfg_kw)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = [jnp.asarray(a) for a in (points, symmetry, extents)]
    grad_fn = jax.jit(jax.value_and_grad(compute_losses, has_aux=True), static_argnums=(1, 2, 8, 9))
    saved, JM.quat2mat = JM.quat2mat, _quat2mat_zero_safe
    try:
        (_, losses), grads = grad_fn(p, cfg, TrainHParams(**hp_kw), jb, *args, jax.random.PRNGKey(0), None, None,
                                     jnp.asarray(points_raw))
    finally:
        JM.quat2mat = saved
    return ({k: float(v) for k, v in losses.items()}, jax.tree_util.tree_map(np.asarray, grads),
            float(optax.global_norm(grads)))


def matching_golden() -> dict:
    """One JAX compute_losses at the training golden's config and batch with
    MATCHING_HP (`jax_matching_losses`; the raw clouds `raw_points`):
    the inputs, the loss terms, the gradient's global norm and the
    MATCHING_GRADS layers' gradients. The weights are not stored."""
    from posecnn_torch.config import PoseCNNConfig as TorchCfg
    from posecnn_torch.core.convert import init_params_numpy

    params = init_params_numpy(TRAIN_SEED, TorchCfg(**TRAIN_CFG))
    batch, points, symmetry, extents = train_inputs()
    raw = raw_points()
    losses, grads, g_norm = jax_matching_losses(TRAIN_CFG, MATCHING_HP, params, batch, points, symmetry, extents,
                                                raw)
    g = {f"cfg/{k}": np.asarray(v) for k, v in TRAIN_CFG.items()}
    g.update({f"hp/{k}": np.asarray(v) for k, v in MATCHING_HP.items()})
    g.update({f"batch/{k}": v for k, v in batch.items()})
    g.update(points=points, points_raw=raw, symmetry=symmetry, extents=extents, seed=np.asarray(TRAIN_SEED),
             grad_norm=np.asarray(g_norm))
    g.update({f"loss/{k}": np.asarray(v, np.float32) for k, v in losses.items()})
    for layer in MATCHING_GRADS:
        for leaf, v in grads[layer].items():
            g[f"grads/['{layer}']['{leaf}']"] = v
    return g


GAN_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_gan.npz")
GAN_SEED, GAN_SIZE, GAN_B = 5, 32, 2
# vgg16_gan at a small head: 3 classes, 4 units, the full trunk, 32x32
GAN_CLASSES, GAN_UNITS, GAN_HW = 3, 4, (32, 32)
GAN_FEAT = (2, 9, 12, 16)  # feature_discriminator's input (B, H, W, channels)


def gan_inputs() -> dict:
    """The GAN golden's inputs, numpy: DCGAN's z ~ U(-1, 1) and images in
    [-1, 1); vgg16_gan's mean-subtracted data ~ 50 N(0, 1) and vertex
    targets ~ 0.1 N(0, 1); the feature discriminator's features ~ N(0, 1)."""
    rng = np.random.RandomState(GAN_SEED)
    H, W = GAN_HW
    return {
        "z": rng.uniform(-1, 1, (GAN_B, 100)).astype(np.float32),
        "image": rng.uniform(-1, 1, (GAN_B, GAN_SIZE, GAN_SIZE, 3)).astype(np.float32),
        "pair": rng.uniform(-1, 1, (GAN_B, GAN_SIZE, GAN_SIZE, 6)).astype(np.float32),
        "data": (50.0 * rng.randn(1, H, W, 3)).astype(np.float32),
        "vertex_targets": (0.1 * rng.randn(1, H, W, 3 * GAN_CLASSES)).astype(np.float32),
        "feat": rng.randn(*GAN_FEAT).astype(np.float32),
    }


def gan_params() -> tuple:
    """(DCGAN, vgg16_gan, feature discriminator) weights, JAX layout: the
    port's seeded inits (`models/gan.py`), DCGAN's batch norms moved off
    the identity (scale, offset, running mean and variance drawn) so that
    eval mode differs from train mode."""
    from posecnn_torch.models import gan

    dc = gan.init_dcgan_params_numpy(GAN_SEED, GAN_SIZE)
    rng = np.random.RandomState(GAN_SEED + 1)
    for name, leaves in dc.items():
        if isinstance(leaves, dict) and "scale" in leaves:
            c = leaves["scale"].shape[0]
            leaves["scale"] = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
            leaves["offset"] = (0.1 * rng.randn(c)).astype(np.float32)
            leaves["mean"] = (0.1 * rng.randn(c)).astype(np.float32)
            leaves["variance"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    vg = gan.init_vgg16_gan_params_numpy(GAN_SEED, GAN_CLASSES, GAN_UNITS)
    fd = gan.init_feature_discriminator_numpy(GAN_SEED, GAN_FEAT[3])
    return dc, vg, fd


def gan_golden() -> dict:
    """JAX's GAN models (`posecnn_tpu/models/gan.py`, float32) on
    `gan_inputs` with `gan_params` (neither stored): DCGAN's generator and
    discriminator in train mode (outputs and new running statistics) and in
    eval mode after `merge_bn_stats`; `vgg16_gan_forward` (keep_prob 1) with
    vertex targets; `feature_discriminator`; `gan_losses` of the two
    discriminator passes' mean log-probabilities."""
    import jax
    import jax.numpy as jnp

    from posecnn_tpu.models import gan as JG

    x = gan_inputs()
    dc, vg, fd = (jax.tree_util.tree_map(jnp.asarray, p) for p in gan_params())
    dc["size"] = GAN_SIZE
    g = {}
    out, gstats = JG.dcgan_generator(dc, jnp.asarray(x["z"]), jnp.asarray(x["image"]), train=True, return_stats=True)
    logit, dstats = JG.dcgan_discriminator(dc, jnp.asarray(x["pair"]), train=True, return_stats=True)
    g["dcgan/train/gen"], g["dcgan/train/disc"] = np.asarray(out), np.asarray(logit)
    for name, st in {**gstats, **dstats}.items():
        for leaf, v in st.items():
            g[f"dcgan/stats/{name}/{leaf}"] = np.asarray(v)
    merged = JG.merge_bn_stats(JG.merge_bn_stats(dc, gstats), dstats)
    g["dcgan/eval/gen"] = np.asarray(JG.dcgan_generator(merged, jnp.asarray(x["z"]), jnp.asarray(x["image"]),
                                                        train=False))
    g["dcgan/eval/disc"] = np.asarray(JG.dcgan_discriminator(merged, jnp.asarray(x["pair"]), train=False))
    o = JG.vgg16_gan_forward(vg, jnp.asarray(x["data"]), GAN_CLASSES, vertex_targets=jnp.asarray(x["vertex_targets"]),
                             compute_dtype=jnp.float32)
    for k in ("score", "label_2d", "vertex_pred"):
        g[f"vgg16_gan/{k}"] = np.asarray(o[k])
    g["vgg16_gan/d_fake"], g["vgg16_gan/d_real"] = (np.asarray(d) for d in o["outputs_d"])
    g["feature_d"] = np.asarray(JG.feature_discriminator(fd, jnp.asarray(x["feat"])))
    d_loss, g_loss = JG.gan_losses(o["outputs_d"][1][..., 1].mean(), o["outputs_d"][0][..., 1].mean())
    g["gan_losses"] = np.asarray([d_loss, g_loss], np.float32)
    return g


TF1_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_tf1.ckpt")
TF1_TWIN = os.path.join(GOLDEN_DIR, "torch_port_tf1.npz")
# variables of the flagship PoseCNN (22 classes, 64 units) at their shapes
TF1_VARS = {"conv1_1/weights": (3, 3, 3, 64), "conv1_1/biases": (64,), "conv1_2/weights": (3, 3, 64, 64),
            "conv1_2/biases": (64,), "score/weights": (1, 1, 64, 22), "score/biases": (22,),
            "vertex_pred/weights": (1, 1, 128, 66), "vertex_pred/biases": (66,), "fc8/weights": (4096, 88),
            "fc8/biases": (88,)}
TF1_SEED = 7


def write_tf1_golden() -> None:
    """The TF1 checkpoint TF1_GOLDEN (TensorFlow's Saver) and its twin: 0.01
    N(0,1) values of TF1_VARS from RandomState(TF1_SEED) in sorted order, a
    Momentum slot of conv1_1's weights, global_step and Variable."""
    import shutil
    import tempfile

    import tensorflow as _tf

    tf = _tf.compat.v1
    tf.disable_eager_execution()
    rng = np.random.RandomState(TF1_SEED)
    values = {k: (rng.randn(*shape) * 0.01).astype(np.float32) for k, shape in sorted(TF1_VARS.items())}
    graph = tf.Graph()
    with graph.as_default():
        for name, v in values.items():
            scope, leaf = name.split("/")
            with tf.variable_scope(scope):
                tf.get_variable(leaf, initializer=v)
        with tf.variable_scope("conv1_1", reuse=tf.AUTO_REUSE):
            tf.get_variable("weights/Momentum", initializer=np.ones(TF1_VARS["conv1_1/weights"], np.float32))
        tf.get_variable("global_step", initializer=np.int64(160000))
        tf.get_variable("Variable", initializer=np.float32(0.0))
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            tmp = tempfile.mkdtemp()
            prefix = tf.train.Saver().save(sess, os.path.join(tmp, "model.ckpt"), write_meta_graph=False)
    for suffix in (".index", ".data-00000-of-00001"):
        shutil.copyfile(prefix + suffix, TF1_GOLDEN + suffix)
    shutil.rmtree(tmp)
    np.savez_compressed(TF1_TWIN, **values)


def main() -> None:
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for path, make in ((HOUGH_GOLDEN, hough_golden), (SLICE_GOLDEN, small_slice_golden), (TRAIN_GOLDEN, train_golden),
                       (EVAL_GOLDEN, eval_golden), (TOY_TRAIN_GOLDEN, toy_train_golden),
                       (RENDER_GOLDEN, render_golden), (INPUT_MODES_GOLDEN, input_modes_golden),
                       (DET_GOLDEN, det_golden), (FULL_GOLDEN, full_golden), (LOV_BATCH_GOLDEN, lov_batch_golden),
                       (RESNET50_GOLDEN, resnet50_golden), (VIDEO_GOLDEN, video_golden),
                       (MULTI_GOLDEN, hough_multi_golden), (MATCHING_GOLDEN, matching_golden),
                       (GAN_GOLDEN, gan_golden)):
        np.savez_compressed(path, **make())
        print(f"wrote {os.path.relpath(path, ROOT)} ({os.path.getsize(path)} bytes)")
    write_tf1_golden()
    print(f"wrote {os.path.relpath(TF1_GOLDEN, ROOT)}.* and {os.path.relpath(TF1_TWIN, ROOT)}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
