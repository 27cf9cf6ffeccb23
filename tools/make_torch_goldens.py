"""Write the JAX goldens that the PyTorch port is checked against.

Runs the JAX package (on the CPU) and writes two files:

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

`chip_smoke.py` and the tests read both with numpy alone; the tests also
regenerate them here and compare, so a golden cannot go stale unnoticed.

Usage: JAX_PLATFORMS=cpu python tools/make_torch_goldens.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
HOUGH_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_hough_v4_000000.npz")
SLICE_GOLDEN = os.path.join(GOLDEN_DIR, "torch_port_small_slice.npz")
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


def main() -> None:
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for path, make in ((HOUGH_GOLDEN, hough_golden), (SLICE_GOLDEN, small_slice_golden)):
        np.savez_compressed(path, **make())
        print(f"wrote {os.path.relpath(path, ROOT)} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
