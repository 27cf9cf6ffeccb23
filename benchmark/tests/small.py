"""Small cells for the CPU tests: the frozen frames at a quarter of their
size, the trunk at an eighth of its widths, the cells' own workload files
and limits."""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from benchmark import harness


def write_small_frames(root: str, n: int = 8, step: int = 4) -> str:
    """The first n frozen frames, every step-th row and column cut to
    multiples of 16, with K scaled alike, and their manifest; returns the
    directory."""
    from posecnn_torch.data.lov_syn import FRAMES_DIR, frame_digest
    from posecnn_torch.data.minibatch import load_frozen_frame

    out = os.path.join(root, "frames")
    os.makedirs(out, exist_ok=True)
    digests = []
    for i in range(n):
        with np.load(os.path.join(FRAMES_DIR, f"{i:06d}.npz")) as d:
            arrays = {k: d[k] for k in d.files}
        for k in ("color", "label", "depth"):
            a = arrays[k][::step, ::step]  # cut to multiples of 16, as the video model needs
            arrays[k] = np.ascontiguousarray(a[:a.shape[0] // 16 * 16, :a.shape[1] // 16 * 16])
        arrays["center"] = (arrays["center"] / step).astype(np.float32)
        K = arrays["intrinsic_matrix"].copy()
        K[:2] /= step
        arrays["intrinsic_matrix"] = K
        path = os.path.join(out, f"{i:06d}.npz")
        np.savez(path, **arrays)
        digests.append(frame_digest(load_frozen_frame(path)))
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump({"name": "small", "num_images": n, "frames": digests}, f)
    return out


def small_spec(cell: str, frames_dir: str) -> harness.Spec:
    spec = harness.load_spec(cell)
    cfg = copy.deepcopy(spec.config)
    cfg["frames_dir"] = frames_dir
    if "hough" in cfg:
        cfg["trunk_scale"] = 0.125
        cfg["fc_dim"] = 64
        cfg["hough"]["label_threshold"] = 50
        cfg["object_models"]["points"] = 64
        cfg["model_overrides"] = {"trunk_scale": 0.125, "fc_dim": 64, "label_threshold": 50}
    else:
        cfg["model_overrides"] = {}
    spec.config = cfg
    return spec
