"""Entry point of the port: flagship PoseCNN inference, raw frame to poses.

Mirrors `__graft_entry__.py:entry`: the 22-class VGG16 PoseCNN at 640x480 in
bf16, weights drawn from numpy seed 0 (`core.convert.init_params_numpy`),
Hough voting with 8 class slots, 512 samples, centre stride 4, pixel stride
3 and the approx sampler.
"""

from __future__ import annotations

import torch

from posecnn_torch.config import PIXEL_MEANS, flagship_cfg
from posecnn_torch.core.convert import init_params_numpy, make_model
from posecnn_torch.engine.test import set_float32_precision
from posecnn_torch.models.posecnn import posecnn_forward


def entry(device="cuda"):
    """Returns (fn, example_args). fn(model, raw_bgr, meta, extents) ->
    (label_2d, vertex_pred, rois, poses_init, poses_tanh), as in JAX."""
    cfg = flagship_cfg(is_train=False)
    model = make_model(cfg, init_params_numpy(0, cfg), device)
    H, W, C = 480, 640, cfg.num_classes
    means = torch.tensor(PIXEL_MEANS, dtype=torch.float32, device=device).reshape(1, 1, 1, 3)
    set_float32_precision()

    @torch.inference_mode()
    def fn(model, raw_bgr, meta, extents):
        data = raw_bgr.to(torch.float32) - means
        out = posecnn_forward(model, cfg, data, extents, meta)
        return out["label_2d"], out["vertex_pred"], out["rois"], out["poses_init"], out["poses_tanh"]

    raw = torch.zeros((1, H, W, 3), dtype=torch.uint8, device=device)
    meta = torch.zeros((1, 48), dtype=torch.float32, device=device)
    meta[0, 0], meta[0, 4], meta[0, 2], meta[0, 5] = 1066.8, 1067.5, 312.99, 241.31
    extents = torch.full((C, 3), 0.1, dtype=torch.float32, device=device)
    return fn, (model, raw, meta, extents)
