"""Model configuration of the port.

Mirrors `posecnn_tpu/models/posecnn.py:PoseCNNConfig` field for field (same
names and defaults), with `compute_dtype` as a torch dtype, so a config
written for one package reads the same in the other. Fields for parts of the
model that the port does not run yet are kept and rejected by
`models.posecnn.posecnn_forward`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

# BGR pixel means (posecnn_tpu/core/config.py:287)
PIXEL_MEANS = (102.9801, 115.9465, 122.7717)


@dataclass(frozen=True)
class PoseCNNConfig:
    num_classes: int = 22
    num_units: int = 64
    input_format: str = "COLOR"
    vertex_reg: bool = True
    vertex_reg_3d: bool = False
    pose_reg: bool = True
    adaptation: bool = False
    threshold_label: float = 1.0
    vote_threshold: float = -1.0
    vote_percentage: float = 0.02
    skip_pixels: int = 10
    is_train: bool = True
    keep_prob: float = 1.0
    compute_dtype: Any = torch.bfloat16
    hough_class_slots: int = 8
    hough_max_samples: int = 1024
    hough_center_stride: int = 4
    hough_refine_window: int = 16
    hough_pixel_stride: int = 1
    hough_sampler: str = "exact"
    label_threshold: int = 500
    hough_from_gt: bool = False
    hough_gt_mix: float = 0.0
    use_crop_pool: bool = False
    adapt_lambda: float = 0.01
    fc_dim: int = 4096
    trunk_scale: float = 1.0


def flagship_cfg(is_train: bool = False) -> PoseCNNConfig:
    """The flagship inference config (`__graft_entry__.py:_flagship_cfg`)."""
    return PoseCNNConfig(
        num_classes=22,
        num_units=64,
        input_format="COLOR",
        vertex_reg=True,
        pose_reg=True,
        is_train=is_train,
        keep_prob=1.0,
        compute_dtype=torch.bfloat16,
        hough_class_slots=8,
        hough_max_samples=512,
        hough_center_stride=4,
        hough_pixel_stride=3,
        skip_pixels=1,
        hough_sampler="approx",
    )
