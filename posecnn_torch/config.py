"""Model configuration of the port.

Mirrors `posecnn_tpu/models/posecnn.py:PoseCNNConfig` field for field (same
names and defaults), with `compute_dtype` as a torch dtype, so a config
written for one package reads the same in the other. Fields for parts of the
model that the port does not run yet are kept and rejected by
`models.posecnn.posecnn_forward`. `flagship_cfg`, `flagship_train_cfg` and
`flagship_eval_cfg` are the flagship inference, training and evaluation
configurations; `FLAGSHIP_SOLVER` and `FLAGSHIP_TEST` the capstone's solver
and test settings.
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


# the classes of YCB-Video whose ADD loss is ADD-S (posecnn_tpu/data/lov.py:33)
YCB_SYMMETRY = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1)
# model points per class for the ADD loss (TPU.ADD_NUM_POINTS)
ADD_NUM_POINTS = 1024


def flagship_train_cfg():
    """(PoseCNNConfig, TrainHParams) of the flagship training run: what
    `tools/train_net.py:107-146` builds from
    `experiments/cfgs/lov_syn_capstone.yml` over the TPU defaults of
    `posecnn_tpu/core/config.py:178-227`, written out as code (equal to
    what `core.config`'s builders make of the file; its bank refresh is a
    data setting, run by `train_net --cfg`). Also: IMS_PER_BATCH 2,
    CHROMATIC and ADD_NOISE on, a device bank (`FLAGSHIP_TRAIN_BATCH`)."""
    from posecnn_torch.engine.train import TrainHParams

    cfg = PoseCNNConfig(
        num_classes=22,
        num_units=64,
        input_format="COLOR",
        vertex_reg=True,
        vertex_reg_3d=False,
        pose_reg=True,
        adaptation=False,
        threshold_label=1.0,
        vote_threshold=-1.0,
        is_train=True,
        keep_prob=0.5,
        compute_dtype=torch.bfloat16,
        hough_class_slots=8,
        hough_max_samples=1024,
        hough_center_stride=4,
        hough_sampler="approx",
        hough_pixel_stride=3,
        skip_pixels=1,
        use_crop_pool=True,
        hough_from_gt=False,
        hough_gt_mix=0.5,
    )
    hp = TrainHParams(
        learning_rate=0.001,
        momentum=0.9,
        gamma=0.1,
        stepsize=40000,
        weight_reg=0.0001,
        vertex_w=5.0,
        pose_w=1.0,
        adapt_weight=0.1,
        clip_grad_norm=10.0,
        margin=0.0001,
        pose_norm_valid=True,
        matching_w=0.0,
        quat_w=0.5,
        vertex_z_obj_norm=False,
    )
    return cfg, hp


# the flagship bank step's settings: IMS_PER_BATCH, TPU.MAX_GT, CHROMATIC, ADD_NOISE
FLAGSHIP_TRAIN_BATCH = dict(batch_size=2, max_gt=24, chromatic=True, add_noise=True)
# the seed of the training step's generator (RNG_SEED)
RNG_SEED = 3

# the capstone's solver settings (lov_syn_capstone.yml over the defaults of
# posecnn_tpu/core/config.py:105-112,214-217): TRAIN.SNAPSHOT_ITERS,
# SNAPSHOT_PREFIX, TPU.CHECKPOINT_OPT_STATE, TRAIN.SNAPSHOT_FINAL, DISPLAY,
# TPU.CHECKPOINT_FORMAT
FLAGSHIP_SOLVER = dict(
    snapshot_iters=5000, snapshot_prefix="vgg16_fcn_color_lov_syn_capstone", snapshot_opt_state=False,
    snapshot_final=True, display=20, snapshot_format="npz",
)
# the capstone's EXP_DIR (the default output directory is output/<EXP_DIR>/<imdb>)
EXP_DIR = "lov_syn_capstone"


def flagship_eval_cfg() -> PoseCNNConfig:
    """The model config `tools/test_net.py:129-144` builds from
    `experiments/cfgs/lov_syn_capstone.yml` over the defaults of
    `posecnn_tpu/core/config.py` (TEST.VOTING_THRESHOLD -1, TPU Hough
    settings: 8 slots, 1024 samples, centre stride 4, the approx sampler,
    pixel stride 3, skip 1, crop pool), written out as code."""
    return PoseCNNConfig(
        num_classes=22,
        num_units=64,
        vertex_reg=True,
        vertex_reg_3d=False,
        pose_reg=True,
        is_train=False,
        vote_threshold=-1.0,
        hough_class_slots=8,
        hough_max_samples=1024,
        hough_center_stride=4,
        hough_sampler="approx",
        hough_pixel_stride=3,
        skip_pixels=1,
        use_crop_pool=True,
    )


# the capstone's test settings: TEST.NMS, TEST.POSE_REFINE, TPU.ICP_PLANE_WEIGHT
FLAGSHIP_TEST = dict(nms_threshold=0.3, pose_refine=True, icp_plane_weight=1.0)
