#!/usr/bin/env python3
"""Smoke check of the PyTorch port (`posecnn_torch`) on one NVIDIA GPU.

Runs the port's main path through its user entry points and checks it:
flagship PoseCNN inference (raw 640x480 BGR frame in, ROIs and 6-DoF poses
out), the flagship training step (B=2 at 640x480 from a device bank), the
cfg-driven CLIs on the toy dataset (host-fed training at 96x128 and its
scoring), the flagship cfg's bank refresh (a host thread rendering fresh
scenes into the bank), the depth inputs (DEPTH, NORMAL, the RGBD dual
tower) and FCN-8s through the cfg-driven CLIs, the detection network
(VGG16DET) and the 3D head (VERTEX_REG_3D) through them, VGG16FULL,
the domain head (TRAIN.ADAPT) and the VGG16GAN cfg through them, and the
YCB-Video and LINEMOD loaders with the synthesis mix (TRAIN.SYNTHESIZE), more
than one rank, the rest of the CLIs' surface, dense host targets
(TPU.DEVICE_TARGETS False), TPU.DEBUG_NANS, the video models and
KinectFusion, Hough's multi-instance mode, the legacy weight readers and the
serving tools.

  1. device: CUDA present; the card's name and power limit (nvidia-smi)
  2. build: every CUDA kernel of the path (hough_vote, conv3x3, nms), the
     host rasterizer, the host bilateral filter and the PNG row filters, from
     the sources in this checkout, one compiler (nvcc, g++) per source, all
     started together
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, with median times: hough_vote's coarse
     and refine passes (votes exact, two launches bit-equal) on synthetic
     inputs and on the path's own (the 8 frozen frames' ground truth at
     P=512 and 1024), timed back to back and with a cold L2 from CUDA
     graphs of its calls and as single calls, beside its bound (the pairs
     inside a valid sample's box) and the share of pairs its box pruning
     keeps; and conv3x3 at conv1_2 (the trunk's, the bias + ReLU and the
     zero-bias epilogues at B=1 and B=2, dx at B=2; within 1 bf16 ulp;
     back-to-back, cold-L2 and single-call times beside cuDNN's bf16 conv);
     and both at the toy path's shapes (`toy_phase3`): conv3x3 at B=2,
     96x128 in the path's mode there (the zero-bias sum) and dx, beside
     cuDNN; hough_vote's coarse
     (768 centres) and refine passes at P=1024 on the first 8 toy_train
     frames' ground truth
  4. Hough voting on the card against the JAX package's golden
  5. the whole inference network, and one small training step (losses,
     every gradient, the update), on the card against the JAX package's
     goldens (small configs, float32, TF32 off)
  (4 and 5 use the checks of tests/torch_parity.py, as the tests do)
  6. flagship inference through `posecnn_torch.entry` and
     `engine.test.make_inference_fn` + `postprocess_detections` on the first
     8 frozen frames of data/lov_syn_val_v4; per-frame latency, peak memory,
     and the kernel launch counts of that run; then the same model and the
     first 2 frames through the port on the CPU, against which the card's
     labels, valid slots, classes and rois are held at bf16 limits
  7. flagship training through `posecnn_torch.entry.train_entry`: 8 steps
     (2 warm-up) with step time, peak memory and the launch counts of every
     step; then the first step's model, batch and random draws through the
     port on the CPU, forward and backward, against which the card's
     continuous losses, gradient norm and conv1_2 weight gradient are held
     at bf16 limits
  8. snapshots: the flagship train state of phase 7 written full and light
     from the card (sizes, write and restore times) and restored bit-equal;
     then `python -m posecnn_torch.train_net --iters 30` in a process of its
     own, sent SIGTERM once `train_metrics.csv` has its step-20 row: its
     snapshot at the step reached loads back bit-equal, and `--resume
     --iters 30` starts at that step and ends with the final snapshot at 30
     (the time from the start to the restore and to the first step, and the
     launches of both runs)
  9. evaluation: `python -m posecnn_torch.test_net --model <the final
     snapshot> --max_frames 32` (ICP on), and the same on a snapshot of the
     seed-0 weights, which, unlike 30 steps of training from them, leave
     classes in the label map for the ICP to refine: detections.npz,
     eval_summary.json, eval_timing.json (per-frame ms by stage, the
     launches: hough_vote 2 and conv3x3 1 a frame); the eval golden (ICP
     and the evaluator) on the card; the ICP at the flagship shapes on the
     card against the CPU port; 2 of the seed-0 run's frames through the
     port on the CPU, against which the card's labels, classes and rois are
     held as in phase 6 (a box further off only on equal votes: a plateau
     of the vote map) and poses_icp where the boxes match
  10. the toy path (`toy_phase`): `python -m posecnn_torch.train_net --cfg
     experiments/cfgs/toy_pose.yml --imdb toy_train --iters 60` (per-step
     stream ms and data-thread wait, the first and last metrics rows, every
     loss finite, 4 + 2 launches a step); the host-fed step on the card
     against the CPU port on step 1 (phase 7's limits on the losses and the
     gradient norm; conv1's weight gradients within 2x the CPU's own bf16
     gap from float32: on flat toy frames they are small residuals of
     cancelling sums); the step fed by the
     prefetch thread and by batches made beforehand; `python -m
     posecnn_torch.test_net --cfg ... --imdb toy_val --model <the iter-60
     snapshot>` (seg IoU, ADD(-S) AUC, per-frame ms by stage, 2 + 1
     launches a frame)
  11. the bank refresh (`refresh_phase`): the port's renders against the
     JAX render golden (labels, depth and colour within the limits of
     tests/torch_parity.py:check_render_golden) and the renderer's rate;
     `python -m posecnn_torch.train_net --cfg lov_syn_thr_00.yml --imdb
     lov_syn_val_v4` until its second splice (SIGTERM), with the counter
     sidecar, finite losses and the refresh's record; the flagship step in
     this process with and without the refresh, in blocks A B B A
  12. the depth inputs and FCN-8s (`input_modes_phase`): the host image
     functions (HLS jitter, noise, depth and normal images, the bilateral
     filter) against the JAX golden and timed; one full-width RGBD step
     with the vertex and pose heads on the card against the CPU port;
     `train_net --cfg rgbd_scene_single_rgbd.yml` (4 conv3x3 launches a
     step: both trunks' conv1_2, forward and dx); `train_net` and
     `test_net --cfg lov_single_depth.yml` (DEPTH, the vote kernel on its
     vertex head); `train_net` and `test_net --cfg
     rgbd_scene_single_normal_fcn8.yml` (NORMAL, FCN-8s, mean IoU) and the
     FCN-8s forward on the card against the CPU port
  13. the detection network and the 3D head (`det_3d_phase`): the NMS
     kernel against its plain version on 6000 real proposals and on
     random boxes (N = 1 to 6000 on the sweep's staged route, 12000 and
     20000 on its window route, IoUs exactly at the threshold, NaN and infinite
     coordinates; keep masks equal; back-to-back, cold-L2 and single
     times, the mask pass and the sweep by torch.profiler, beside its
     bound);
     `train_net --cfg lov_det.yml --imdb lov_syn_val_v4` (20 steps as
     shipped, then 40 at a stable rate: stream and host ms, peak memory, 2
     conv3x3 and 1 nms launches a step) and `test_net --cfg lov_det.yml` on its snapshot (mAP@0.5, ms
     a frame by stage); one full-width det step at float32, card against
     CPU, the proposals of identical RPN outputs on both, the JAX det
     golden on the card; `test_net --cfg lov_color_3d.yml` (RANSAC poses,
     its device ms) and RANSAC card against CPU on a well-posed scene; one
     3D step on rendered scenes with their vertmaps, card against CPU, and
     `train_net --cfg lov_color_3d.yml` failing on frames without one
  14. VGG16FULL, the domain head and the VGG16GAN cfg
     (`full_adapt_gan_phase`): `train_net --cfg lov_color_2d_full.yml`
     and `lov_color_sugar_box_adapt.yml` (20 steps each, B=2, 640x480,
     bf16, 4 hough_vote and 2 conv3x3 launches a step; loss_domain in the
     second's log), `test_net --cfg` on each snapshot (12 frames),
     `train_net --cfg shapenet_single_single_color_gan.yml` (10 steps, the
     label head alone, the jitter and the noise on the host); one float32
     step of VGG16FULL and one of the adaptation cfg on the card against
     the CPU port, on the cfg's first host batch with its GT pose rows put
     at the detections of a forward on the card (the same Hough rows on
     both sides; loss_pose > 0 on both; losses within 1e-4 relative, the
     gradients of conv1_2, score_conv1 or fc9, fc6, fc7, fc8 and conv5_3
     non-zero and within 5e-3 of their largest magnitude); VGG16FULL's
     inference against the JAX golden
  15. the dataset loaders, the PNG reader and the synthesis mix
     (`datasets_phase`), on trees written here with the port's PNG writer
     and scipy (no cv2): a YCB-Video tree of 16 v4 frames with a data_syn
     of 16 more read back bit-equal through get_imdb('lov_train') and
     OfflineSynReader, the reader's host ms a 640x480 frame, the first two
     host batches of lov_color_2d.yml held to the JAX golden;
     `train_net --cfg lov_color_2d.yml --imdb lov_train` (20 steps, the
     synthetic share, data wait, 4 + 2 launches a step) and `test_net
     --imdb lov_keyframe` on its snapshot; a LINEMOD tree: `train_net
     --cfg linemod_ape_pose.yml --imdb linemod_ape_train` (10 steps) and
     `test_net --imdb linemod_ape_test` at ape's 0.1 x diameter
  16. more than one rank (`mesh_phase`): NCCL at world size 1 (an
     all-reduce and an all-gather held to their values, a 134M-float
     all-reduce timed); `train_net --cfg lov_color_2d.yml --imdb lov_train`
     as two ranks on the one card over gloo (NCCL refuses two ranks on one
     GPU), mesh (2,1), one image a rank: each rank's launches (2 hough_vote,
     2 conv3x3 a step), stream ms and peak memory; one f32 step at (2,1)
     and one at (1,2) (fc6, fc7 split at full width) as two ranks
     (`python3 chip_smoke.py mesh-rank <dir>`) on the cfg's first global
     batch with its GT rows at the detections and its draws replayed, held
     to the one-process step on the card (loss terms, fc6, fc7, conv5_3,
     conv1_2); the gradients' all-reduce over gloo timed; and
     `entry.dryrun_multichip(2)` on the card
  17. the rest of the CLIs' surface (`cli_surface_phase`): ResNet-50
     trained and scored through the CLIs and held to its JAX golden,
     `test_net --vis` and `train_net --vis` against the host redraw,
     diag_rot, isolate_pose, supervise_train through a stall, the RoI
     pool's forward against the masked max it replaced
  18. dense host targets, DEBUG_NANS, the video models and KinectFusion
     (`video_phase`): the video golden on the card against JAX and the CPU
     port; at full width on phase 15's tree the video train step, test_net_video
     with KinectFusion at grid 128 and video3d at grid 32; lov_color_2d.yml
     with TPU.DEVICE_TARGETS False; toy_pose.yml under TPU.DEBUG_NANS; the
     KinectFusion tool on depth PNGs of an analytic scene
  19. the multi-instance mode, the weight readers and the serving tools
     (`serving_phase`): hough_vote on the multi mode's dense grid (S=8,
     640x480 = 307,200 centres, P=1024) against its plain version and
     timed; `hough_voting_multi` on two frames' ground truth against the
     JAX golden and one frame against the CPU port; test_net on the
     flagship cfg with TEST.VOTING_THRESHOLD 100; train_net --weights
     (a vgg16.npy pickled here, into both trunks of the RGBD cfg); the
     committed TF1 checkpoint read without TensorFlow and through test_net
     --model; `tools.online --serve` in its own process (file, base64 and
     JPEG requests), `--watch --once` and `tools.demo --visualize`
  then the CPU-port checks' record, each phase's seconds and each CLI
     run's (where it ran, its set-up time), the kernels' JSON line, then
     {"ok": true, "device": {...}}

The CPU port's side of the card-against-CPU checks of phases 7, 9, 10,
12, 13, 14 and 19 runs on a thread of its own (`defer`, CPU_THREADS of the
host's cores) beside the card phases that follow, each printing its line
when it ends; the script waits for them before its summary (`drain`), and a
failed check there fails the script as anywhere else. The host-bound
times of the card phases that run beside them share the host's cores.

The CLIs run in this process through their `main(argv)` (`run_cli`), but
for phase 8's SIGTERM and --resume runs, phase 11's SIGTERM run and phase
16's ranks, which have processes of their own. Their scratch directory is made under the
checkout's git-ignored output/ and removed at the end. Any failure raises
and the process exits nonzero; nothing falls back to the CPU. It imports
no JAX. Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import functools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FRAMES_DIR = os.path.join(ROOT, "data", "lov_syn_val_v4")
N_FRAMES, N_WARMUP = 8, 2
# phase 6: the frames of N_FRAMES that the CPU port runs too (~4 s a frame
# on the card's host; 8 until the script neared its time limit, 4 until
# phase 18 took it past ~1000 s, then 2); phase 9's frames on the CPU port
# (~13 s a frame, ICP included; 4 until then; 2 holds one detection whose
# box matches, which its ICP check needs)
N_CPU_FRAMES, N_EVAL_CPU_FRAMES = 1, 2
N_STEPS = 8
# phase 10: the toy CLI's steps, the in-process feed comparison's, and the
# steps left out of the medians
TOY_STEPS, TOY_FEED_STEPS, TOY_WARMUP = 60, 30, 5
# phase 11: renders timed alone, the refresh CLI's cap on steps, and the
# steps of each block of the in-process comparison
REFRESH_RENDERS, REFRESH_MAX_STEPS, REFRESH_BLOCK = 32, 2000, 20
# phase 12: each train CLI's steps (the DEPTH and FCN-8s runs end in the
# snapshot their test_net scores) and the steps left out of the medians
# (the first step's warm-up, then the prefetch queue's 4 batches made
# meanwhile, which hide the data thread's rate); the frames each test_net
# scores and those left out of its medians; the timed calls of each host
# image function
INPUT_STEPS, INPUT_WARMUP, INPUT_EVAL_FRAMES, INPUT_EVAL_WARMUP, HOST_REPS = 16, 8, 12, 3, 10

# the H100's published peaks (NVIDIA's data sheet, SXM part, dense rates)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_F32_FLOP_PER_S = 67e12
# f32 operations of one centre x sample vote test: dx, dy, the dot product
# (2 mul, 1 add), |c-p|^2 (2 mul, 1 add), dot^2 and tsq*|c-p|^2. The vote
# bound counts one for each pair inside a valid sample's box (`vote_pairs`):
# the others fail the test whatever they hold, and need none.
VOTE_TEST_OPS = 10
# the card against the CPU port on one flagship training step with the same
# draws: relative limits of the continuous loss terms and of the gradient's
# global norm, and of two weight gradients as their largest |error| over
# their largest magnitude: conv1_2's (the kernel runs its forward) and
# conv1_1's (the kernel's dx is its cotangent). Both sides run the bf16
# network, each summing its convolutions in its own order. Measured before
# they were set (H100, PERF.md section 6): loss_regu 0, loss_cls 1.7e-5,
# loss_vertex 3.5e-5, grad_norm 7.0e-4, conv1_2 4.9e-3 (conv1_1's limit was
# set with no reading of its own; it then read 8.3e-3)
TRAIN_LOSS_LIMITS = {"loss_regu": 1e-6, "loss_cls": 1e-3, "loss_vertex": 1e-3, "grad_norm": 5e-3}
TRAIN_GRAD_LIMITS = {"trunk.conv1_1.weight": 5e-2, "trunk.conv1_2.weight": 2e-2}
# the card against the CPU port on the eval CLI's frames, where the boxes
# match: the ICP's translation, and 1 - |cos| of the angle between the
# quaternions. With random weights a detection's label region is a blob of
# the frame and the ICP, 20 steps from a random rotation, is ill-posed, so
# inputs a bf16 rounding apart can end apart (the CPU tests measured 1e-2
# in the quaternion from inputs one f32 ulp apart, tests/test_torch_eval.py)
EVAL_ICP_T, EVAL_ICP_Q = 1e-2, 1e-2
# phase 13: the detection trainer's steps (a multiple of lov_det.yml's
# DISPLAY, 20, so the log shows the last step's losses) and those left out of
# the medians; the frames each detection and 3D test_net scores and those
# left out of its medians
DET_STEPS, DET_WARMUP, DET_EVAL_FRAMES, DET_EVAL_WARMUP = 40, 8, 12, 3
# the shipped lov_det.yml's steps (its LEARNING_RATE 0.001 diverges from the
# init rules, in the JAX trainer too), and the rate of the timed run
DET_SHIPPED_STEPS, DET_STABLE_LR = 20, 1e-5
# f32 operations of one IoU test of the NMS kernel: the intersection's two
# widths (min, max, subtract, add 1, clamp at 0: 5 each), their product, the
# union (the two areas' sum less the intersection: 2), the division and the
# comparison with the threshold. The bound counts the tests a greedy sweep
# of this run's boxes needs: each kept box against each later box that no
# kept box before it has removed (`nms_sweep_tests`).
NMS_TEST_OPS = 15
# the NMS kernel's cold-L2 time: calls on this many copies of the boxes in
# turn, each with its mask words in a block of its own (~92 MB at 6000)
NMS_COLD_CALLS = 40
# boxes of an NMS case on the sweep's second route (more than the 9408
# whose tiles the sweep stages whole in shared memory; 12000 is another)
NMS_WINDOW_BOXES = 20000
# the card against the CPU port on one full-width det step at float32 (TF32
# off): relative limits of the loss terms and of the gradient's global norm
# (phase 7's), and of the gradients of the proposal path, fc6 and conv1_2 as
# their largest |error| over their largest magnitude (phase 7's conv1_2
# limit). Both sides must sample the same rois first (labels equal, boxes
# within 1e-2 px): the RCNN terms and the gradients follow them
DET_LOSS_LIMITS = {"loss_rpn_cls": 1e-3, "loss_rpn_box": 1e-3, "loss_cls": 1e-3, "loss_box": 1e-3,
                   "loss_pose": 1e-3, "loss_regu": 1e-6, "grad_norm": 5e-3}
DET_GRAD_LIMITS = {"rpn_bbox_pred.weight": 2e-2, "conv_rpn.weight": 2e-2, "fc6.weight": 2e-2,
                   "trunk.conv1_2.weight": 2e-2}
# phase 14: the VGG16FULL and adaptation trainers' steps (DISPLAY, 20, so
# the log shows the last step's losses) and the GAN trainer's, the steps
# left out of the medians (the first step's warm-up, then the prefetch
# queue's batches made meanwhile); the frames each test_net scores and those
# left out of its medians
SLICE_J_STEPS, GAN_STEPS, SLICE_J_WARMUP, GAN_WARMUP = 20, 10, 8, 5
SLICE_J_EVAL_FRAMES, SLICE_J_EVAL_WARMUP = 12, 3
SLICE_J_CFGS = {"full": "lov_color_2d_full.yml", "adapt": "lov_color_sugar_box_adapt.yml",
                "gan": "shapenet_single_single_color_gan.yml"}
# the card against the CPU port on one float32 step (TF32 off) of VGG16FULL
# and of the adaptation cfg, with the same batch, weights and draws: each
# loss term within SLICE_J_LOSS_LIMIT relative, the gradient's global norm
# within SLICE_J_GRAD_LIMIT relative, and these gradients non-zero and
# within SLICE_J_GRAD_LIMIT of their largest magnitude: the trunk's, the
# heads', and the pose branch's fc6, fc7, fc8 (VGG16FULL's
# poses_pred_unnormalized) and conv5_3 (read through the crop pool), which
# get a gradient once the batch's GT pose rows sit at the detections. Both
# sides must sample the same Hough rows first (valid rows and classes
# equal, boxes within 1e-2 px)
SLICE_J_LOSS_LIMIT, SLICE_J_GRAD_LIMIT = 1e-4, 5e-3
# phase 15: lov_color_2d.yml's steps on the YCB-Video tree (DISPLAY, 20,
# so the log shows the last step's losses) and LINEMOD's, the LINEMOD
# tree's frames, the steps left out of the medians, and the frames left out
# of each test_net's medians
LOV_STEPS, LINEMOD_STEPS, LINEMOD_FRAMES, LOV_WARMUP, LINEMOD_WARMUP, EVAL_WARMUP = 20, 10, 8, 8, 5, 3
# phase 16: train_net's steps at two ranks on the one card (over gloo: NCCL
# refuses two ranks on one GPU); the limits of the f32 mesh steps against
# the one-process step on the card: loss terms relative, and each updated
# parameter's largest |error| over its largest magnitude. Sums in another
# order part them by ~1e-6; fc6's limit is wider, since its GEMM at another
# shape (72 rows a rank at (2,1), 2048 columns at (1,2)) rounds a
# pre-activation that sits at zero to the other side of its ReLU: that
# moves one output row of fc6's update whole. Measured before the limit was
# set (H100, PERF.md section 6): the one-process step equal across
# processes and in one process; both meshes 1.75e-4 on fc6 (one row of
# 4096 over 1e-5), conv5_3 1.07e-5, conv1_2 9.0e-6, fc7 6.8e-7, the loss
# terms 1.7e-7. The all-reduce timed through NCCL at world size 1 has the
# flagship's gradients' size (134M floats)
MESH_STEPS, MESH_LOSS_LIMIT = 4, 1e-4
MESH_PARAMS = {"fc6.weight": 1e-3, "fc7.weight": 1e-4, "trunk.conv5_3.weight": 1e-4, "trunk.conv1_2.weight": 1e-4}
# fc6's output rows whose update may part by more than 1e-5 of its largest
# magnitude (a ReLU crossing each); 1 measured
MESH_FC6_ROWS = 4
NCCL_FLOATS = 134_000_000
# phase 17: ResNet-50's train_net steps (DISPLAY 20: the log shows steps 1
# and 20) and the steps left out of its medians (the warm-up, then the
# prefetch queue's batches made meanwhile), its test_net frames and those
# left out of the medians; the frames of test_net --vis and of diag_rot;
# isolate_pose's steps, evaluation period and frames; the supervised toy
# run's steps, its stall threshold (toy_pose.yml's DISPLAY is 2: a row
# every 2 steps), and the metrics row after which its child is paused
R50_STEPS, R50_WARMUP, R50_EVAL_FRAMES, R50_EVAL_WARMUP = 20, 8, 8, 3
VIS_FRAMES, DIAG_FRAMES, VIS_TRAIN_STEPS, ROI_REPS = 4, 4, 10, 20
ISO_STEPS, ISO_REPORT, ISO_FRAMES = 20, 10, 4
SUP_STEPS, SUP_STALL_S, SUP_PAUSE_AT = 30, 15, 10
# phase 18: the video model's train steps (T=5, B=1) and those left out of
# the medians; the frames test_net_video scores (one video of the tree) and
# those left out; the dense-targets trainer's steps (its DISPLAY) and
# warm-up; the DEBUG_NANS toy trainer's steps and warm-up; the frames of the
# KinectFusion tool's analytic scene
VIDEO_STEPS, VIDEO_WARMUP, VIDEO_EVAL_WARMUP, DENSE_STEPS, DENSE_WARMUP = 6, 3, 2, 10, 5
NANS_STEPS, NANS_WARMUP, KF_TOOL_FRAMES = 10, 3, 4
# phase 19: the frames of test_net in the multi-instance mode, of the online
# server (each sent by file and as base64) and its watch loop, and of the demo
MULTI_EVAL_FRAMES, SERVE_FRAMES, DEMO_FRAMES = 4, 4, 5
SLICE_J_GRADS = {"full": ("trunk.conv1_2.weight", "score_conv1.weight", "fc6.weight", "fc7.weight",
                          "poses_pred_unnormalized.weight", "trunk.conv5_3.weight"),
                 "adapt": ("trunk.conv1_2.weight", "fc6.weight", "fc9.weight", "fc7.weight", "fc8.weight",
                           "trunk.conv5_3.weight")}


_T0 = time.perf_counter()


# the seconds since the script started at each phase's first line
PHASE_START = {}


def phase(n: int, msg: str) -> None:
    """A phase's line, with the seconds since the script started."""
    now = time.perf_counter() - _T0
    PHASE_START.setdefault(n, now)
    print(f"[phase {n}] [{now:.1f} s] {msg}", flush=True)


def print_timeline() -> None:
    """Each phase's seconds (from its first line to the next phase's; the
    first line comes when the phase's first check is done), then each CLI
    run's: where it ran, its wall seconds, the seconds to its first step's
    log line (train_net), and the card memory already allocated when an
    in-process run began."""
    ends = sorted(PHASE_START.items()) + [(None, time.perf_counter() - _T0)]
    print("phase seconds: " + json.dumps({n: round(b - a, 1) for (n, a), (_, b) in zip(ends, ends[1:])}),
          flush=True)
    for r in CLI_RUNS:
        print(f"[cli] {r['args']}: {r['where']}, {r['wall_s']:.1f} s"
              + (f", first step's line at {r['first_step_s']:.1f} s" if r["first_step_s"] is not None else "")
              + (f", set-up and output {r['wall_s'] - r['loop_s']:.1f} s (the evaluation loop {r['loop_s']:.1f} s)"
                 if "loop_s" in r else "")
              + (f", {r['resident_mib']:.0f} MiB already allocated" if "resident_mib" in r else ""), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# the CPU port's side of the card-against-CPU comparisons: each runs, with
# its checks and its phase line, on a thread of its own beside the card
# phases that follow (`defer`), on CPU_THREADS of the host's cores, and the
# script waits for all of them before its summary (`drain`); a failed check
# there fails the script at its end, as anywhere else
CPU_THREADS = 5
_CPU_JOBS = []


def defer(n: int, what: str, job) -> None:
    """Run `job()` (the CPU side of a phase-n check, which prints its own
    line) on the CPU worker thread; its failure is raised by `drain`."""
    import queue
    import threading

    if not _CPU_JOBS:
        q = queue.Queue()

        def worker():
            import torch

            torch.set_num_threads(CPU_THREADS)
            while True:
                item = q.get()
                if item is None:
                    return
                rec, fn = item
                t0 = time.perf_counter()
                try:
                    fn()
                except BaseException as e:  # noqa: BLE001 - raised again by drain
                    rec["error"] = e
                rec["s"] = time.perf_counter() - t0

        thread = threading.Thread(target=worker, name="cpu-port", daemon=True)
        thread.start()
        _CPU_JOBS.append({"queue": q, "thread": thread, "records": []})
    rec = {"phase": n, "what": what, "queued_at": time.perf_counter() - _T0}
    _CPU_JOBS[0]["records"].append(rec)
    _CPU_JOBS[0]["queue"].put((rec, job))


def drain() -> None:
    """Wait for the deferred CPU-port checks; print each one's seconds and
    raise the first failure."""
    if not _CPU_JOBS:
        return
    w = _CPU_JOBS.pop()
    t0 = time.perf_counter()
    w["queue"].put(None)
    w["thread"].join()
    print(f"CPU-port checks on their own thread ({CPU_THREADS} threads; the script waited "
          f"{time.perf_counter() - t0:.1f} s for the last): "
          + json.dumps([{k: (round(v, 1) if isinstance(v, float) else v) for k, v in r.items() if k != "error"}
                        for r in w["records"]]), flush=True)
    for r in w["records"]:
        if "error" in r:
            raise AssertionError(f"phase {r['phase']}, {r['what']} (on the CPU thread) failed") from r["error"]


def median_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Device time of one fn() call: the median over `reps` rounds of
    `inner` back-to-back calls between one pair of CUDA events, divided by
    `inner`, so the host's part of a call (allocation, checks, the launch)
    hides behind the device's work of the call before it. An untimed call
    ahead of each round keeps the card busy while the first is queued."""
    import torch

    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def cold_ms(fn, inputs, reps: int = 10) -> float:
    """Device time of one fn(x) call with a cold L2: each round calls fn on
    every input in turn, keeping every output, so the inputs and outputs
    together pass through more than the L2 holds; the median over `reps`
    rounds of the round's time over its calls. An untimed call on the last
    input ahead of each round keeps the card busy while the first is
    queued (the inputs between evict it again)."""
    import torch

    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        outs = [fn(inputs[-1])]
        e0.record()
        outs += [fn(x) for x in inputs]
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / len(inputs))
        del outs
    return statistics.median(times)


def single_ms(fn, reps: int = 20) -> float:
    """Time of one fn() call on an idle card, the host's part included:
    CUDA events around the call, median of `reps`."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def vote_pairs(samples, centers, chunk: int = 1024):
    """(pairs that need a test, valid pairs) of hough_vote on these card
    tensors: a (slot, centre, sample) pair needs one when the sample is valid
    and the centre lies inside its box, |cx - px| < thr and |cy - py| < thr
    with the kernel's rounded subtraction; every other pair fails the vote
    test whatever its direction. Counted on the card in chunks of centres."""
    px, py, thr = samples[:, 0, :, None], samples[:, 1, :, None], samples[:, 5, :, None]
    val = samples[:, 7, :, None] > 0
    inside = 0
    for c0 in range(0, centers.shape[2], chunk):
        cx, cy = centers[:, 0, None, c0:c0 + chunk], centers[:, 1, None, c0:c0 + chunk]
        inside += int((val & ((cx - px).abs() < thr) & ((cy - py).abs() < thr)).sum())
    return inside, int(val.sum()) * centers.shape[2]


def vote_bound(nbytes: float, pairs: float):
    """hough_vote's bound: one test of VOTE_TEST_OPS f32 operations for each
    pair that needs one (`vote_pairs`) at the f32 peak, against the bytes
    of samples and centres read once and votes and dsum written once at
    the memory rate."""
    return bound_ms(nbytes, pairs * VOTE_TEST_OPS, PEAK_F32_FLOP_PER_S)


def pruned_pairs(samples, centers, grid_w: int, tile_w: int = 16, tile_h: int = 4) -> int:
    """The pairs hough_vote tests after its box pruning: for each slot and
    tile of centres (tile_w x tile_h points of a grid of width `grid_w`,
    else tile_w * tile_h consecutive centres, as csrc/hough_vote.cu tiles
    them), the tile's centres times the valid samples whose box reaches the
    tile's bounding rectangle. A measurement of the design, computed here."""
    import torch

    nc = centers.shape[2]
    c = torch.arange(nc, device=samples.device)
    if grid_w > 0:
        tile = (c // grid_w // tile_h) * -(-grid_w // tile_w) + (c % grid_w) // tile_w
    else:
        tile = c // (tile_w * tile_h)
    n_tiles = int(tile.max()) + 1
    cx, cy = centers[:, 0], centers[:, 1]  # (Sc, NC)
    idx = tile.expand_as(cx)
    inf = torch.full((cx.shape[0], n_tiles), float("inf"), device=samples.device)
    xmin, ymin = inf.scatter_reduce(1, idx, cx, "amin"), inf.scatter_reduce(1, idx, cy, "amin")
    xmax, ymax = (-inf).scatter_reduce(1, idx, cx, "amax"), (-inf).scatter_reduce(1, idx, cy, "amax")
    px, py, thr = samples[:, None, 0], samples[:, None, 1], samples[:, None, 5]  # (S, 1, P)
    keep = ((samples[:, None, 7] > 0) & ~(xmin[..., None] - px >= thr) & ~(xmax[..., None] - px <= -thr)
            & ~(ymin[..., None] - py >= thr) & ~(ymax[..., None] - py <= -thr))  # (S, tiles, P)
    per_tile = torch.bincount(tile, minlength=n_tiles)
    return int((keep.sum(dim=2) * per_tile).sum())


def graph_ms(calls, reps: int = 20) -> float:
    """Device time of one call with no host work between calls: the
    no-argument functions `calls` captured once, in order, into a CUDA graph
    (each called once beforehand on a side stream);
    the median over `reps` replays of a replay's time over len(calls). An
    untimed replay ahead of each keeps the card busy while it is queued."""
    import torch

    # one warm-up call of each on a side stream before the capture (a cuDNN
    # call picks its algorithm and workspace there)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in {id(f): f for f in calls}.values():
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [f() for f in calls]
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        g.replay()
        e0.record()
        g.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / len(calls))
    del outs, g
    return statistics.median(times)


def conv_bound(B: int, H: int, W: int, cin: int, cout: int):
    """conv3x3's bound: 2*9*Cin*Cout MACs' operations a pixel at the bf16
    tensor-core rate; x and y (bf16), w (bf16) and the bias (f32) moved once."""
    nbytes = B * H * W * (cin + cout) * 2 + 9 * cin * cout * 2 + cout * 4
    return bound_ms(nbytes, 2.0 * 9 * cin * cout * B * H * W, PEAK_BF16_FLOP_PER_S)


def vote_inputs(rng: np.random.RandomState, S: int, P: int, H: int, W: int):
    """Packed samples (S, 8, P) in the range the Hough front end produces at
    640x480 (pixel-grid coordinates, unit directions, depths 0.5-2 m, box
    thresholds of 0.1 m extents, 10% invalid), the shared coarse grid
    (1, 2, NC) at stride 4, and per-slot 16x16 refine windows (S, 2, 256)."""
    px = (rng.randint(0, W // 3, (S, P)) * 3).astype(np.float32)
    py = (rng.randint(0, H // 3, (S, P)) * 3).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (S, P)).astype(np.float32)
    u, v = np.cos(ang), np.sin(ang)
    d = rng.uniform(0.5, 2.0, (S, P)).astype(np.float32)
    thr = (0.6 * (1066.8 * 0.1 / d + 1)).astype(np.float32)
    tsq = np.float32(0.81) * (u * u + v * v)
    val = (rng.rand(S, P) > 0.1).astype(np.float32)
    samples = np.stack([px, py, u, v, d, thr, tsq, val], axis=1)
    gx, gy = np.arange(0, W, 4, dtype=np.float32), np.arange(0, H, 4, dtype=np.float32)
    coarse = np.stack([np.tile(gx, len(gy)), np.repeat(gy, len(gx))])[None]
    x0 = rng.randint(0, W - 16, S).astype(np.float32)
    y0 = rng.randint(0, H - 16, S).astype(np.float32)
    off = np.arange(16, dtype=np.float32)
    window = np.stack(
        [np.tile(x0[:, None] + off, (1, 16)), np.repeat(y0[:, None] + off, 16, axis=1)], axis=1
    )
    return samples, np.ascontiguousarray(coarse), np.ascontiguousarray(window)


# each CLI run: its arguments, where it ran, its wall seconds and its set-up
# time (`run_cli`); printed at the end beside each phase's seconds
CLI_RUNS = []


def run_cli(args, log_path: str, timeout: float, until=None, own_process: bool = False) -> tuple:
    """Run `python -m <args>` from the checkout's root with its output in
    log_path. Returns (exit code, the log), and appends the run's record to
    CLI_RUNS.

    With `until` (polled every 5 ms; SIGTERM once it returns true) or
    `own_process`, in a process of its own, which never outlives the call;
    its set-up time is from the start of the process to the moment its
    first step's log line appears. Otherwise in this process, through the
    module's `main(argv)` (the card, the built kernels and the host tables
    are already there): stdout and stderr go to the log, an exception is
    written there as a traceback and gives exit code 1, and the working
    directory, the float32-precision flags and the kernels' launch counters
    (which the CLI resets for its own record) are put back afterwards; its
    set-up time is the time of its first step's log line, which the CLI
    stamps from the start of `main`. A test_net run has no step lines: its
    record takes the evaluation loop's seconds (`wall_s` of its
    eval_timing.json), and its set-up time is the rest of its wall time."""
    t0 = time.perf_counter()
    first_step = None
    if until is not None or own_process:
        with open(log_path, "w") as logf:
            proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)
            try:
                while proc.poll() is None and not (until is not None and until()):
                    if first_step is None:
                        with open(log_path) as f:
                            if re.search(r"^\[[\d.]+s\] iter \d+/", f.read(), re.M):
                                first_step = time.perf_counter() - t0
                    time.sleep(0.005)
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=timeout)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        with open(log_path) as f:
            log = f.read()
        where = "own process"
    else:
        import torch

        resident = torch.cuda.memory_allocated() / 2**20
        rc, log = _run_main(args, log_path)
        m = re.search(r"^\[([\d.]+)s\] iter \d+/", log, re.M)
        first_step = float(m.group(1)) if m else None
        where = "in process"
    CLI_RUNS.append({"args": " ".join(a if len(a) < 60 else "..." + a[-40:] for a in args), "where": where,
                     "wall_s": time.perf_counter() - t0, "first_step_s": first_step})
    if where == "in process":
        CLI_RUNS[-1]["resident_mib"] = resident
    timing = os.path.join(args[args.index("--output") + 1], "eval_timing.json") if "--output" in args else ""
    if args[0] == "posecnn_torch.test_net" and rc == 0 and os.path.exists(timing):
        with open(timing) as f:
            CLI_RUNS[-1]["loop_s"] = json.load(f)["wall_s"]
    return rc, log


def _run_main(args, log_path: str) -> tuple:
    """(exit code, log) of `<module>.main(argv)` run in this process."""
    import contextlib
    import gc
    import importlib
    import traceback

    import torch

    from posecnn_torch.ops import conv3x3, nms, voting

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    counts = (voting.VOTE_LAUNCHES, conv3x3.CONV3X3_LAUNCHES, nms.NMS_LAUNCHES)
    cwd = os.getcwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the CLI's record reads the peak since here
    with open(log_path, "w") as logf, contextlib.redirect_stdout(logf), contextlib.redirect_stderr(logf):
        try:
            os.chdir(ROOT)
            rc = importlib.import_module(args[0]).main(list(args[1:]))
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        except Exception:  # noqa: BLE001 - the CLI's failure, as its process would report it
            traceback.print_exc()
            rc = 1
        finally:
            os.chdir(cwd)
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
            voting.VOTE_LAUNCHES, conv3x3.CONV3X3_LAUNCHES, nms.NMS_LAUNCHES = counts
    gc.collect()
    torch.cuda.empty_cache()
    with open(log_path) as f:
        return rc, f.read()


def log_seconds(pattern: str, log: str) -> re.Match:
    """The first line of a CLI log (each line starts with `[<seconds>s] `)
    that matches `pattern` after its time; group 1 is the time."""
    m = re.search(r"^\[([\d.]+)s\] " + pattern, log, re.M)
    check(m is not None, f"no line matching {pattern!r} in the log:\n{log[-3000:]}")
    return m


def launches_of(log: str) -> dict:
    m = log_seconds(r"done at iteration (\d+); launches hough_vote (\d+) conv3x3 (\d+) nms (\d+)", log)
    return {"step": int(m.group(2)), "hough_vote": int(m.group(3)), "conv3x3": int(m.group(4)),
            "nms": int(m.group(5))}


def snapshot_phase(state, model0: dict, work: str, dev) -> tuple:
    """Phase 8: the flagship train state's snapshots (write, restore,
    sizes), then `posecnn_torch.train_net` killed by SIGTERM after its
    step-20 metrics row and resumed to step 30. Returns (the final
    snapshot's path, a light snapshot of the seed-0 weights `model0`, the
    CLI runs' launches)."""
    import torch

    from posecnn_torch.config import FLAGSHIP_SOLVER
    from posecnn_torch.core.checkpoint import restore_checkpoint, save_checkpoint
    from posecnn_torch.core.convert import params_to_numpy
    from posecnn_torch.engine import train as T

    # the phase-7 state (8 steps, a nonzero trace): full and light
    # snapshots written from the card and restored into a zeroed copy
    fresh = T.create_train_state(copy.deepcopy(state.model), T.TrainHParams(clip_grad_norm=10.0))
    rows = []
    for full in (True, False):
        with torch.no_grad():
            for p in fresh.model.parameters():
                p.zero_()
            for tr in fresh.optimizer.trace:
                tr.zero_()
        fresh.step = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(work, "inproc"), state, step=state.step, prefix="full" if full else "light",
                               include_opt_state=full)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        restore_checkpoint(path, fresh)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        check(fresh.step == state.step, "restored step")
        check(all(torch.equal(a, b) for a, b in zip(state.model.parameters(), fresh.model.parameters())),
              "restored parameters differ")
        check(all(torch.equal(a, b) if full else not b.any() for a, b in zip(state.optimizer.trace,
                                                                           fresh.optimizer.trace)), "restored trace")
        rows.append(f"{'full' if full else 'light'} {os.path.getsize(path) / 2**20:.1f} MiB, write {t_write:.3f} s, "
                    f"restore {t_read:.3f} s")
        os.remove(path)
    phase(8, "flagship snapshots from the card, restored bit-equal into a zeroed copy on the card: " + "; ".join(rows))
    # the seed-0 weights as a light snapshot, for phase 9
    fresh.model.load_state_dict(model0)
    fresh.step = 0
    seed0 = save_checkpoint(os.path.join(work, "seed0"), fresh, step=0, prefix="seed0", include_opt_state=False)
    del fresh
    torch.cuda.empty_cache()

    # the train CLI: SIGTERM once train_metrics.csv has its step-20 row
    out = os.path.join(work, "train")
    prefix = FLAGSHIP_SOLVER["snapshot_prefix"]
    csv_path = os.path.join(out, "train_metrics.csv")

    def has_row_20() -> bool:
        try:
            with open(csv_path) as f:
                return any(line.startswith("20,") for line in f)
        except OSError:
            return False

    args = ["posecnn_torch.train_net", "--iters", "30", "--output", out]
    rc, log1 = run_cli(args, os.path.join(work, "train_1.log"), 600, until=has_row_20)
    check(rc == 0, f"train_net exited {rc}:\n{log1[-3000:]}")
    n = int(log_seconds(r"signal received: snapshotting at iteration (\d+)", log1).group(2))
    check(20 <= n < 30, f"the signal snapshot is at step {n}")
    snap = log_seconds(r"snapshot (\S+) \(([\d.]+) MiB, ([\d.]+)s\)", log1)
    path = os.path.join(out, f"{prefix}_iter_{n}.npz")
    check(snap.group(2) == path and os.path.exists(path), f"signal snapshot {snap.group(2)}, want {path}")
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files}
    check(int(arrays["['step']"]) == n and not any(k.startswith("['opt_state']") for k in arrays),
          "the signal snapshot's step, or a trace in a light snapshot")
    fresh = T.create_train_state(copy.deepcopy(state.model), T.TrainHParams(clip_grad_norm=10.0))
    restore_checkpoint(path, fresh)
    back = {f"['params']['{layer}']['{leaf}']": a for layer, leaves in params_to_numpy(fresh.model.state_dict()).items()
            for leaf, a in leaves.items()}
    check(set(back) == {k for k in arrays if k.startswith("['params']")}
          and all(np.array_equal(v, arrays[k]) for k, v in back.items()), "the snapshot does not load back bit-equal")
    del fresh
    l1 = launches_of(log1)
    check(l1 == {"step": n, "hough_vote": 4 * n, "conv3x3": 2 * n, "nms": 0}, f"first run's launches {l1}")
    t_first1 = float(log_seconds(r"iter 1/30 ", log1).group(1))

    # --resume: from the signal snapshot to the final snapshot at 30
    rc, log2 = run_cli(args + ["--resume"], os.path.join(work, "train_2.log"), 600, own_process=True)
    check(rc == 0, f"train_net --resume exited {rc}:\n{log2[-3000:]}")
    res = log_seconds(r"resumed from (\S+) at iteration (\d+) \(([\d.]+)s\)", log2)
    check(res.group(2) == path and int(res.group(3)) == n, f"resumed from {res.group(2)} at {res.group(3)}")
    first = log_seconds(rf"iter {n + 1}/30 ", log2)
    final = os.path.join(out, f"{prefix}_iter_30.npz")
    with np.load(final) as d:
        check(int(d["['step']"]) == 30, "the final snapshot's step")
    l2 = launches_of(log2)
    check(l2 == {"step": 30, "hough_vote": 4 * (30 - n), "conv3x3": 2 * (30 - n), "nms": 0},
          f"resumed run's launches {l2}")
    snaps = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
    phase(8, f"train_net --iters 30: SIGTERM after the step-20 row, snapshot at step {n} ({snap.group(3)} MiB light, "
             f"written in {snap.group(4)} s; first step {t_first1:.3f} s after the start), loaded back bit-equal; "
             f"--resume restored it in {res.group(4)} s ({res.group(1)} s after the start), first step done "
             f"{float(first.group(1)) - float(res.group(1)):.3f} s after the restore ({first.group(1)} s after the "
             f"start), ended with the final snapshot at 30; snapshots {snaps}; launches {l1} then {l2}")
    return final, seed0, {k: l1[k] + l2[k] for k in ("hough_vote", "conv3x3", "nms")}


def run_test_net(ckpt: str, out: str, log_path: str) -> tuple:
    """`python -m posecnn_torch.test_net --model ckpt --max_frames 32` with
    its checks: the three files, 32 frames, finite detections, the launches
    (hough_vote 2 and conv3x3 1 a frame). Returns (summary, timing,
    detections)."""
    rc, log = run_cli(["posecnn_torch.test_net", "--model", ckpt, "--max_frames", "32", "--output", out], log_path,
                      900)
    check(rc == 0, f"test_net exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(out, "eval_summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(out, "eval_timing.json")) as f:
        timing = json.load(f)
    with np.load(os.path.join(out, "detections.npz")) as d:
        dets = {k: d[k] for k in d.files}
    check(timing["frames"] == 32 and timing["launches"] == {"hough_vote": 64, "conv3x3": 32, "nms": 0},
          f"test_net: {timing['frames']} frames, launches {timing['launches']}")
    check(all(np.isfinite(v).all() and v.ndim == 2 and v.shape[1] == 7 for v in dets.values()), "detections")
    check(0 <= summary["mean_iou"] <= 1 and 0 <= summary["adds_auc"] <= 1, f"summary {sorted(summary)}")
    n_dets = sum(len(v) for k, v in dets.items() if k.endswith("_rois"))
    phase(9, f"test_net --model {ckpt.rsplit('/', 1)[-1]} --max_frames 32: {timing['wall_s']:.3f} s, {n_dets} "
             f"detections, {sum(k.endswith('_poses_icp') for k in dets)} frames refined by ICP, launches "
             f"{timing['launches']}; adds_auc {summary['adds_auc']:.4f}, adds_auc_icp "
             f"{summary.get('adds_auc_icp', float('nan')):.4f}, mean_iou {summary['mean_iou']:.4f}")
    return summary, timing, dets


def eval_phase(final: str, seed0: str, work: str, dev) -> dict:
    """Phase 9: `posecnn_torch.test_net` on the train CLI's final snapshot
    and on the seed-0 weights (32 frames, ICP on; 30 steps from random
    weights label every pixel background, so only the seed-0 weights give
    the ICP detections), the eval golden on the card, the ICP on the card
    against the CPU at the flagship shapes, and N_EVAL_CPU_FRAMES of the
    frames against the CPU port. Returns the seed-0 run's launches."""
    import torch

    from posecnn_torch.config import FLAGSHIP_TEST, PIXEL_MEANS, flagship_eval_cfg
    from posecnn_torch.core.convert import make_model
    from posecnn_torch.data.lov_syn import LovSynVal
    from posecnn_torch.engine import test as PT
    from posecnn_torch.utils.meta import build_meta_data
    from tests.torch_parity import check_evaluator_golden, check_icp, flagship_icp_scene, icp_on_eval_golden, t

    run_test_net(final, os.path.join(work, "eval_final"), os.path.join(work, "eval_final.log"))
    summary, timing, dets = run_test_net(seed0, os.path.join(work, "eval"), os.path.join(work, "eval.log"))
    launches = timing["launches"]
    check(sum(k.endswith("_poses_icp") for k in dets) > 0 and "adds_auc_icp" in summary, "no ICP ran")
    ms = {k: statistics.median(v[2:]) for k, v in timing["ms"].items()}
    phase(9, f"seed-0 weights, ICP at plane weight {timing['icp_plane_weight']}, NMS {timing['nms_threshold']}: per "
             f"frame (median of frames 3-32) " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
             + " (random weights, stand-in models)")
    print("eval per-frame ms " + json.dumps({k: [round(x, 3) for x in v] for k, v in timing["ms"].items()}), flush=True)

    # the eval golden: ICP on the card, and the evaluator on fixed detections
    err = icp_on_eval_golden(dev)
    ev_err = check_evaluator_golden()
    # the ICP at the flagship shapes on the card against the CPU port
    s = flagship_icp_scene()
    e2 = {}
    for w in (0.0, 1.0):
        a = (s["rois"], s["poses"], s["depth"], s["label"])
        e2[f"plane {w:g}"] = check_icp(*PT.refine_poses(*a, t(s["points_all"]).to(dev), s["meta"], plane_weight=w),
                                       *PT.refine_poses(*a, t(s["points_all"]), s["meta"], plane_weight=w))
    phase(9, f"the eval golden on the card: ICP {err} (limits t 2e-4 m, q 5e-3), evaluator summary within "
             f"{ev_err:.3g} relative (limit 1e-6); ICP at "
             f"640x480 (6 cubes, 13 detections in 32 rows) on the card against the CPU port: {e2}")

    # N_EVAL_CPU_FRAMES of the frames through the port on the CPU, the same
    # snapshot: the card's label maps here, the CPU's on the CPU thread
    cfg = flagship_eval_cfg()
    with np.load(seed0) as d:
        weights = {k: d[k] for k in d.files if not k.startswith("['opt_state']")}
    data = LovSynVal()
    model = make_model(cfg, weights, dev)
    infer = PT.make_inference_fn(cfg, PIXEL_MEANS, dev)
    inputs, card_labels = [], []
    for i in range(N_EVAL_CPU_FRAMES):
        f = data.load_frame(i)
        inputs.append((f.color[None], build_meta_data(f.intrinsic_matrix)[None], torch.from_numpy(data._extents)))
        raw, meta, ext = inputs[-1]
        card_labels.append(infer(model, t(raw).to(dev), t(meta).to(dev), ext.to(dev))["label_2d"].cpu())
    del model
    defer(9, f"{N_EVAL_CPU_FRAMES} eval frames on the CPU port",
          functools.partial(_eval_on_cpu, cfg, weights, data, inputs, card_labels, dets))
    return launches


def _eval_on_cpu(cfg, weights, data, inputs, card_labels, dets) -> None:
    """Phase 9's CPU side: test_net of the seed-0 weights on the CPU port
    over the first frames, held to the card's detections and label maps."""
    from posecnn_torch.config import FLAGSHIP_TEST, PIXEL_MEANS
    from posecnn_torch.core.convert import make_model
    from posecnn_torch.engine import test as PT
    from tests.torch_parity import t

    t0 = time.perf_counter()
    model_cpu = make_model(cfg, weights, "cpu")
    cpu = PT.test_net(model_cpu, cfg, data, PIXEL_MEANS, max_frames=N_EVAL_CPU_FRAMES, log=None, **FLAGSHIP_TEST)
    infer_cpu = PT.make_inference_fn(cfg, PIXEL_MEANS, "cpu")
    agree, box_err, vote_err, icp_t, icp_q, matched, plateau = [], 0.0, 0.0, 0.0, 0.0, 0, []
    for i, r in enumerate(cpu):
        raw, meta, ext = inputs[i]
        agree.append(float((card_labels[i] == infer_cpu(model_cpu, t(raw), t(meta), ext)["label_2d"]).double().mean()))
        rois = dets.get(f"{i:06d}_rois", np.zeros((0, 7), np.float32))
        check(rois.shape == r["rois"].shape and np.array_equal(rois[:, :2], r["rois"][:, :2]),
              f"frame {i}: the card's rois {rois[:, :2].tolist()} against the CPU's {r['rois'][:, :2].tolist()}")
        if not len(rois):
            continue
        box = np.abs(rois[:, 2:6] - r["rois"][:, 2:6]).max(axis=1)
        votes = np.abs(rois[:, 6] - r["rois"][:, 6])
        vote_err = max(vote_err, float(votes.max()))
        same = box <= 4.0
        # a box further off must have the same votes: the centre moved along
        # a plateau of equal vote counts, which the few flipped labels of
        # bf16 rounding (a changed sample set) can do with random weights
        check(bool(((box <= 4.0) | (votes == 0)).all()), f"frame {i}: boxes {box} px apart with votes {votes} apart")
        plateau += [float(b) for b in box[~same]]
        box_err = max(box_err, float(box[same].max(initial=0.0)))
        icp = dets[f"{i:06d}_poses_icp"]
        matched += int(same.sum())
        q, qr = icp[same, :4], r["poses_icp"][same, :4]
        icp_t = max(icp_t, float(np.abs(icp[same, 4:] - r["poses_icp"][same, 4:]).max(initial=0.0)))
        icp_q = max(icp_q, float((1 - np.abs((q * qr).sum(axis=1) / np.linalg.norm(q, axis=1)
                                            / np.linalg.norm(qr, axis=1))).max(initial=0.0)))
    check(min(agree) >= 0.999 and box_err <= 4.0 and vote_err <= 2.0,
          f"card against CPU: label agreement {agree}, roi box max|err| {box_err} px, votes {vote_err}")
    check(matched > 0 and icp_t <= EVAL_ICP_T and icp_q <= EVAL_ICP_Q,
          f"card against CPU: {matched} matched detections, poses_icp translation max|err| {icp_t} m (limit "
          f"{EVAL_ICP_T}), 1 - |cos| of the quaternions {icp_q} (limit {EVAL_ICP_Q})")
    phase(9, f"{N_EVAL_CPU_FRAMES} frames of the seed-0 snapshot on the CPU port ({time.perf_counter() - t0:.1f} s "
             f"on the CPU thread): label_2d "
             f"agreement min {min(agree):.6f} (limit 0.999), classes equal, roi box max|err| {box_err:.3g} px (limit 4; "
             f"boxes moved {plateau} px on equal votes), votes max|err| {vote_err:.3g} (limit 2); poses_icp of the "
             f"{matched} detections whose boxes match: "
             f"translation max|err| {icp_t:.3g} m (limit {EVAL_ICP_T}), 1 - |cos| {icp_q:.3g} (limit {EVAL_ICP_Q})")


def toy_phase(work: str, dev) -> dict:
    """Phase 10: the cfg-driven path on the toy dataset
    (experiments/cfgs/toy_pose.yml). `python -m posecnn_torch.train_net
    --cfg toy_pose.yml --imdb toy_train --iters TOY_STEPS` (every loss of its metrics rows finite, hough_vote 4 and
    conv3x3 2 launches a step); the host-fed step on the card against the
    CPU port on step 1 (the same first batch of GtSynthesizeLayer(seed=3),
    weights and replayed draws; phase 7's limits on the losses and the
    gradient norm, conv1's weight gradients within two bf16-f32 gaps); the
    step fed by the
    prefetch thread and by a list of batches made beforehand; then
    `python -m posecnn_torch.test_net --cfg toy_pose.yml --imdb toy_val
    --model <the last snapshot>` (hough_vote 2 and conv3x3 1 launches a
    frame). Returns the CLI runs' launches."""
    import torch

    from posecnn_torch.core import config as C
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.data.layer import GtSynthesizeLayer, prefetch
    from posecnn_torch.data.minibatch import rescale_points
    from posecnn_torch.engine import train as T
    from posecnn_torch.ops import conv3x3, voting

    cfg_file = os.path.join("experiments", "cfgs", "toy_pose.yml")
    out = os.path.join(work, "toy")
    rc, log = run_cli(["posecnn_torch.train_net", "--cfg", cfg_file, "--imdb", "toy_train", "--iters",
                       str(TOY_STEPS), "--output", out], os.path.join(work, "toy_train.log"), 600)
    check(rc == 0, f"train_net --cfg exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(out, "train_timing.json")) as f:
        timing = json.load(f)
    launches = {"train": timing["launches"]}
    check(timing["launches"] == {"hough_vote": 4 * TOY_STEPS, "conv3x3": 2 * TOY_STEPS, "nms": 0},
          f"train_net --cfg launches {timing['launches']}")
    ms = {k: statistics.median(v[TOY_WARMUP:]) for k, v in timing["ms"].items()}
    with open(os.path.join(out, "train_metrics.csv")) as f:
        rows = [r.split(",") for r in f.read().splitlines()]
    head, rows = rows[0], [dict(zip(rows[0], map(float, r))) for r in rows[1:]]
    loss_keys = [k for k in head if k.startswith("loss")]
    check(len(rows) == TOY_STEPS // 2 and all(np.isfinite(r[k]) for r in rows for k in loss_keys),
          f"train_metrics.csv: {len(rows)} rows, losses not all finite")
    snap = os.path.join(out, f"caffenet_fast_rcnn_iter_{TOY_STEPS}.npz")
    check(os.path.exists(snap), f"no snapshot {snap}")
    fmt = lambda r: ", ".join(f"{k} {r[k]:.6g}" for k in loss_keys)  # noqa: E731
    phase(10, f"train_net --cfg toy_pose.yml --imdb toy_train --iters {TOY_STEPS} (B=2, 96x128, bf16 trunk): "
              f"per step (median of steps {TOY_WARMUP + 1}-{TOY_STEPS}) {ms['step_stream']:.3f} ms stream (CUDA "
              f"events around the step), {ms['step']:.3f} ms host, data thread wait {ms['data_wait']:.3f} ms; "
              f"first row (step {int(rows[0]['step'])}): {fmt(rows[0])}; last row (step {int(rows[-1]['step'])}): "
              f"{fmt(rows[-1])}; launches {timing['launches']}")
    print("toy train per-step ms " + json.dumps({k: [round(x, 3) for x in v] for k, v in timing["ms"].items()}),
          flush=True)

    # the host-fed step on the card against the CPU port, step 1
    t0 = time.perf_counter()
    cfg = C.cfg_from_file(os.path.join(ROOT, cfg_file))
    imdb = get_imdb("toy_train")
    imdb.append_flipped_images()
    model_cfg, hp, mcfg = C.train_model_cfg(cfg, 4), C.train_hparams(cfg), C.minibatch_cfg(cfg, 4)
    ext, sym = np.asarray(imdb._extents, np.float32), np.asarray(imdb._symmetry, np.float32)
    consts = [torch.from_numpy(a) for a in (rescale_points(imdb._points_all, ext, sym, mcfg.is_symmetric), sym, ext)]
    layer = GtSynthesizeLayer(imdb, mcfg, ims_per_batch=cfg.TRAIN.IMS_PER_BATCH, seed=cfg.RNG_SEED)
    batch = layer.forward()
    weights = init_params_numpy(cfg.RNG_SEED, model_cfg)
    state = T.create_train_state(make_model(model_cfg, weights, dev), hp)
    step = T.make_train_step(model_cfg, hp, *(c.to(dev) for c in consts))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.RNG_SEED)
    draws = T.Draws(gen, record=True)
    got = {k: float(v) for k, v in step(state, T.to_device(batch, dev), draws).items()}
    grads = {k: p.grad.detach().float().cpu() for k, p in state.model.named_parameters() if p.grad is not None}
    recorded = {k: v.cpu() for k, v in draws.recorded.items()}
    seed = cfg.RNG_SEED

    def step_on_cpu(model_cfg=model_cfg, weights=weights, hp=hp, batch=batch, consts=consts, recorded=recorded,
                    got=got, grads=grads, seed=seed):
        t0 = time.perf_counter()
        state_cpu = T.create_train_state(make_model(model_cfg, weights, "cpu"), hp)
        replay = T.Draws(replay=recorded)
        loss, ref = T.compute_losses(state_cpu.model, model_cfg, hp, T.to_device(batch, "cpu"), *consts, replay)
        ref = {k: float(v.detach()) for k, v in ref.items()}
        ref["grad_norm"] = float(T.train_update(state_cpu, loss, T.lr_schedule(hp)(0)))
        rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in TRAIN_LOSS_LIMITS}
        cpu_grads = {k: p.grad.float() for k, p in state_cpu.model.named_parameters()}
        grad_rel = {k: float((grads[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                    for k, g in cpu_grads.items()}
        # the first layers' gradients on frames of flat colour are small
        # residuals of cancelling sums, so they are held to the bf16 rounding
        # of the step itself: the same step on the CPU in float32 gives the gap
        # of the CPU's bf16 gradient, and two bf16 runs may part by two gaps
        # (the triangle inequality through the float32 gradient)
        cfg32 = dataclasses.replace(model_cfg, compute_dtype=torch.float32)
        state_f32 = T.create_train_state(make_model(cfg32, weights, "cpu"), hp)
        loss32, _ = T.compute_losses(state_f32.model, cfg32, hp, T.to_device(batch, "cpu"), *consts,
                                     T.Draws(replay=replay.replay))
        T.train_update(state_f32, loss32, T.lr_schedule(hp)(0))
        gap = {k: float((cpu_grads[k] - p.grad.float()).abs().max()) for k, p in state_f32.model.named_parameters()}
        err = {k: float((grads[k] - cpu_grads[k]).abs().max()) for k in TRAIN_GRAD_LIMITS}
        check(all(rel[k] <= lim for k, lim in TRAIN_LOSS_LIMITS.items()) and all(err[k] <= 2 * gap[k] for k in err),
              f"toy step 1, card against CPU: relative errors {rel}, limits {TRAIN_LOSS_LIMITS}; gradients "
              + ", ".join(f"{k} max|err| {err[k]:.3g} ({grad_rel[k]:.3g} of its largest magnitude), limit 2 x the "
                          f"bf16-f32 gap {gap[k]:.3g}" for k in err))
        phase(10, f"the host-fed step on the card against the CPU port on step 1 ({time.perf_counter() - t0:.1f} s "
                  f"on the CPU thread; the first batch of GtSynthesizeLayer(seed={seed}), replayed draws): "
                  + "; ".join(f"{k} {got[k]:.6g} vs {ref[k]:.6g}, rel {rel[k]:.3g} (limit {TRAIN_LOSS_LIMITS[k]})"
                              for k in TRAIN_LOSS_LIMITS)
                  + "; " + "; ".join(f"{k} gradient max|err| {err[k]:.3g}, {grad_rel[k]:.3g} of its largest "
                                     f"magnitude (phase 7's limit {TRAIN_GRAD_LIMITS[k]}), "
                                     f"{err[k] / max(gap[k], 1e-30):.3g} of the CPU's bf16-f32 gap (limit 2)"
                                     for k in err)
                  + f"; loss_pose {got['loss_pose']:.6g} vs {ref['loss_pose']:.6g} (not held)")

    defer(10, "the toy step on the CPU port", step_on_cpu)

    # the step fed by the prefetch thread, and by batches made beforehand
    feeds = {}
    for name in ("prefetch thread", "batches made beforehand"):
        src = GtSynthesizeLayer(imdb, mcfg, ims_per_batch=cfg.TRAIN.IMS_PER_BATCH, seed=cfg.RNG_SEED)
        if name == "prefetch thread":
            data_iter = prefetch(iter(src), depth=cfg.TPU.PREFETCH)
        else:
            data_iter = iter([src.forward() for _ in range(TOY_FEED_STEPS)])
        timings = {}
        v0, c0 = voting.VOTE_LAUNCHES, conv3x3.CONV3X3_LAUNCHES
        start = state.step
        T.Solver(step, display=10**9).train(data_iter, state, start + TOY_FEED_STEPS, log=None, start_iter=start,
                                            handle_signals=False, timings=timings)
        if hasattr(data_iter, "close"):
            data_iter.close()
        n = (voting.VOTE_LAUNCHES - v0, conv3x3.CONV3X3_LAUNCHES - c0)
        check(n == (4 * TOY_FEED_STEPS, 2 * TOY_FEED_STEPS), f"{name}: launches {n}")
        feeds[name] = {k: statistics.median(v[TOY_WARMUP:]) for k, v in timings.items()}
    phase(10, f"{TOY_FEED_STEPS} host-fed steps in this process, medians after {TOY_WARMUP}: "
              + "; ".join(f"{name}: {m['step_stream']:.3f} ms stream, {m['step']:.3f} ms host, data wait "
                          f"{m['data_wait']:.3f} ms" for name, m in feeds.items()))
    del state, step
    torch.cuda.empty_cache()

    # the eval CLI on the last snapshot
    ev = os.path.join(work, "toy_eval")
    rc, log = run_cli(["posecnn_torch.test_net", "--cfg", cfg_file, "--imdb", "toy_val", "--model", snap,
                       "--output", ev], os.path.join(work, "toy_eval.log"), 600)
    check(rc == 0, f"test_net --cfg exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(ev, "eval_summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(ev, "eval_timing.json")) as f:
        timing = json.load(f)
    with np.load(os.path.join(ev, "detections.npz")) as d:
        dets = {k: d[k] for k in d.files}
    n = timing["frames"]
    check(n == 64 and timing["launches"] == {"hough_vote": 2 * n, "conv3x3": n, "nms": 0},
          f"test_net --cfg: {n} frames, launches {timing['launches']}")
    check(all(np.isfinite(v).all() and v.ndim == 2 and v.shape[1] == 7 for v in dets.values()), "toy detections")
    check(0 <= summary["mean_iou"] <= 1 and 0 <= summary["adds_auc"] <= 1 and not timing["pose_refine"],
          f"toy summary {summary}")
    launches["eval"] = timing["launches"]
    ms = {k: statistics.median(v[2:]) for k, v in timing["ms"].items()}
    phase(10, f"test_net --cfg toy_pose.yml --imdb toy_val --model {os.path.basename(snap)}: {n} frames in "
              f"{timing['wall_s']:.3f} s, {sum(len(v) for k, v in dets.items() if k.endswith('_rois'))} detections, "
              f"launches {timing['launches']}; seg IoU {json.dumps(summary['seg_iou'])}, mean {summary['mean_iou']:.4f}; "
              f"ADD(-S) AUC {summary['adds_auc']:.4f} (per class, ADD-S for {imdb.classes[-1]}: "
              f"{json.dumps(summary['adds_auc_per_class'])}); per frame (median of frames 3-{n}) "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    return launches


def refresh_phase(work: str, dev) -> dict:
    """Phase 11: the bank refresh on the flagship data (lov_syn_val_v4's
    stand-in hulls at 640x480). (a) The port's renders of the render
    golden's scenes against the JAX renders (`check_render_golden`: labels
    on >= 0.999 of the pixels, depth within 1e-5 relative and colour
    within 2 levels where they agree), and render_scene alone on this host
    (ms a frame, render passes and objects a frame). (b) `python -m
    posecnn_torch.train_net --cfg lov_syn_thr_00.yml --imdb lov_syn_val_v4`
    (the capstone with throttle 0), sent SIGTERM once its log shows the
    fourth splice (REFRESH_MAX_STEPS steps at most): at least two splice
    log lines, the counter sidecar at >= 128, finite losses, both kernels
    launched, and the refresh's record. (c) The flagship step of
    `entry.train_entry` in this process, blocks of REFRESH_BLOCK steps
    from the bank as it is (A), and through `refreshing_bank_iter` with a
    refresher of its own rendering at full rate (B, lov_syn_thr_00's
    throttle 0) or sleeping 0.3 s after each frame (C, the capstone's), in
    the order A B C C B A: the median step stream ms (CUDA events) and
    data wait of each arm, the splices and their ms, and the refreshers'
    frames a second. Returns the launches of (b) and (c)."""
    import itertools
    import platform

    import scipy
    import torch

    from posecnn_torch.data.bank_refresh import REFRESH_SEED0, BankRefresher, refresh_synthesizer, \
        refreshing_bank_iter
    from posecnn_torch.data.lov_syn import LovSynVal
    from posecnn_torch.engine import train as T
    from posecnn_torch.entry import train_entry
    from posecnn_torch.ops import conv3x3, voting
    from tests.torch_parity import (RENDER_COLOR_LEVELS, RENDER_DEPTH_REL, RENDER_LABEL_AGREE, check_render_golden,
                                    goldens, load_npz, port_renders)

    # (a) the renders against the JAX golden, and the renderer alone
    t0 = time.perf_counter()
    err = check_render_golden(port_renders(), load_npz(goldens().RENDER_GOLDEN))
    phase(11, f"renders of the JAX golden's scenes on this host ({platform.machine()}, numpy {np.__version__}, "
              f"scipy {scipy.__version__}; {time.perf_counter() - t0:.1f} s): "
              + "; ".join(f"{k} labels agree {a:.6f}, depth max rel err {d:.3g}, colour max err {c}"
                          for k, (a, d, c) in err.items())
              + f" (limits >= {RENDER_LABEL_AGREE}, {RENDER_DEPTH_REL}, {RENDER_COLOR_LEVELS} levels)")
    synth = refresh_synthesizer(LovSynVal())
    orig, passes, n_obj, n_pass = synth._render_objects, [], [], []
    synth._render_objects = lambda *a: passes.append(1) or orig(*a)
    t0 = time.perf_counter()
    for i in range(REFRESH_RENDERS):
        k = len(passes)
        n_obj.append(len(synth.render_scene(np.random.RandomState(REFRESH_SEED0 + i)).cls_indexes))
        n_pass.append(len(passes) - k)
    alone_ms = (time.perf_counter() - t0) * 1e3 / REFRESH_RENDERS
    del synth._render_objects
    phase(11, f"render_scene alone, lov_syn_val_v4's render params (640x480, 5 objects, 800-pixel gate), seeds "
              f"REFRESH_SEED0 + 0..{REFRESH_RENDERS - 1}: {alone_ms:.2f} ms a frame ({1e3 / alone_ms:.1f} frames/s); "
              f"render passes a frame mean {np.mean(n_pass):.2f}, max {max(n_pass)} (6: five tries and the "
              f"fall-through, {sum(p == 6 for p in n_pass)} frames); objects a frame mean {np.mean(n_obj):.2f}, "
              f"min {min(n_obj)}")

    # (b) the CLI on the shipped measurement arm, until its fourth splice
    out = os.path.join(work, "refresh")
    log_path = os.path.join(work, "refresh_train.log")

    def fourth_splice() -> bool:
        with open(log_path) as f:
            return "spliced (4 chunks)" in f.read()

    rc, log = run_cli(["posecnn_torch.train_net", "--cfg", os.path.join("experiments", "cfgs", "lov_syn_thr_00.yml"),
                       "--imdb", "lov_syn_val_v4", "--iters", str(REFRESH_MAX_STEPS), "--output", out],
                      log_path, 900, until=fourth_splice)
    check(rc == 0, f"train_net --cfg lov_syn_thr_00.yml exited {rc}:\n{log[-3000:]}")
    splices = re.findall(r"^\[([\d.]+)s\] bank refresh: (\d+) fresh frames spliced \((\d+) chunks\)", log, re.M)
    start = log_seconds(r"bank refresh: streaming fresh scenes in chunks of (\d+) \(seed offset (\d+)\)", log)
    with open(os.path.join(out, "bank_refresh_counter.txt")) as f:
        counter = int(f.read())
    with open(os.path.join(out, "train_timing.json")) as f:
        timing = json.load(f)
    rec = timing["bank_refresh"]
    rows = re.findall(r"^\[[\d.]+s\] iter (\d+)/\d+ (.*) \([\d.]+s/it\)$", log, re.M)
    losses = [float(v) for _, r in rows for k, v in re.findall(r"(\S+): (\S+)", r) if k.startswith("loss")]
    check(len(splices) >= 2 and counter >= 128 and rows and all(np.isfinite(losses))
          and timing["launches"]["hough_vote"] > 0 and timing["launches"]["conv3x3"] > 0
          and timing["launches"]["nms"] == 0,
          f"refresh CLI: {len(splices)} splice lines, counter {counter}, {len(rows)} log rows, losses {losses}, "
          f"launches {timing['launches']}:\n{log[-3000:]}")
    n = timing["end_step"]
    ms = {k: statistics.median(v[2:]) for k, v in timing["ms"].items()}
    phase(11, f"train_net --cfg lov_syn_thr_00.yml --imdb lov_syn_val_v4 (B=2, 640x480, bf16, chunks of "
              f"{start.group(2)}, seed offset {start.group(3)}, refresher started {start.group(1)} s after the "
              f"start), SIGTERM after the fourth splice: splices at "
              + ", ".join(f"{t} s ({c} chunks, {fr} frames)" for t, fr, c in splices)
              + f"; {n} steps, per step (median of steps 3-{n}) {ms['step_stream']:.3f} ms stream, "
              f"{ms['data_wait']:.3f} ms data wait; the refresher rendered {rec['frames_rendered']} frames at "
              f"{rec['frames_per_s']:.2f} frames/s of its render time ({rec['render_s']:.2f} s), "
              f"{rec['chunks_spliced']} chunks spliced in {', '.join(f'{x:.2f}' for x in rec['splice_ms'])} ms; "
              f"counter sidecar {counter}; losses finite; launches {timing['launches']}")

    # (c) the flagship step without the refresh (A), with it at full rate
    # (B) and throttled as the capstone (C), A B C C B A
    from posecnn_torch.core.config import cfg_from_file

    capstone_throttle = cfg_from_file(os.path.join(ROOT, "experiments", "cfgs",
                                                   "lov_syn_capstone.yml")).TPU.BANK_REFRESH_THROTTLE
    t0 = time.perf_counter()
    step, state, bank = train_entry(dev)
    solver = T.Solver(step, display=10**9)
    load_s = time.perf_counter() - t0

    def block(it) -> dict:
        timings = {}
        _, m = solver.train(it, state, state.step + REFRESH_BLOCK, log=None, start_iter=state.step,
                            handle_signals=False, timings=timings)
        check(all(np.isfinite(float(v)) for v in m.values()), f"losses not finite: {m}")
        return timings

    def refreshed_block(throttle: float) -> tuple:
        r = BankRefresher(synth, g_max=bank["gt_centers"].shape[1], chunk_size=64,
                          seed_offset=REFRESH_RENDERS + 10**6 * len(runs), throttle_sec=throttle)
        stats = {}
        r.start()
        t = time.perf_counter()
        try:
            timings = block(refreshing_bank_iter(bank, r, stats=stats))
        finally:
            r.stop()
            r.join(timeout=60)
        check(not r.is_alive(), "the refresher outlived its block")
        return timings, stats.get("splice_ms", []), r.frames_rendered, r.render_s, time.perf_counter() - t

    runs = []
    block(itertools.repeat(bank))  # warm-up
    voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = 0
    for arm in "ABCCBA":
        if arm == "A":
            runs.append(("A", block(itertools.repeat(bank)), [], 0, 0.0, 0.0))
        else:
            runs.append((arm, *refreshed_block(0.0 if arm == "B" else capstone_throttle)))
    launches = {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES}
    n_steps = len(runs) * REFRESH_BLOCK
    check(launches == {"hough_vote": 4 * n_steps, "conv3x3": 2 * n_steps},
          f"A/B/C launches {launches}, want 4 and 2 a step")
    arms = {}
    for arm in "ABC":
        rs = [r for r in runs if r[0] == arm]
        frames, render_s, wall = (sum(r[i] for r in rs) for i in (3, 4, 5))
        blocks = ", ".join(f"{statistics.median(r[1]['step_stream']):.3f}" for r in rs)
        arms[arm] = (f"{arm}: step stream {statistics.median([x for r in rs for x in r[1]['step_stream']]):.3f} ms "
                     f"(blocks {blocks}), data wait {statistics.median([x for r in rs for x in r[1]['data_wait']]):.3f} "
                     f"ms")
        if arm != "A":
            splice_ms = [x for r in rs for x in r[2]]
            arms[arm] += (f", {len(splice_ms)} splices" + (f" ({', '.join(f'{x:.2f}' for x in splice_ms)} ms)"
                                                            if splice_ms else "") + ", "
                          f"{frames} frames rendered in {wall:.1f} s ({frames / wall:.2f} frames/s of wall, "
                          f"{frames / max(render_s, 1e-9):.2f} of render time)")
    phase(11, f"flagship step (train_entry, loaded in {load_s:.1f} s), {REFRESH_BLOCK}-step blocks A B C C B A (A: "
              f"the bank as it is; B: refreshing_bank_iter, chunks of 64, no throttle; C: the same with the "
              f"capstone's {capstone_throttle} s throttle): " + "; ".join(arms.values()) + f"; launches {launches}")
    del step, state, bank, solver
    torch.cuda.empty_cache()
    return {"cli": timing["launches"], "ab": launches}


def _first_losses(log: str, n: int) -> dict:
    """The loss terms of a train_net log's line for iteration 1 of n."""
    m = log_seconds(rf"iter 1/{n} (.*) \(", log)
    vals = dict(re.findall(r"(\w+): ([-\d.e+na]+)", m.group(2)))
    return {k: float(v) for k, v in vals.items() if k.startswith("loss")}


def _host_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def input_modes_phase(work: str, dev) -> dict:
    """Phase 12: the depth inputs and FCN-8s. (a) The host image functions
    on this host against the JAX golden (tests/golden/torch_port_input_modes.npz:
    HLS, the jitter, the depth image, the normals bit-equal, the bilateral
    filter at its limits), and each timed on a 640x480 frame, beside the
    jitter converted without the tables and the filter built without its
    FMA dispatch (each held equal to the port's). (b) One
    full-width RGBD PoseCNN step with the vertex and pose heads (B=2, the
    first host batch of lov_syn_val_v4 under rgbd_scene_single_rgbd.yml)
    on the card against the CPU port with the same draws, at phase 7's
    limits, both trunks' conv1 gradients held; 4 conv3x3 and 4 hough_vote
    launches. (c) `train_net --cfg rgbd_scene_single_rgbd.yml --imdb
    lov_syn_val_v4 --iters INPUT_STEPS`: stream ms a step, the data
    thread's wait, peak memory, 4 conv3x3 launches a step. (d) `train_net`
    then `test_net --cfg lov_single_depth.yml` (DEPTH, no pose head): 4
    hough_vote and 2 conv3x3 launches a step, 2 and 1 a frame. (e)
    `train_net` then `test_net --cfg rgbd_scene_single_normal_fcn8.yml`
    (NORMAL, FCN-8s): 2 conv3x3 launches a step, 1 a frame, the mean IoU;
    and the FCN-8s forward on the card against the CPU port (bf16 both:
    the labels that differ, and the mean |score error|, within the CPU's
    own bf16-float32 gap: seed weights leave close class scores, so bf16
    rounding in another order flips labels). Returns the launches of each
    path."""
    import torch

    from posecnn_torch import _build
    from posecnn_torch.config import PIXEL_MEANS
    from posecnn_torch.core import config as C
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.data import minibatch as M
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.data.layer import GtSynthesizeLayer
    from posecnn_torch.engine import train as T
    from posecnn_torch.models import fcn8 as F
    from posecnn_torch.native import bilateral_filter
    from posecnn_torch.ops import conv3x3, voting
    from posecnn_torch.utils import blob
    from tests.torch_parity import check_host_images, goldens, load_npz, port_host_images

    t_phase = time.perf_counter()
    launches = {}
    # (a) the host functions against the golden, then timed
    G = goldens()
    g = load_npz(G.INPUT_MODES_GOLDEN)
    t0 = time.perf_counter()
    blob.hls_tables()
    table_s = time.perf_counter() - t0
    errs = [check_host_images(port_host_images(path), g, i) for i, path in enumerate(G.TRAIN_FRAMES)]
    f = M.load_frozen_frame(os.path.join(FRAMES_DIR, "000000.npz"))
    depth_m = f.depth.astype(np.float32) / f.factor_depth
    normal_u8 = np.ascontiguousarray((127.5 * M.normals_np(depth_m, f.intrinsic_matrix) + 127.5)
                                     .astype(np.uint8)[:, :, (2, 1, 0)])
    rng = np.random.RandomState(0)

    class Gaussian:  # the draws of add_noise's Gaussian branch
        def rand(self, n):
            return np.array([0.5])

        def randint(self, n):
            return int(rng.randint(n))

    host = {
        "chromatic_transform": lambda: blob.chromatic_transform(f.color, rng=rng),
        "add_noise Gaussian": lambda: blob.add_noise(f.color, rng=Gaussian()),
        "add_noise blur (uint8)": lambda: blob.add_noise(f.color, rng=rng, force_blur=True),
        "depth_input_image": lambda: M.depth_input_image(f.depth),
        "add_noise Gaussian (depth image)": lambda: blob.add_noise(M.depth_input_image(f.depth), rng=Gaussian()),
        "normals_np": lambda: M.normals_np(depth_m, f.intrinsic_matrix),
        "bilateral_filter": lambda: bilateral_filter(normal_u8, 9, 75, 75),
        "normal_input_image": lambda: M.normal_input_image(f.depth, f.factor_depth, f.intrinsic_matrix),
    }
    # the two designs the port did not take, timed beside its own on the same
    # image and held equal to it: the jitter converted directly, without the
    # tables, and the filter built without its FMA dispatch
    jitter = (3.0, -7.0, 11.0)

    def direct_jitter():
        hls = blob.bgr_to_hls(f.color)
        base = np.arange(256, dtype=np.float64)
        luts = (((base + jitter[0]) % 180).astype(np.uint8), np.clip(base + jitter[1], 0, 255).astype(np.uint8),
                np.clip(base + jitter[2], 0, 255).astype(np.uint8))
        return blob.hls_to_bgr(np.stack([lut[hls[..., c]] for c, lut in enumerate(luts)], axis=-1))

    generic_so = os.path.join(work, "bilateral_no_dispatch.so")
    subprocess.run(["g++", *_build.GXX_FLAGS, "-DBILATERAL_NO_DISPATCH", "-o", generic_so,
                    str(_build.CSRC / "bilateral.cc")], check=True, timeout=300)
    generic = ctypes.CDLL(generic_so).bilateral_filter_u8c3
    generic.argtypes = _build.bilateral_lib().bilateral_filter_u8c3.argtypes

    def generic_filter():
        out = np.empty_like(normal_u8)
        assert generic(normal_u8, out, *normal_u8.shape[:2], 9, 75.0, 75.0) == 0
        return out

    check(np.array_equal(direct_jitter(), blob.chromatic_transform(f.color, d_h=jitter[0], d_l=jitter[1],
                                                                      d_s=jitter[2])),
          "the direct HLS jitter differs from the tables'")
    check(np.array_equal(generic_filter(), bilateral_filter(normal_u8, 9, 75, 75)),
          "the bilateral filter without its FMA dispatch differs from the one with it")
    host["chromatic_transform direct, no tables"] = direct_jitter
    host["bilateral_filter without the FMA dispatch"] = generic_filter
    host_ms = {k: _host_ms(fn, HOST_REPS) for k, fn in host.items()}
    phase(12, f"host images of frames v4/000000-000001 on this host against the JAX golden: HLS, jitter, depth "
              f"image, normals bit-equal; bilateral filter exact on "
              + ", ".join(f"{e['exact']:.6f}" for e in errs)
              + f" of the values, max diff {max(e['max_diff'] for e in errs)} (limits 0.999, 1); HLS tables built "
              f"in {table_s:.2f} s; ms a 640x480 image (median of {HOST_REPS}): "
              + ", ".join(f"{k} {v:.2f}" for k, v in host_ms.items()))

    # (b) one full-width RGBD step with the vertex and pose heads, card against CPU
    cfg_file = os.path.join("experiments", "cfgs", "rgbd_scene_single_rgbd.yml")
    cfg = C.cfg_from_file(os.path.join(ROOT, cfg_file))
    imdb = get_imdb("lov_syn_val_v4")
    n = imdb.num_classes
    model_cfg = dataclasses.replace(C.train_model_cfg(cfg, n), vertex_reg=True, pose_reg=True, use_crop_pool=True)
    hp, mcfg = C.train_hparams(cfg), dataclasses.replace(C.minibatch_cfg(cfg, n), vertex_reg=True)
    t0 = time.perf_counter()
    batch = GtSynthesizeLayer(imdb, mcfg, ims_per_batch=2, seed=cfg.RNG_SEED).forward()
    batch_ms = (time.perf_counter() - t0) * 1e3
    check(batch["data_p"].shape == batch["data"].shape == (2, 480, 640, 3), f"RGBD batch {batch['data'].shape}")
    ext, sym = np.asarray(imdb._extents, np.float32), np.asarray(imdb._symmetry, np.float32)
    consts = [torch.from_numpy(a) for a in (M.rescale_points(imdb._points_all, ext, sym, mcfg.is_symmetric), sym, ext)]
    weights = init_params_numpy(cfg.RNG_SEED, model_cfg)
    state = T.create_train_state(make_model(model_cfg, weights, dev), hp)
    step = T.make_train_step(model_cfg, hp, *(c.to(dev) for c in consts))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.RNG_SEED)
    draws = T.Draws(gen, record=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = 0
    got = {k: float(v) for k, v in step(state, T.to_device(batch, dev), draws).items()}
    launches["rgbd_step"] = {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    check(launches["rgbd_step"] == {"hough_vote": 4, "conv3x3": 4}, f"RGBD step launches {launches['rgbd_step']}")
    check(all(np.isfinite(v) for v in got.values()), f"RGBD step losses {got}")
    grads = {k: p.grad.detach().float().cpu() for k, p in state.model.named_parameters() if p.grad is not None}
    del state, step
    torch.cuda.empty_cache()
    recorded = {k: v.cpu() for k, v in draws.recorded.items()}
    rgbd_launches = launches["rgbd_step"]

    def rgbd_step_on_cpu(model_cfg=model_cfg, weights=weights, hp=hp, batch=batch, consts=consts, recorded=recorded,
                         got=got, grads=grads, batch_ms=batch_ms, rgbd_launches=rgbd_launches, peak=peak):
        t0 = time.perf_counter()
        state_cpu = T.create_train_state(make_model(model_cfg, weights, "cpu"), hp)
        replay = T.Draws(replay=recorded)
        loss, ref = T.compute_losses(state_cpu.model, model_cfg, hp, T.to_device(batch, "cpu"), *consts, replay)
        ref = {k: float(v.detach()) for k, v in ref.items()}
        ref["grad_norm"] = float(T.train_update(state_cpu, loss, T.lr_schedule(hp)(0)))
        rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in TRAIN_LOSS_LIMITS}
        grad_lim = {**TRAIN_GRAD_LIMITS, **{k.replace("trunk.", "trunk_p."): v for k, v in TRAIN_GRAD_LIMITS.items()}}
        grad_rel = {}
        for k, p in state_cpu.model.named_parameters():
            gc = p.grad.float()
            grad_rel[k] = float((grads[k] - gc).abs().max()) / max(float(gc.abs().max()), 1e-30)
        worst = sorted(grad_rel, key=grad_rel.get, reverse=True)[:3]
        check(all(rel[k] <= lim for k, lim in TRAIN_LOSS_LIMITS.items())
              and all(grad_rel[k] <= lim for k, lim in grad_lim.items()),
              f"RGBD step, card against CPU: relative errors {rel}, limits {TRAIN_LOSS_LIMITS}; gradients "
              + ", ".join(f"{k} {grad_rel[k]:.3g}" for k in list(grad_lim) + worst) + f", limits {grad_lim}")
        phase(12, f"RGBD PoseCNN step with the vertex and pose heads (B=2, 640x480, bf16, both trunks; the host batch "
                  f"in {batch_ms:.0f} ms), card against the CPU port ({time.perf_counter() - t0:.1f} s on the CPU "
                  f"thread): "
                  + "; ".join(f"{k} {got[k]:.6g} vs {ref[k]:.6g}, rel {rel[k]:.3g} (limit {TRAIN_LOSS_LIMITS[k]})"
                              for k in TRAIN_LOSS_LIMITS)
                  + "; " + "; ".join(f"{k} gradient {grad_rel[k]:.3g} of its largest magnitude (limit {lim})"
                                     for k, lim in grad_lim.items())
                  + "; worst gradients (not held) " + ", ".join(f"{k} {grad_rel[k]:.3g}" for k in worst)
                  + f"; launches {rgbd_launches}; peak memory {peak / 2**20:.1f} MiB")

    defer(12, "the RGBD step on the CPU port", rgbd_step_on_cpu)

    def train_cli(name: str, cfg_name: str, iters: int, want: dict) -> tuple:
        out = os.path.join(work, name)
        rc, log = run_cli(["posecnn_torch.train_net", "--cfg", os.path.join("experiments", "cfgs", cfg_name),
                           "--imdb", "lov_syn_val_v4", "--iters", str(iters), "--output", out],
                          os.path.join(work, name + ".log"), 600)
        check(rc == 0, f"train_net --cfg {cfg_name} exited {rc}:\n{log[-3000:]}")
        with open(os.path.join(out, "train_timing.json")) as fh:
            timing = json.load(fh)
        check(timing["launches"] == {"nms": 0, **{k: v * iters for k, v in want.items()}},
              f"{cfg_name}: launches {timing['launches']}, want {want} a step")
        first = _first_losses(log, iters)
        check(first and all(np.isfinite(v) for v in first.values()), f"{cfg_name}: first losses {first}")
        ms = {k: statistics.median(v[INPUT_WARMUP:]) for k, v in timing["ms"].items()}
        return out, timing, ms, first

    def test_cli(name: str, cfg_name: str, snap: str, want: dict) -> tuple:
        ev = os.path.join(work, name)
        rc, log = run_cli(["posecnn_torch.test_net", "--cfg", os.path.join("experiments", "cfgs", cfg_name),
                           "--imdb", "lov_syn_val_v4", "--model", snap, "--max_frames", str(INPUT_EVAL_FRAMES),
                           "--output", ev], os.path.join(work, name + ".log"), 600)
        check(rc == 0, f"test_net --cfg {cfg_name} exited {rc}:\n{log[-3000:]}")
        with open(os.path.join(ev, "eval_summary.json")) as fh:
            summary = json.load(fh)
        with open(os.path.join(ev, "eval_timing.json")) as fh:
            timing = json.load(fh)
        nf = timing["frames"]
        check(nf == INPUT_EVAL_FRAMES and timing["launches"] == {"nms": 0, **{k: v * nf for k, v in want.items()}},
              f"test_net --cfg {cfg_name}: {nf} frames, launches {timing['launches']}, want {want} a frame")
        check(0 <= summary["mean_iou"] <= 1, f"{cfg_name}: mean IoU {summary['mean_iou']}")
        return summary, timing, {k: statistics.median(v[INPUT_EVAL_WARMUP:]) for k, v in timing["ms"].items()}

    # (c) the RGBD CLI
    _, timing, ms, first = train_cli("rgbd", "rgbd_scene_single_rgbd.yml", INPUT_STEPS, {"hough_vote": 0, "conv3x3": 4})
    launches["rgbd_train_cli"] = timing["launches"]
    phase(12, f"train_net --cfg rgbd_scene_single_rgbd.yml --imdb lov_syn_val_v4 --iters {INPUT_STEPS} (RGBD dual "
              f"tower, the label head, B=2, 640x480, bf16, host jitter and noise): per step (median of steps "
              f"{INPUT_WARMUP + 1}-{INPUT_STEPS}) {ms['step_stream']:.3f} ms stream, {ms['step']:.3f} ms host, data "
              f"thread wait {ms['data_wait']:.3f} ms; peak memory {timing['peak_memory_mib']:.1f} MiB; first losses "
              f"{first}; launches {timing['launches']}")
    print("rgbd train per-step ms " + json.dumps({k: [round(x, 3) for x in v] for k, v in timing["ms"].items()}),
          flush=True)

    # (d) DEPTH: the vertex head and Hough, no pose head
    out, timing, ms, first = train_cli("depth", "lov_single_depth.yml", INPUT_STEPS,
                                       {"hough_vote": 4, "conv3x3": 2})
    launches["depth_train_cli"] = timing["launches"]
    summary, ev_timing, ev_ms = test_cli("depth_eval", "lov_single_depth.yml",
                                         os.path.join(out, f"vgg16_fcn_depth_single_iter_{INPUT_STEPS}.npz"),
                                         {"hough_vote": 2, "conv3x3": 1})
    launches["depth_eval"] = ev_timing["launches"]
    phase(12, f"train_net --cfg lov_single_depth.yml --iters {INPUT_STEPS} (DEPTH, the vertex head and Hough): "
              f"{ms['step_stream']:.3f} ms stream a step, data wait {ms['data_wait']:.3f} ms, peak "
              f"{timing['peak_memory_mib']:.1f} MiB, first losses {first}, launches {timing['launches']}; test_net "
              f"--cfg on its snapshot ({INPUT_EVAL_FRAMES} colour frames, the COLOR model, no pose head): mean IoU "
              f"{summary['mean_iou']:.4f}, per frame " + ", ".join(f"{k} {v:.3f} ms" for k, v in ev_ms.items())
              + f", launches {ev_timing['launches']}")

    # (e) NORMAL on FCN-8s
    out, timing, ms, first = train_cli("fcn8", "rgbd_scene_single_normal_fcn8.yml", INPUT_STEPS,
                                       {"hough_vote": 0, "conv3x3": 2})
    launches["fcn8_train_cli"] = timing["launches"]
    summary, ev_timing, ev_ms = test_cli("fcn8_eval", "rgbd_scene_single_normal_fcn8.yml",
                                         os.path.join(out, f"fcn8_normal_single_iter_{INPUT_STEPS}.npz"),
                                         {"hough_vote": 0, "conv3x3": 1})
    launches["fcn8_eval"] = ev_timing["launches"]
    phase(12, f"train_net --cfg rgbd_scene_single_normal_fcn8.yml --iters {INPUT_STEPS} (NORMAL, FCN-8s): "
              f"{ms['step_stream']:.3f} ms stream a step, {ms['step']:.3f} ms host, data wait {ms['data_wait']:.3f} "
              f"ms, peak {timing['peak_memory_mib']:.1f} MiB, first losses {first}, launches {timing['launches']}; "
              f"test_net --cfg on its snapshot ({INPUT_EVAL_FRAMES} colour frames): mean IoU "
              f"{summary['mean_iou']:.4f}, per frame " + ", ".join(f"{k} {v:.3f} ms" for k, v in ev_ms.items())
              + f", peak {ev_timing['peak_memory_mib']:.1f} MiB, launches {ev_timing['launches']}")

    # the FCN-8s forward on the card against the CPU port
    params = F.init_fcn8_params_numpy(cfg.RNG_SEED, n)
    data = torch.from_numpy(f.color[None].astype(np.float32)) - torch.tensor(PIXEL_MEANS).reshape(1, 1, 1, 3)
    with torch.inference_mode():
        card = F.fcn8_forward(F.make_fcn8(n, params, dev), data.to(dev), n)
        card = {k: card[k].cpu() for k in ("label_2d", "score")}

    def fcn8_on_cpu(params=params, data=data, card=card, n=n):
        t0 = time.perf_counter()
        with torch.inference_mode():
            model_cpu = F.make_fcn8(n, params, "cpu")
            cpu = F.fcn8_forward(model_cpu, data, n)
            cpu32 = F.fcn8_forward(model_cpu, data, n, compute_dtype=torch.float32)
        agree = float((card["label_2d"] == cpu["label_2d"]).double().mean())
        agree_gap = float((cpu32["label_2d"] == cpu["label_2d"]).double().mean())
        err = float((card["score"] - cpu["score"]).abs().mean())
        gap = float((cpu32["score"] - cpu["score"]).abs().mean())
        check(1 - agree <= 1 - agree_gap and err <= gap,
              f"FCN-8s card against CPU: label agreement {agree} (the CPU's bf16 against f32: {agree_gap}), mean "
              f"|score error| {err}, the CPU's bf16-f32 gap {gap}")
        phase(12, f"FCN-8s forward (bf16, 640x480, seed weights) card against the CPU port "
                  f"({time.perf_counter() - t0:.1f} s on the CPU thread): label_2d agreement {agree:.6f} (limit: the "
                  f"CPU's bf16 against f32, {agree_gap:.6f}), mean |score error| {err:.3g} (limit: the CPU's bf16-f32 "
                  f"gap {gap:.3g})")

    defer(12, "the FCN-8s forward on the CPU port", fcn8_on_cpu)
    phase(12, f"phase 12's card work took {time.perf_counter() - t_phase:.1f} s")
    return launches


def nms_sweep_tests(over: np.ndarray) -> tuple:
    """(keep mask, IoU tests) of a greedy sweep over the suppression matrix
    of sorted boxes: a box not removed when it is reached is kept, and is
    tested against each later box that is still there."""
    n = over.shape[0]
    removed = np.zeros(n, bool)
    tests = 0
    for i in range(n):
        if not removed[i]:
            tests += int(n - 1 - i - removed[i + 1:].sum())
            removed[i + 1:] |= over[i, i + 1:]
    return ~removed, tests


def det_proposals(dev):
    """The NMS kernel's input on the detection path: the 6000 top-scoring
    proposals, sorted by score, of a full-width bf16 VGG16DET forward
    (lov_det.yml, its RNG_SEED weights, test mode) on frame v4/000000."""
    import torch

    from posecnn_torch.core import config as C
    from posecnn_torch.data.lov_syn import LovSynVal
    from posecnn_torch.models import detection as D
    from posecnn_torch.ops.bbox import bbox_transform_inv, clip_boxes

    imdb = LovSynVal()
    det_file = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "lov_det.yml"))
    test_cfg = C.det_model_cfg(det_file, imdb.num_classes, train=False)
    model = D.make_det_model(test_cfg, D.init_vgg16_det_params_numpy(det_file.RNG_SEED, test_cfg), dev)
    frame = imdb.load_frame(0)
    data = torch.from_numpy(frame.color[None]).to(dev).float() - torch.tensor(det_file.PIXEL_MEANS, device=dev)
    with torch.inference_mode():
        out = D.vgg16_det_forward(model, test_cfg, data)
        A = test_cfg.num_anchors
        Hf, Wf = out["rpn_cls_prob"].shape[1:3]
        anchors = D._anchors(Hf, Wf, 16, tuple(test_cfg.anchor_ratios), tuple(test_cfg.anchor_scales), dev)
        props = clip_boxes(bbox_transform_inv(anchors, out["rpn_bbox_pred"][0].reshape(-1, 4)), (480, 640))
        order = torch.sort(out["rpn_cls_prob"][0, :, :, A:].reshape(-1), descending=True, stable=True).indices
        return props[order[:test_cfg.rpn_pre_nms_top_n]].clone()


def nms_times(boxes, dev, threshold: float = 0.7) -> dict:
    """The NMS kernel's time on `boxes` (ms): back to back (`median_ms`),
    with a cold L2 (`cold_ms` over NMS_COLD_CALLS copies of the boxes, each
    call's mask words in a block of their own: an empty tensor of their
    size, kept with the output, takes the block the call has just freed, so
    the next call's words land elsewhere; `cold_mb` is what the round
    passes through), single (`single_ms`), and each of its two kernels'
    device time a call from torch.profiler (`mask_ms`, `sweep_ms`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from posecnn_torch.ops import nms

    n = boxes.shape[0]
    call = functools.partial(nms.nms_keep_sorted, boxes, threshold)
    out = dict(ms=median_ms(call), single_ms=single_ms(call))
    words = nms.mask_words(n)
    copies = [boxes.clone() for _ in range(NMS_COLD_CALLS)]
    out["cold_ms"] = cold_ms(lambda b: (nms.nms_keep_sorted(b, threshold),
                                        torch.empty(words, dtype=torch.int64, device=dev)), copies)
    out["cold_mb"] = NMS_COLD_CALLS * (words * 8 + n * 17) / 1e6
    del copies
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    out["mask_ms"] = out["sweep_ms"] = None  # None: the profiler saw no device time (not measured)
    for e in prof.key_averages():
        for name in ("mask", "sweep"):
            if f"nms_{name}_kernel" in e.key and e.device_time_total > 0:
                out[f"{name}_ms"] = e.device_time_total / e.count / 1e3
    return out


def _cli_losses(log: str, it: int, n: int) -> dict:
    """The loss terms of a train_net log's line for iteration `it` of n."""
    m = log_seconds(rf"iter {it}/{n} (.*) \(", log)
    return {k: float(v) for k, v in re.findall(r"(\w+): ([-\d.e+na]+)", m.group(2)) if k.startswith("loss")}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def det_3d_phase(work: str, dev) -> tuple:
    """Phase 13: the detection network (VGG16DET) and the 3D head
    (VERTEX_REG_3D). (a) The NMS kernel against its plain version on the
    6000 top proposals of a full-width forward (`det_proposals`) and on
    random boxes at sizes around its 64-box blocks and on both routes of
    its sweep, IoUs exactly at the threshold, NaN and infinite coordinates
    among them (keep masks equal), timed back to back, with a cold L2 and
    single, and by kernel (`nms_times`), beside its bound. (b)
    `train_net --cfg lov_det.yml --imdb lov_syn_val_v4 --iters DET_STEPS`:
    finite losses, the snapshot, stream and host ms a step, peak memory,
    2 conv3x3 and 1 nms launches a step. (c) `test_net --cfg lov_det.yml
    --model <that snapshot> --max_frames DET_EVAL_FRAMES`: mAP@0.5, ms a
    frame by stage, 1 conv3x3 and 1 nms launch a frame. (d) One full-width
    det step at float32 (TF32 off), card against the CPU port on the same
    frame, weights and draws (the sampled rois equal, the losses and the
    gradients of the proposal path, fc6 and conv1_2 within
    DET_LOSS_LIMITS, DET_GRAD_LIMITS); the
    proposals of the card's RPN outputs on the card and the CPU; the JAX
    det golden (forward, proposals, RANSAC) on the card. (e) `test_net
    --cfg lov_color_3d.yml --max_frames DET_EVAL_FRAMES`: finite poses, ms
    a frame, RANSAC's device ms; RANSAC on the card against the CPU on a
    well-posed scene with the same draws. (f) One full-width 3D step (B=2,
    bf16) on rendered scenes with their vertmaps, card against CPU at
    phase 7's limits; then `train_net --cfg lov_color_3d.yml` on
    lov_syn_val_v4 fails with the port's Frame.vertmap message. Returns
    (the nms kernel's record, the launches of each path)."""
    import torch

    from posecnn_torch.core import config as C
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.data import minibatch as M
    from posecnn_torch.data.lov_syn import LovSynVal
    from posecnn_torch.engine import test as E
    from posecnn_torch.engine import train as T
    from posecnn_torch.models import detection as D
    from posecnn_torch.ops import conv3x3, nms, voting
    from posecnn_torch.ops.rpn import proposal_layer
    from tests.torch_parity import check_det_golden, det_on_golden, ransac_scene, rendered_3d_frames

    t_phase = time.perf_counter()
    launches = {}
    imdb = LovSynVal()
    n_cls = imdb.num_classes
    det_file = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "lov_det.yml"))
    frame = imdb.load_frame(0)

    def reset():
        voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = nms.NMS_LAUNCHES = 0

    def counts():
        return {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES, "nms": nms.NMS_LAUNCHES}

    # (a) the NMS kernel on the 6000 top proposals of a full-width bf16
    # forward (seed weights, frame v4/000000) and on random boxes
    real = det_proposals(dev)
    rng = np.random.RandomState(0)

    def random_boxes(n):
        xy = rng.randint(0, 560, (n, 2))
        wh = rng.randint(8, 200, (n, 2))
        return torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(np.float32)).to(dev)

    nonfinite = random_boxes(1000)
    nonfinite[3, 0] = nonfinite[5, 1] = nonfinite[13, 2:] = float("nan")
    nonfinite[8, 2] = nonfinite[17, :2] = float("inf")
    nonfinite[11, 1] = -float("inf")
    exact = random_boxes(129)
    exact[:3] = torch.tensor([[0, 0, 9, 9], [0, 0, 9, 6], [0, 0, 9, 2]], dtype=torch.float32)  # IoU 0.7, 0.3
    cases = ([("real proposals", real, 0.7)]
             + [(f"random integer boxes N={n}", random_boxes(n), thr)
                for n, thr in ((NMS_WINDOW_BOXES, 0.7), (12000, 0.5), (6000, 0.7), (4097, 0.3), (1000, 0.5),
                               (128, 0.7), (127, 0.5), (65, 0.3), (64, 0.7), (63, 0.7), (1, 0.7))]
             + [("N=129 with IoUs exactly at 0.7 and 0.3", exact, thr) for thr in (0.7, 0.3)]
             + [("random integer boxes N=1000 with NaN and infinite coordinates", nonfinite, 0.5)])
    routes = {n: nms.sweep_route(n) for n in (6000, 12000, NMS_WINDOW_BOXES)}
    check(routes == {6000: "staged", 12000: "window", NMS_WINDOW_BOXES: "window"}, f"nms routes: {routes}")
    lines = []
    for label, boxes, thr in cases:
        keep = nms.nms_keep_sorted(boxes, thr)
        plain = nms.nms_keep_sorted_plain(boxes, thr)
        again = nms.nms_keep_sorted(boxes, thr)
        torch.cuda.synchronize()
        first = int((keep != plain).nonzero()[0]) if not torch.equal(keep, plain) else -1
        check(torch.equal(keep, plain) and torch.equal(keep, again),
              f"nms {label}: kernel keeps {int(keep.sum())}, plain {int(plain.sum())}, second launch "
              f"{int(again.sum())}; first difference at {first}")
        lines.append(f"{label} at {thr} ({nms.sweep_route(boxes.shape[0])}): {int(keep.sum())} of "
                     f"{boxes.shape[0]} kept, equal")
    boxes = real
    keep = nms.nms_keep_sorted(boxes, 0.7)
    n = boxes.shape[0]
    swept, pairs = nms_sweep_tests(nms.suppression_matrix(boxes, 0.7))
    check(np.array_equal(swept, keep.cpu().numpy()), "nms: the counting sweep keeps other boxes than the kernel")
    nbytes = n * 16 + n
    b_ms, b_by = bound_ms(nbytes, pairs * NMS_TEST_OPS, PEAK_F32_FLOP_PER_S)
    times = nms_times(boxes, dev)
    p_ms = median_ms(lambda: nms.nms_keep_sorted_plain(boxes, 0.7), reps=3, inner=1)

    def us(ms):
        return "not measured" if ms is None else f"{ms * 1e3:.1f} us"

    record = dict(max_abs_err=0.0, ms=times["ms"], cold_ms=times["cold_ms"], single_ms=times["single_ms"],
                  plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, boxes=n, kept=int(keep.sum()),
                  pairs_needed=pairs, mask_ms=times["mask_ms"], sweep_ms=times["sweep_ms"])
    phase(13, "nms kernel against its plain version, keep masks equal: " + "; ".join(lines)
              + f". On the real proposals (N={n}, threshold 0.7, {int(keep.sum())} kept): kernel "
              f"{times['ms'] * 1e3:.1f} us back to back, {times['cold_ms'] * 1e3:.1f} us with a cold L2 "
              f"({NMS_COLD_CALLS} copies of the boxes and their mask words in turn, {times['cold_mb']:.0f} MB; median "
              f"of 10 rounds), {times['single_ms'] * 1e3:.1f} us single; by kernel (torch.profiler, device time a "
              f"call) mask pass {us(times['mask_ms'])}, sweep {us(times['sweep_ms'])}; "
              f"plain {p_ms:.1f} ms; bound {b_ms * 1e3:.3f} us "
              f"({b_by}: {pairs} IoU tests of {NMS_TEST_OPS} f32 operations, each kept box against the later boxes "
              f"still there when it is reached; {nbytes} bytes); no PyTorch call computes NMS (library_ms null)")
    del real, cases, exact, nonfinite
    torch.cuda.empty_cache()

    # (b) the detection trainer's CLI: the shipped cfg, whose LEARNING_RATE
    # (0.001) from the init rules without ImageNet weights diverges as the
    # JAX trainer's does; then the same cfg at DET_STABLE_LR for the timings
    # and the snapshot that (c) scores
    cfg_rel = os.path.join("experiments", "cfgs", "lov_det.yml")

    def det_cli(name: str, cfg_path: str, iters: int) -> tuple:
        out_dir = os.path.join(work, name)
        rc, log = run_cli(["posecnn_torch.train_net", "--cfg", cfg_path, "--imdb", "lov_syn_val_v4", "--iters",
                           str(iters), "--output", out_dir], os.path.join(work, name + ".log"), 600)
        check(rc == 0, f"train_net --cfg {cfg_path} exited {rc}:\n{log[-3000:]}")
        snap = os.path.join(out_dir, f"{det_file.TRAIN.SNAPSHOT_PREFIX}_iter_{iters}.npz")
        check(os.path.exists(snap), f"no snapshot {snap}")
        with open(os.path.join(out_dir, "train_timing.json")) as fh:
            timing = json.load(fh)
        want = {"hough_vote": 0, "conv3x3": 2 * iters, "nms": iters}
        check(timing["launches"] == want, f"{name}: launches {timing['launches']}, want {want}")
        display = det_file.TRAIN.DISPLAY  # the trainer logs the first step and every DISPLAY steps
        check(iters % display == 0, f"{name}: {iters} steps, not a multiple of DISPLAY {display}")
        losses = {it: _cli_losses(log, it, iters) for it in (1, *range(display, iters + 1, display))}
        check(all(np.isfinite(v) for v in losses[1].values()), f"{name}: first losses {losses[1]}")
        return snap, timing, losses

    _, timing, losses = det_cli("det_shipped", cfg_rel, DET_SHIPPED_STEPS)
    launches["det_train_cli_shipped"] = timing["launches"]
    diverged = not all(np.isfinite(v) for v in losses[DET_SHIPPED_STEPS].values())
    phase(13, f"train_net --cfg lov_det.yml (as shipped: LEARNING_RATE 0.001) --iters {DET_SHIPPED_STEPS}: losses at "
              f"step 1 {losses[1]}, at step {DET_SHIPPED_STEPS} {losses[DET_SHIPPED_STEPS]} ("
              + ("diverged, as the JAX trainer does from its own init" if diverged else "finite")
              + f"); launches {timing['launches']}")
    stable = os.path.join(work, "lov_det_stable.yml")
    with open(os.path.join(ROOT, cfg_rel)) as fh:
        text = fh.read()
    check("  LEARNING_RATE: 0.001\n" in text, "lov_det.yml's LEARNING_RATE line moved")
    with open(stable, "w") as fh:
        # positional: YAML 1.1 reads "1e-05" (no dot) as a string
        fh.write(text.replace("  LEARNING_RATE: 0.001\n",
                              f"  LEARNING_RATE: {np.format_float_positional(DET_STABLE_LR)}\n"))
    snap, timing, losses = det_cli("det", stable, DET_STEPS)
    launches["det_train_cli"] = timing["launches"]
    check(all(np.isfinite(v) for m in losses.values() for v in m.values()), f"det losses {losses}")
    ms = {k: statistics.median(v[DET_WARMUP:]) for k, v in timing["ms"].items()}
    phase(13, f"train_net --cfg lov_det.yml at LEARNING_RATE {DET_STABLE_LR} --imdb lov_syn_val_v4 --iters {DET_STEPS} "
              f"(VGG16DET, B=1, 640x480, bf16, 22 classes, raw frames): per step (median of steps "
              f"{DET_WARMUP + 1}-{DET_STEPS}) {ms['step_stream']:.3f} ms stream, {ms['step']:.3f} ms host, data wait "
              f"{ms['data_wait']:.3f} ms; peak memory {timing['peak_memory_mib']:.1f} MiB; losses "
              + "; ".join(f"step {it}: {m}" for it, m in losses.items()) + f"; launches {timing['launches']}")
    print("det train per-step ms " + json.dumps({k: [round(x, 3) for x in v] for k, v in timing["ms"].items()}),
          flush=True)

    # (c) the detection evaluation on that snapshot
    ev = os.path.join(work, "det_eval")
    rc, log = run_cli(["posecnn_torch.test_net", "--cfg", cfg_rel, "--imdb", "lov_syn_val_v4", "--model", snap,
                       "--max_frames", str(DET_EVAL_FRAMES), "--output", ev], os.path.join(work, "det_eval.log"), 600)
    check(rc == 0, f"test_net --cfg lov_det.yml exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(ev, "eval_summary.json")) as fh:
        summary = json.load(fh)
    with open(os.path.join(ev, "eval_timing.json")) as fh:
        ev_timing = json.load(fh)
    launches["det_eval"] = ev_timing["launches"]
    want = {"hough_vote": 0, "conv3x3": DET_EVAL_FRAMES, "nms": DET_EVAL_FRAMES}
    check(ev_timing["launches"] == want and 0 <= summary["mAP@0.5"] <= 1,
          f"det eval launches {ev_timing['launches']} (want {want}), mAP {summary['mAP@0.5']}")
    ev_ms = {k: statistics.median(v[DET_EVAL_WARMUP:]) for k, v in ev_timing["ms"].items()}
    phase(13, f"test_net --cfg lov_det.yml --model <the iter-{DET_STEPS} snapshot> --max_frames {DET_EVAL_FRAMES}: "
              f"mAP@0.5 {summary['mAP@0.5']:.4f} over {len(summary['ap_per_class'])} classes with GT; detections a "
              f"frame {ev_timing['detections']}; per frame (median of frames {DET_EVAL_WARMUP + 1}-{DET_EVAL_FRAMES}) "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ev_ms.items())
              + f"; peak {ev_timing['peak_memory_mib']:.1f} MiB; launches {ev_timing['launches']}")

    # (d) one full-width det step at float32, card against CPU
    t0 = time.perf_counter()
    hp = C.det_hparams(det_file)
    cfg32 = dataclasses.replace(C.det_model_cfg(det_file, n_cls, train=True), compute_dtype=torch.float32)
    params = D.init_vgg16_det_params_numpy(det_file.RNG_SEED, cfg32)
    sym = np.asarray(imdb._symmetry, np.float32)
    pts = M.rescale_points(np.asarray(imdb._points_all, np.float32), np.asarray(imdb._extents), sym)
    batch = T.det_batch_from_frame(frame, det_file.TPU.MAX_GT)
    gen = torch.Generator(device=dev)
    gen.manual_seed(det_file.RNG_SEED)
    draws = T.Draws(gen, record=True)
    state = T.create_train_state(D.make_det_model(cfg32, params, dev), hp)
    step = T.make_det_train_step(cfg32, hp, torch.from_numpy(pts).to(dev), torch.from_numpy(sym).to(dev))
    reset()
    got = {k: float(v) for k, v in step(state, T.to_device(batch, dev), draws).items()}
    launches["det_step"] = counts()
    check(launches["det_step"] == {"hough_vote": 0, "conv3x3": 0, "nms": 1}, f"det f32 step {launches['det_step']}")
    grads = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
    del state, step
    torch.cuda.empty_cache()
    recorded = {k: v.cpu() for k, v in draws.recorded.items()}
    # the RCNN losses and every gradient follow the sampled rois, so both
    # sides must sample the same ones (the same forward, no update, the
    # recorded draws again): a fault that moves them fails here
    m = D.make_det_model(cfg32, params, dev)
    with torch.no_grad():
        b = T.to_device(batch, dev)
        x = b["data"].float() - torch.tensor(hp.pixel_means, device=dev).reshape(1, 1, 1, 3)
        o = D.vgg16_det_forward(m, cfg32, x, b["gt_boxes"], b["poses"], T.Draws(replay=recorded))
        card_rois = (o["rois"].cpu(), o["labels"].cpu())
    del m, b, x, o
    card_s = time.perf_counter() - t0
    det_step_launches = launches["det_step"]

    def det_step_on_cpu(cfg32=cfg32, params=params, hp=hp, pts=pts, sym=sym, batch=batch, recorded=recorded,
                        got=got, grads=grads, card_rois=card_rois, launches=det_step_launches):
        t0 = time.perf_counter()
        state_cpu = T.create_train_state(D.make_det_model(cfg32, params, "cpu"), hp)
        step_cpu = T.make_det_train_step(cfg32, hp, torch.from_numpy(pts), torch.from_numpy(sym))
        ref = {k: float(v) for k, v in step_cpu(state_cpu, T.to_device(batch, "cpu"), T.Draws(replay=recorded)).items()}
        rel = {k: _rel(got[k], ref[k]) for k in DET_LOSS_LIMITS}
        grad_rel = {k: float((grads[k] - p.grad).abs().max()) / max(float(p.grad.abs().max()), 1e-30)
                    for k, p in state_cpu.model.named_parameters()}
        m = D.make_det_model(cfg32, params, "cpu")
        with torch.no_grad():
            b = T.to_device(batch, "cpu")
            x = b["data"].float() - torch.tensor(hp.pixel_means).reshape(1, 1, 1, 3)
            o = D.vgg16_det_forward(m, cfg32, x, b["gt_boxes"], b["poses"], T.Draws(replay=recorded))
        roi_err = float((card_rois[0] - o["rois"]).abs().max())
        check(torch.equal(card_rois[1], o["labels"]) and roi_err <= 1e-2,
              f"det f32 step: the sampled rois differ between card and CPU (labels equal "
              f"{torch.equal(card_rois[1], o['labels'])}, rois max|err| {roi_err} px, limit 1e-2)")
        check(all(rel[k] <= DET_LOSS_LIMITS[k] for k in DET_LOSS_LIMITS)
              and all(grad_rel[k] <= DET_GRAD_LIMITS[k] for k in DET_GRAD_LIMITS),
              f"det f32 step, card against CPU: relative errors {rel}, limits {DET_LOSS_LIMITS}; gradients "
              + ", ".join(f"{k} {grad_rel[k]:.3g}" for k in DET_GRAD_LIMITS) + f", limits {DET_GRAD_LIMITS}")
        phase(13, f"det step at float32 (B=1, 640x480, 22 classes, TF32 off, seed weights, recorded draws), card "
                  f"against the CPU port ({time.perf_counter() - t0:.1f} s on the CPU thread; the sampled labels equal "
                  f"on the two sides, rois within {roi_err:.3g} px, limit 1e-2): "
                  + "; ".join(f"{k} {got[k]:.6g} vs {ref[k]:.6g}, rel {rel[k]:.3g} (limit {DET_LOSS_LIMITS[k]})"
                              for k in DET_LOSS_LIMITS)
                  + "; " + "; ".join(f"{k} gradient {grad_rel[k]:.3g} of its largest magnitude (limit {lim})"
                                     for k, lim in DET_GRAD_LIMITS.items())
                  + f"; launches {launches}")

    defer(13, "the det step on the CPU port", det_step_on_cpu)
    # the proposals of identical RPN outputs (the card's bf16 forward of
    # (a)'s model, `det_proposals`), on the card and on the CPU
    test_cfg = C.det_model_cfg(det_file, n_cls, train=False)
    A = test_cfg.num_anchors
    data = torch.from_numpy(frame.color[None]).to(dev).float() - torch.tensor(det_file.PIXEL_MEANS, device=dev)
    model = D.make_det_model(test_cfg, D.init_vgg16_det_params_numpy(det_file.RNG_SEED, test_cfg), dev)
    with torch.inference_mode():
        o = D.vgg16_det_forward(model, test_cfg, data)
        args = (o["rpn_cls_prob"][0], o["rpn_bbox_pred"][0])
        Hf, Wf = args[0].shape[:2]
        anchors = D._anchors(Hf, Wf, 16, tuple(test_cfg.anchor_ratios), tuple(test_cfg.anchor_scales), dev)
        r_card, s_card = proposal_layer(*args, anchors, (480, 640), A)
        r_cpu, s_cpu = proposal_layer(*(a.cpu() for a in args), anchors.cpu(), (480, 640), A)
    prop_err = float((r_card.cpu() - r_cpu).abs().max())
    check(torch.equal(s_card.cpu(), s_cpu) and prop_err <= 1e-3,
          f"proposals on identical RPN inputs: scores equal {torch.equal(s_card.cpu(), s_cpu)}, rois max|err| "
          f"{prop_err} (limit 1e-3 px)")
    del model
    torch.cuda.empty_cache()
    golden_err = check_det_golden(*det_on_golden(dev))
    phase(13, f"det step at float32 on the card ({card_s:.1f} s; the CPU side on the CPU thread). Proposals of the "
              f"card's bf16 RPN outputs (6000 -> 300 at 0.7) on the card and the CPU: scores equal, "
              f"{int((s_cpu > 0).sum())} rows, rois max|err| {prop_err:.3g} px (limit 1e-3). The JAX det golden on the "
              f"card (f32 forward, proposals, RANSAC): " + ", ".join(f"{k} {v:.3g}" for k, v in golden_err.items()))

    # (e) the 3D head's evaluation, and RANSAC on the card against the CPU
    cfg3_rel = os.path.join("experiments", "cfgs", "lov_color_3d.yml")
    ev3 = os.path.join(work, "eval3d")
    rc, log = run_cli(["posecnn_torch.test_net", "--cfg", cfg3_rel, "--imdb", "lov_syn_val_v4", "--max_frames",
                       str(DET_EVAL_FRAMES), "--output", ev3], os.path.join(work, "eval3d.log"), 600)
    check(rc == 0, f"test_net --cfg lov_color_3d.yml exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(ev3, "eval_timing.json")) as fh:
        t3 = json.load(fh)
    launches["eval_3d"] = t3["launches"]
    check(t3["launches"] == {"hough_vote": 0, "conv3x3": DET_EVAL_FRAMES, "nms": 0}, f"3D eval {t3['launches']}")
    with np.load(os.path.join(ev3, "detections.npz")) as d:
        poses3 = [d[k] for k in d.files if k.endswith("_poses")]
    check(all(np.isfinite(p).all() and p.shape[1] == 7 for p in poses3), "3D eval: poses not finite")
    ms3 = {k: statistics.median(v[DET_EVAL_WARMUP:]) for k, v in t3["ms"].items()}
    label, depth, vp, extents, meta = ransac_scene()
    rec = T.Draws(torch.Generator(device=dev).manual_seed(0), record=True)
    vp_card = torch.from_numpy(vp[None]).to(dev)
    rois_c, poses_c = E.decode_poses_3d({"label_2d": label[None], "vertex_pred": vp_card}, depth, meta, extents, 4,
                                        draws=rec)
    rois_p, poses_p = E.decode_poses_3d({"label_2d": label[None], "vertex_pred": torch.from_numpy(vp[None])}, depth,
                                        meta, extents, 4, draws=T.Draws(replay={k: v.cpu() for k, v in
                                                                                rec.recorded.items()}))
    t_err = float(np.abs(poses_c[:, 4:] - poses_p[:, 4:]).max())
    q_err = max(1 - abs(float(np.dot(a, b))) for a, b in zip(poses_c[:, :4], poses_p[:, :4]))
    check(np.array_equal(rois_c, rois_p) and rois_c.shape[0] == 2 and t_err <= 2e-4 and q_err <= 5e-3,
          f"RANSAC card against CPU: rois {rois_c} vs {rois_p}, t {t_err}, q {q_err}")
    dec_ms = single_ms(lambda: E.decode_poses_3d({"label_2d": label[None], "vertex_pred": vp_card}, depth, meta,
                                                 extents, 4))
    phase(13, f"test_net --cfg lov_color_3d.yml --imdb lov_syn_val_v4 --max_frames {DET_EVAL_FRAMES} (the 3D head, "
              f"RANSAC, seed weights): {sum(len(p) for p in poses3)} poses, all finite; per frame (median of frames "
              f"{DET_EVAL_WARMUP + 1}-{DET_EVAL_FRAMES}) " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms3.items())
              + f"; peak {t3['peak_memory_mib']:.1f} MiB; launches {t3['launches']}. RANSAC on a well-posed scene "
              f"(2 boxes, 256 hypotheses, 512 points, recorded draws) card against CPU: rois equal (inliers "
              f"{rois_c[:, 6].tolist()}), t max|err| {t_err:.3g} m, 1-|q.q'| {q_err:.3g} (limits 2e-4, 5e-3); "
              f"decode_poses_3d on the card {dec_ms:.3f} ms a call (2 classes, host label count included)")

    # (f) one 3D step on rendered scenes with their vertmaps, card against CPU
    t0 = time.perf_counter()
    cfg3 = C.cfg_from_file(os.path.join(ROOT, cfg3_rel))
    model_cfg, hp3, mcfg = C.train_model_cfg(cfg3, n_cls), C.train_hparams(cfg3), C.minibatch_cfg(cfg3, n_cls)
    frames = rendered_3d_frames(2, seed=cfg3.RNG_SEED)
    batch = M.get_minibatch(frames, mcfg, np.random.RandomState(cfg3.RNG_SEED), extents=imdb._extents)
    check("vertex_targets3" in batch and batch["vertex_weights3"].sum() > 0, "3D batch without targets")
    ext = np.asarray(imdb._extents, np.float32)
    consts = [torch.from_numpy(a) for a in (M.rescale_points(np.asarray(imdb._points_all, np.float32), ext, sym),
                                            sym, ext)]
    weights = init_params_numpy(cfg3.RNG_SEED, model_cfg)
    state = T.create_train_state(make_model(model_cfg, weights, dev), hp3)
    step = T.make_train_step(model_cfg, hp3, *(c.to(dev) for c in consts))
    draws = T.Draws(torch.Generator(device=dev).manual_seed(cfg3.RNG_SEED), record=True)
    reset()
    got = {k: float(v) for k, v in step(state, T.to_device(batch, dev), draws).items()}
    launches["step_3d"] = counts()
    check(launches["step_3d"] == {"hough_vote": 0, "conv3x3": 2, "nms": 0}, f"3D step {launches['step_3d']}")
    check(np.isfinite(got["loss_vertex"]) and got["loss_vertex"] > 0, f"3D step losses {got}")
    grads = {k: p.grad.detach().float().cpu() for k, p in state.model.named_parameters()}
    del state, step
    torch.cuda.empty_cache()
    recorded = {k: v.cpu() for k, v in draws.recorded.items()}
    step3_launches = launches["step_3d"]

    def step_3d_on_cpu(model_cfg=model_cfg, weights=weights, hp3=hp3, batch=batch, consts=consts, recorded=recorded,
                       got=got, grads=grads, launches=step3_launches):
        t0 = time.perf_counter()
        state_cpu = T.create_train_state(make_model(model_cfg, weights, "cpu"), hp3)
        replay = T.Draws(replay=recorded)
        loss, ref = T.compute_losses(state_cpu.model, model_cfg, hp3, T.to_device(batch, "cpu"), *consts, replay)
        ref = {k: float(v.detach()) for k, v in ref.items()}
        ref["grad_norm"] = float(T.train_update(state_cpu, loss, T.lr_schedule(hp3)(0)))
        rel = {k: _rel(got[k], ref[k]) for k in TRAIN_LOSS_LIMITS}
        grad_rel = {k: float((grads[k] - p.grad.float()).abs().max()) / max(float(p.grad.abs().max()), 1e-30)
                    for k, p in state_cpu.model.named_parameters()}
        check(all(rel[k] <= lim for k, lim in TRAIN_LOSS_LIMITS.items())
              and all(grad_rel[k] <= lim for k, lim in TRAIN_GRAD_LIMITS.items()),
              f"3D step, card against CPU: relative errors {rel}, limits {TRAIN_LOSS_LIMITS}; gradients "
              + ", ".join(f"{k} {grad_rel[k]:.3g}" for k in TRAIN_GRAD_LIMITS) + f", limits {TRAIN_GRAD_LIMITS}")
        phase(13, f"3D step (lov_color_3d.yml: B=2, 640x480, bf16, keep 0.5, device chroma and noise) on two rendered "
                  f"scenes with the rasterizer's vertmaps, card against the CPU port ({time.perf_counter() - t0:.1f} s "
                  f"on the CPU thread): "
                  + "; ".join(f"{k} {got[k]:.6g} vs {ref[k]:.6g}, rel {rel[k]:.3g} (limit {TRAIN_LOSS_LIMITS[k]})"
                              for k in TRAIN_LOSS_LIMITS)
                  + "; " + "; ".join(f"{k} gradient {grad_rel[k]:.3g} (limit {lim})"
                                     for k, lim in TRAIN_GRAD_LIMITS.items())
                  + f"; launches {launches}")

    defer(13, "the 3D step on the CPU port", step_3d_on_cpu)
    step_s = time.perf_counter() - t0
    rc, log = run_cli(["posecnn_torch.train_net", "--cfg", cfg3_rel, "--imdb", "lov_syn_val_v4", "--iters", "1",
                       "--output", os.path.join(work, "train3d")], os.path.join(work, "train3d.log"), 300)
    check(rc != 0 and "Frame.vertmap" in log, f"train_net --cfg lov_color_3d.yml: exit {rc}, log:\n{log[-2000:]}")
    message = [ln for ln in log.splitlines() if "Frame.vertmap" in ln][-1].strip()
    phase(13, f"3D step on the card ({step_s:.1f} s; the CPU side on the CPU thread): launches {launches['step_3d']}. "
              f"train_net --cfg lov_color_3d.yml --imdb lov_syn_val_v4 exits {rc}: {message[:200]}; phase 13's card "
              f"work took {time.perf_counter() - t_phase:.1f} s")
    return record, launches


def _slice_j_step_on_cpu(key, model_cfg, weights, hp, batch, consts, recorded, got, grads, card, n_gt,
                         loss_pose_before, launches) -> None:
    """Phase 14 (b)'s CPU side: the f32 step of VGG16FULL or the adaptation
    cfg on the CPU port, on the card step's batch and draws, held to the
    card's losses, gradients and Hough rows (`card`)."""
    import torch

    from posecnn_torch.core.convert import make_model
    from posecnn_torch.engine import train as T
    from posecnn_torch.models import posecnn_full as PF
    from posecnn_torch.models.posecnn import posecnn_forward

    t0 = time.perf_counter()
    full = key == "full"
    outs = []

    def forward(*a, **k):
        out = (PF.posecnn_full_forward if full else posecnn_forward)(*a, **k)
        outs.append({n: out[n].detach().cpu() for n in ("rois", "rois_valid", "label_2d", "poses_init")})
        return out

    kw = dict(forward_fn=forward, ce_threshold=PF.CE_THRESHOLD if full else None)
    state_cpu = T.create_train_state((PF.make_full_model if full else make_model)(model_cfg, weights, "cpu"), hp)
    ref = {k: float(v) for k, v in T.make_train_step(model_cfg, hp, *consts, **kw)(
        state_cpu, T.to_device(batch, "cpu"), T.Draws(replay=recorded)).items()}
    rel = {k: _rel(got[k], ref[k]) for k in ref if k.startswith("loss") or k == "grad_norm"}
    grad_rel = {k: float((grads[k] - p.grad).abs().max()) / max(float(p.grad.abs().max()), 1e-30)
                for k, p in state_cpu.model.named_parameters()}
    grad_max = {k: (float(grads[k].abs().max()), float(p.grad.abs().max()))
                for k, p in state_cpu.model.named_parameters() if k in SLICE_J_GRADS[key]}
    del state_cpu
    # the losses and the gradients follow Hough's rows, so both steps
    # must have sampled the same ones
    cpu = outs[0]
    agree = float((card["label_2d"] == cpu["label_2d"]).double().mean())
    roi_err = float((card["rois"][:, 2:6] - cpu["rois"][:, 2:6]).abs().max())
    same_cls = torch.equal(card["rois"][:, :2], cpu["rois"][:, :2])
    check(torch.equal(card["rois_valid"], cpu["rois_valid"]) and same_cls and roi_err <= 1e-2,
          f"{key} f32 step: Hough's rows differ between card and CPU (valid {card['rois_valid'].tolist()} vs "
          f"{cpu['rois_valid'].tolist()}, classes equal {same_cls}, "
          f"boxes max|err| {roi_err} px, limit 1e-2; label agreement {agree})")
    # the GT rows at the detections give the pose branch its targets:
    # loss_pose and the gradients of fc6-fc8 and conv5_3 are not 0
    check(got["loss_pose"] > 0 and ref["loss_pose"] > 0 and all(min(v) > 0 for v in grad_max.values()),
          f"{key} f32 step with {n_gt} GT rows at the detections: loss_pose {got['loss_pose']} (card) vs "
          f"{ref['loss_pose']} (CPU), {loss_pose_before} before; largest gradient (card, CPU) {grad_max}")
    limits = {k: SLICE_J_GRAD_LIMIT if k == "grad_norm" else SLICE_J_LOSS_LIMIT for k in rel}
    check(all(rel[k] <= limits[k] for k in rel) and all(grad_rel[k] <= SLICE_J_GRAD_LIMIT
                                                         for k in SLICE_J_GRADS[key]),
          f"{key} f32 step, card against CPU: relative errors {rel}, limits {limits}; gradients "
          + ", ".join(f"{k} {grad_rel[k]:.3g}" for k in SLICE_J_GRADS[key]) + f", limit {SLICE_J_GRAD_LIMIT}")
    worst = sorted(grad_rel, key=grad_rel.get, reverse=True)[:3]
    phase(14, f"{'VGG16FULL' if full else 'adaptation (domain head)'} step at float32 ({SLICE_J_CFGS[key]}: B=2, "
              f"640x480, 22 classes, TF32 off, seed weights, the cfg's first host batch with its {n_gt} GT pose "
              f"rows put at the detections of a forward on the card (loss_pose {loss_pose_before:.3g} "
              f"before), that forward's draws replayed), card "
              f"against the CPU port ({time.perf_counter() - t0:.1f} s on the CPU thread; Hough's "
              f"{int(card['rois_valid'].sum())} valid rows equal, boxes within {roi_err:.3g} px; label agreement "
              f"{agree:.6f}): "
              + "; ".join(f"{k} {got[k]:.6g} vs {ref[k]:.6g}, rel {rel[k]:.3g} (limit {limits[k]})" for k in rel)
              + "; " + "; ".join(f"{k} gradient {grad_rel[k]:.3g} of its largest magnitude (limit "
                                 f"{SLICE_J_GRAD_LIMIT})" for k in SLICE_J_GRADS[key])
              + "; worst gradients (not held) " + ", ".join(f"{k} {grad_rel[k]:.3g}" for k in worst)
              + f"; launches {launches}")


def full_adapt_gan_phase(work: str, dev) -> dict:
    """Phase 14: VGG16FULL, the domain head (TRAIN.ADAPT) and the VGG16GAN
    cfg. (a) `train_net --cfg lov_color_2d_full.yml --imdb lov_syn_val_v4
    --iters SLICE_J_STEPS` (B=2, 640x480, bf16: 4 hough_vote and 2 conv3x3
    launches a step) and `test_net --cfg` on its snapshot (2 and 1 a
    frame); the same for lov_color_sugar_box_adapt.yml (loss_domain in its
    log); `train_net --cfg shapenet_single_single_color_gan.yml --iters
    GAN_STEPS` (the label head alone: 2 conv3x3 launches a step; the
    jitter and the noise on the host). Each: stream and host ms a step,
    data wait, peak memory, the launches; the eval's ms a frame by stage.
    (b) One float32 step of VGG16FULL and one of the adaptation cfg on the
    card against the CPU port (the first host batch of the cfg with its GT
    pose rows put at the detections of one training forward on the card
    (`gt_rows_at_detections`), seed weights, that forward's draws replayed
    on both sides): the Hough rows equal on the two sides, loss_pose > 0,
    the gradients of SLICE_J_GRADS (fc6-fc8 and conv5_3 among them)
    non-zero, the losses and gradients within SLICE_J_LOSS_LIMIT and
    SLICE_J_GRAD_LIMIT. (c) VGG16FULL's float32 inference on the card
    against the JAX golden (`check_full_golden`). Returns the launches of
    each path."""
    import torch

    from posecnn_torch.core import config as C
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.data.layer import GtSynthesizeLayer
    from posecnn_torch.data.lov_syn import LovSynVal
    from posecnn_torch.data.minibatch import rescale_points
    from posecnn_torch.engine import train as T
    from posecnn_torch.models import posecnn_full as PF
    from posecnn_torch.models.posecnn import posecnn_forward
    from posecnn_torch.ops import conv3x3, nms, voting
    from tests.torch_parity import check_full_golden, full_on_golden, gt_rows_at_detections

    t_phase = time.perf_counter()
    launches = {}

    def counts():
        return {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES, "nms": nms.NMS_LAUNCHES}

    def cfg_path(key):
        return os.path.join("experiments", "cfgs", SLICE_J_CFGS[key])

    # (a) the trainers' CLIs, and test_net on FULL's and the adaptation
    # cfg's snapshots
    snaps = {}
    for key, iters, warm in (("full", SLICE_J_STEPS, SLICE_J_WARMUP), ("adapt", SLICE_J_STEPS, SLICE_J_WARMUP),
                             ("gan", GAN_STEPS, GAN_WARMUP)):
        cfg = C.cfg_from_file(os.path.join(ROOT, cfg_path(key)))
        out = os.path.join(work, key)
        rc, log = run_cli(["posecnn_torch.train_net", "--cfg", cfg_path(key), "--imdb", "lov_syn_val_v4", "--iters",
                           str(iters), "--output", out], os.path.join(work, key + ".log"), 600)
        check(rc == 0, f"train_net --cfg {SLICE_J_CFGS[key]} exited {rc}:\n{log[-3000:]}")
        resident = CLI_RUNS[-1]["resident_mib"]
        snaps[key] = os.path.join(out, f"{cfg.TRAIN.SNAPSHOT_PREFIX}_iter_{iters}.npz")
        check(os.path.exists(snaps[key]), f"no snapshot {snaps[key]}")
        with open(os.path.join(out, "train_timing.json")) as fh:
            timing = json.load(fh)
        launches[f"{key}_train_cli"] = timing["launches"]
        per_step = 0 if key == "gan" else 4  # the GAN cfg trains the label head alone: no Hough
        want = {"hough_vote": per_step * iters, "conv3x3": 2 * iters, "nms": 0}
        check(timing["launches"] == want, f"{key}: launches {timing['launches']}, want {want}")
        lines = (1, *range(cfg.TRAIN.DISPLAY, iters + 1, cfg.TRAIN.DISPLAY))
        losses = {it: _cli_losses(log, it, iters) for it in lines}
        check(all(np.isfinite(v) for m in losses.values() for v in m.values()), f"{key}: losses {losses}")
        check(("loss_domain" in losses[1]) == (key == "adapt") and ("loss_vertex" in losses[1]) == (key != "gan"),
              f"{key}: loss terms {sorted(losses[1])}")
        ms = {k: statistics.median(v[warm:]) for k, v in timing["ms"].items()}
        phase(14, f"train_net --cfg {SLICE_J_CFGS[key]} --imdb lov_syn_val_v4 --iters {iters} (B=2, 640x480, bf16, "
                  f"22 classes): per step (median of steps {warm + 1}-{iters}) {ms['step_stream']:.3f} ms stream, "
                  f"{ms['step']:.3f} ms host, data wait {ms['data_wait']:.3f} ms; peak memory "
                  f"{timing['peak_memory_mib']:.1f} MiB ({resident:.0f} MiB of it allocated before the run); losses "
                  + "; ".join(f"step {it}: {m}" for it, m in losses.items()) + f"; launches {timing['launches']}")
        print(f"{key} train per-step ms " + json.dumps({k: [round(x, 3) for x in v] for k, v in timing["ms"].items()}),
              flush=True)
        if key == "gan":
            continue
        ev = os.path.join(work, key + "_eval")
        rc, log = run_cli(["posecnn_torch.test_net", "--cfg", cfg_path(key), "--imdb", "lov_syn_val_v4", "--model",
                           snaps[key], "--max_frames", str(SLICE_J_EVAL_FRAMES), "--output", ev],
                          os.path.join(work, key + "_eval.log"), 600)
        check(rc == 0, f"test_net --cfg {SLICE_J_CFGS[key]} exited {rc}:\n{log[-3000:]}")
        with open(os.path.join(ev, "eval_summary.json")) as fh:
            summary = json.load(fh)
        with open(os.path.join(ev, "eval_timing.json")) as fh:
            ev_timing = json.load(fh)
        with np.load(os.path.join(ev, "detections.npz")) as d:
            dets = {k: d[k] for k in d.files}
        launches[f"{key}_eval"] = ev_timing["launches"]
        n = SLICE_J_EVAL_FRAMES
        want = {"hough_vote": 2 * n, "conv3x3": n, "nms": 0}
        check(ev_timing["frames"] == n and ev_timing["launches"] == want,
              f"{key} eval: {ev_timing['frames']} frames, launches {ev_timing['launches']}, want {want}")
        check(all(np.isfinite(v).all() and v.shape[1:] == (7,) for v in dets.values()), f"{key} eval: detections")
        check(0 <= summary["mean_iou"] <= 1 and 0 <= summary["adds_auc"] <= 1, f"{key} eval: summary {summary}")
        ev_ms = {k: statistics.median(v[SLICE_J_EVAL_WARMUP:]) for k, v in ev_timing["ms"].items()}
        phase(14, f"test_net --cfg {SLICE_J_CFGS[key]} --model <the iter-{SLICE_J_STEPS} snapshot> --max_frames {n}: "
                  f"{sum(len(v) for k, v in dets.items() if k.endswith('_rois'))} detections, mean IoU "
                  f"{summary['mean_iou']:.4f}, ADD-S AUC {summary['adds_auc']:.4f}; per frame (median of frames "
                  f"{SLICE_J_EVAL_WARMUP + 1}-{n}) " + ", ".join(f"{k} {v:.3f} ms" for k, v in ev_ms.items())
                  + f"; peak {ev_timing['peak_memory_mib']:.1f} MiB; launches {ev_timing['launches']}")

    # (b) one float32 step of VGG16FULL and of the adaptation cfg, card
    # against CPU
    imdb = LovSynVal()
    n_cls = imdb.num_classes
    ext, sym = np.asarray(imdb._extents, np.float32), np.asarray(imdb._symmetry, np.float32)
    consts = [torch.from_numpy(a) for a in (rescale_points(np.asarray(imdb._points_all, np.float32), ext, sym),
                                            sym, ext)]
    for key in ("full", "adapt"):
        t0 = time.perf_counter()
        full = key == "full"
        cfg = C.cfg_from_file(os.path.join(ROOT, cfg_path(key)))
        model_cfg = dataclasses.replace(C.train_model_cfg(cfg, n_cls), compute_dtype=torch.float32)
        hp, mcfg = C.train_hparams(cfg), C.minibatch_cfg(cfg, n_cls)
        batch = GtSynthesizeLayer(imdb, mcfg, ims_per_batch=cfg.TRAIN.IMS_PER_BATCH, seed=cfg.RNG_SEED).forward()
        weights = (PF.init_posecnn_full_params_numpy if full else init_params_numpy)(cfg.RNG_SEED, model_cfg)
        make = PF.make_full_model if full else make_model
        outs = []  # Hough's rows, the label map and poses_init of each forward

        def forward(*a, _net=PF.posecnn_full_forward if full else posecnn_forward, **k):
            out = _net(*a, **k)
            outs.append({n: out[n].detach().cpu() for n in ("rois", "rois_valid", "label_2d", "poses_init")})
            return out

        kw = dict(forward_fn=forward, ce_threshold=PF.CE_THRESHOLD if full else None)
        dev_consts = [c.to(dev) for c in consts]
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.RNG_SEED)
        draws = T.Draws(gen, record=True)
        # the GT pose rows at the network's own detections: one training
        # forward on the card with the draws recorded, whose valid rows give
        # each GT row its image, class and translation
        with torch.no_grad():
            _, drawn = T.compute_losses(make(model_cfg, weights, dev), model_cfg, hp, T.to_device(batch, dev),
                                        *dev_consts, draws, forward, kw["ce_threshold"])
        batch["poses"] = gt_rows_at_detections(outs.pop(), batch["poses"])
        n_gt = int((batch["poses"][:, 1] > 0).sum())
        recorded = {k: v.cpu() for k, v in draws.recorded.items()}
        state = T.create_train_state(make(model_cfg, weights, dev), hp)
        step = T.make_train_step(model_cfg, hp, *dev_consts, **kw)
        voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = nms.NMS_LAUNCHES = 0
        got = {k: float(v) for k, v in step(state, T.to_device(batch, dev), T.Draws(replay=recorded)).items()}
        launches[f"{key}_f32_step"] = counts()
        check(launches[f"{key}_f32_step"] == {"hough_vote": 4, "conv3x3": 0, "nms": 0},
              f"{key} f32 step: launches {launches[f'{key}_f32_step']}")
        grads = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
        del state, step
        torch.cuda.empty_cache()
        defer(14, f"the {key} f32 step on the CPU port", functools.partial(
            _slice_j_step_on_cpu, key, model_cfg, weights, hp, batch, consts, recorded, got, grads, outs.pop(), n_gt,
            float(drawn["loss_pose"]), launches[f"{key}_f32_step"]))
    torch.cuda.empty_cache()

    # (c) VGG16FULL's inference on the card against the JAX golden
    err = check_full_golden(*full_on_golden(dev))
    phase(14, "VGG16FULL inference (f32, TF32 off, the golden's small config, 2 frames at 64x80) against JAX, "
              "labels, valid rows, num_rois and classes exact: " + "; ".join(f"{k} max|err| {v:.3g}"
                                                                          for k, v in err.items())
              + f" (prob_normalized, vertex_pred within 1e-5 x max; rois 1e-3, poses_init 1e-4, poses_tanh 1e-5); "
              f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _lov_tree_cfg(work: str, lov_root: str) -> tuple:
    """(config, file) of lov_color_2d.yml with SYNROOT at the tree's
    data_syn/ and SYNNUM 16, written as <work>/lov_color_2d_tree.yml."""
    from tests.torch_parity import lov_batch_cfg

    cfg = lov_batch_cfg(lov_root)
    cfg_file = os.path.join(work, "lov_color_2d_tree.yml")
    with open(os.path.join(ROOT, "experiments", "cfgs", "lov_color_2d.yml")) as f:
        text = f.read()
    with open(cfg_file, "w") as f:
        f.write(text.replace("  SYNNUM: 80000\n", f"  SYNNUM: 16\n  SYNROOT: {cfg.TRAIN.SYNROOT}\n"))
    return cfg, cfg_file


def datasets_phase(work: str, dev) -> dict:
    """Phase 15: the dataset loaders, the PNG reader and the synthesis mix,
    on trees this phase writes under `work` with the port alone (its PNG
    writer and scipy's savemat; no cv2 here), POSECNN_DATA pointed at them
    for the phase and restored after. (a) A YCB-Video tree of v4 frames
    0-15 with data_syn/ of frames 16-31 (`write_lov_tree`): every frame read
    back through get_imdb("lov_train") and OfflineSynReader equal to its
    npz frame; the reader's host ms a 640x480 frame (colour, label, depth,
    meta); the first two host batches of lov_color_2d.yml on the tree held
    to the JAX golden (`check_lov_batch_golden`). (b) `train_net --cfg`
    <lov_color_2d.yml with SYNROOT at the tree's data_syn/ and SYNNUM 16>
    `--imdb lov_train --iters LOV_STEPS` (B=2, 640x480, bf16, SYN_RATIO 5,
    no backgrounds): finite losses, the share of synthetic batches, the
    data wait and stream ms a step, 4 hough_vote and 2 conv3x3 launches a
    step; `test_net --cfg lov_color_2d.yml --imdb lov_keyframe` on its
    snapshot over the 16 frames (ADD-S AUC, ms a frame by stage, 2 + 1
    launches a frame). (c) A LINEMOD tree for ape (`write_linemod_tree`:
    labels from one v4 class, models/ape.ply binary, indexes/): `train_net
    --cfg linemod_ape_pose.yml --imdb linemod_ape_train --iters
    LINEMOD_STEPS` and `test_net --imdb linemod_ape_test` on its snapshot,
    the evaluator at ape's 0.1 x diameter. Returns the launches of each
    path."""
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.data.linemod import LINEMOD_DIAMETERS
    from posecnn_torch.data.lov import read_meta
    from posecnn_torch.data.synthetic import OfflineSynReader
    from posecnn_torch.utils.png import IMREAD_COLOR, IMREAD_UNCHANGED, imread
    from tests.torch_parity import (
        check_lov_batch_golden, goldens, load_npz, lov_index, port_lov_batches, v4_frame,
        write_linemod_tree, write_lov_tree,
    )

    t_phase = time.perf_counter()
    launches = {}
    root = os.path.join(work, "datasets")
    old_root = os.environ.get("POSECNN_DATA")
    os.environ["POSECNN_DATA"] = root
    try:
        # (a) the tree, read back, timed, and the host batches vs the golden
        t0 = time.perf_counter()
        lov_root = write_lov_tree(root)
        write_s = time.perf_counter() - t0
        imdb = get_imdb("lov_train")
        reader = OfflineSynReader(os.path.join(lov_root, "data_syn"), 16)
        fields = ("color", "label", "depth", "cls_indexes", "poses", "center", "intrinsic_matrix")
        for src, frames in ((imdb, range(16)), (reader, range(16, 32))):
            for k, i in enumerate(frames):
                got, ref = src.load_frame(k if src is reader else i), v4_frame(i)
                bad = [f for f in fields if not np.array_equal(getattr(got, f), getattr(ref, f))]
                check(not bad and got.factor_depth == ref.factor_depth, f"frame {i} read back: {bad} differ")
        base = os.path.join(lov_root, "data", lov_index(0))
        parts = {"color": lambda: imread(base + "-color.png", IMREAD_COLOR),
                 "label": lambda: imread(base + "-label.png", IMREAD_UNCHANGED),
                 "depth": lambda: imread(base + "-depth.png", IMREAD_UNCHANGED),
                 "meta": lambda: read_meta(base + "-meta.mat")}
        part_ms = {k: _host_ms(fn, 10) for k, fn in parts.items()}
        frame_ms = _host_ms(lambda: imdb.load_frame(3), 10)
        phase(15, f"YCB-Video tree of v4 frames 0-15 and data_syn/ of frames 16-31 written in {write_s:.2f} s "
                  f"(the port's PNG writer, scipy savemat); all 32 frames read back through get_imdb('lov_train') "
                  f"and OfflineSynReader equal to their npz frames; host ms a 640x480 frame: load_frame "
                  f"{frame_ms:.3f} (colour {part_ms['color']:.3f}, label {part_ms['label']:.3f}, depth "
                  f"{part_ms['depth']:.3f}, meta {part_ms['meta']:.3f}; medians of 10)")
        g = load_npz(goldens().LOV_BATCH_GOLDEN)
        held = check_lov_batch_golden(port_lov_batches(lov_root), g)
        phase(15, f"the first 2 host batches of lov_color_2d.yml on the tree (train_net's layer on this host) equal "
                  f"to the JAX golden: {held['arrays']} arrays, {held['digests']} of them image-sized by sha256")

        # (b) lov_color_2d.yml trains on the tree and is scored
        cfg, cfg_file = _lov_tree_cfg(work, lov_root)
        out = os.path.join(work, "lov_color_2d")
        rc, log = run_cli(["posecnn_torch.train_net", "--cfg", cfg_file, "--imdb", "lov_train", "--iters",
                           str(LOV_STEPS), "--output", out], os.path.join(work, "lov_color_2d.log"), 600)
        check(rc == 0, f"train_net --cfg lov_color_2d.yml exited {rc}:\n{log[-3000:]}")
        with open(os.path.join(out, "train_timing.json")) as fh:
            timing = json.load(fh)
        launches["lov_train_cli"] = timing["launches"]
        want = {"hough_vote": 4 * LOV_STEPS, "conv3x3": 2 * LOV_STEPS, "nms": 0}
        check(timing["launches"] == want, f"lov_color_2d: launches {timing['launches']}, want {want}")
        losses = {it: _cli_losses(log, it, LOV_STEPS) for it in (1, LOV_STEPS)}
        check(all(np.isfinite(v) for m in losses.values() for v in m.values()), f"lov_color_2d: losses {losses}")
        src = timing["batches_by_source"]
        check(src["syn"] > 0 and src["real"] > 0 and src["adapt"] == 0, f"lov_color_2d: batches by source {src}")
        log_seconds(r"host batches made by source", log)
        ms = {k: statistics.median(v[LOV_WARMUP:]) for k, v in timing["ms"].items()}
        phase(15, f"train_net --cfg lov_color_2d.yml (SYNROOT the tree's data_syn/, SYNNUM 16) --imdb lov_train "
                  f"--iters {LOV_STEPS} (B=2, 640x480, bf16, SYN_RATIO 5, no backgrounds): per step (median of "
                  f"steps {LOV_WARMUP + 1}-{LOV_STEPS}) {ms['step_stream']:.3f} ms stream, {ms['step']:.3f} ms host, "
                  f"data wait {ms['data_wait']:.3f} ms; host batches by source {src} (synthetic share "
                  f"{src['syn'] / (src['syn'] + src['real']):.3f}, SYN_RATIO 5 gives 5/6); peak memory "
                  f"{timing['peak_memory_mib']:.1f} MiB; losses "
                  + "; ".join(f"step {it}: {m}" for it, m in losses.items())
                  + f"; launches {timing['launches']} (a step: hough_vote "
                  f"{timing['launches']['hough_vote'] / LOV_STEPS:g}, conv3x3 "
                  f"{timing['launches']['conv3x3'] / LOV_STEPS:g})")
        print("lov_color_2d train per-step ms " + json.dumps({k: [round(x, 3) for x in v]
                                                               for k, v in timing["ms"].items()}), flush=True)
        snap = os.path.join(out, f"{cfg.TRAIN.SNAPSHOT_PREFIX}_iter_{LOV_STEPS}.npz")
        launches["lov_eval"] = _eval_cli(["--cfg", cfg_file, "--imdb", "lov_keyframe", "--model", snap],
                                         os.path.join(work, "lov_eval"), 16, "lov_color_2d.yml --imdb lov_keyframe")

        # (c) LINEMOD ape
        write_linemod_tree(root, cls="ape", frames=range(LINEMOD_FRAMES))
        lm_cfg = os.path.join("experiments", "cfgs", "linemod_ape_pose.yml")
        out = os.path.join(work, "linemod")
        rc, log = run_cli(["posecnn_torch.train_net", "--cfg", lm_cfg, "--imdb", "linemod_ape_train", "--iters",
                           str(LINEMOD_STEPS), "--output", out], os.path.join(work, "linemod.log"), 600)
        check(rc == 0, f"train_net --cfg linemod_ape_pose.yml exited {rc}:\n{log[-3000:]}")
        with open(os.path.join(out, "train_timing.json")) as fh:
            timing = json.load(fh)
        launches["linemod_train_cli"] = timing["launches"]
        want = {"hough_vote": 4 * LINEMOD_STEPS, "conv3x3": 2 * LINEMOD_STEPS, "nms": 0}
        check(timing["launches"] == want, f"linemod: launches {timing['launches']}, want {want}")
        losses = _cli_losses(log, 1, LINEMOD_STEPS)
        check(all(np.isfinite(v) for v in losses.values()) and "loss_pose" in losses, f"linemod: losses {losses}")
        ms = {k: statistics.median(v[LINEMOD_WARMUP:]) for k, v in timing["ms"].items()}
        phase(15, f"train_net --cfg linemod_ape_pose.yml --imdb linemod_ape_train --iters {LINEMOD_STEPS} (2 classes, "
                  f"B=2, 640x480, bf16; {LINEMOD_FRAMES} frames, models/ape.ply binary): per step (median of steps "
                  f"{LINEMOD_WARMUP + 1}-{LINEMOD_STEPS}) {ms['step_stream']:.3f} ms stream, {ms['step']:.3f} ms host, "
                  f"data wait {ms['data_wait']:.3f} ms; step 1 losses {losses}; launches {timing['launches']}")
        snap = os.path.join(out, f"vgg16_fcn_color_linemod_ape_pose_iter_{LINEMOD_STEPS}.npz")
        ev = os.path.join(work, "linemod_eval")
        launches["linemod_eval"] = _eval_cli(["--cfg", lm_cfg, "--imdb", "linemod_ape_test", "--model", snap], ev,
                                             LINEMOD_FRAMES, "linemod_ape_pose.yml --imdb linemod_ape_test")
        with open(os.path.join(ev, "eval_timing.json")) as fh:
            thr = json.load(fh)["thresholds"]
        check(thr == {"ape": 0.1 * LINEMOD_DIAMETERS[0]}, f"linemod eval thresholds {thr}")
        phase(15, f"LINEMOD ape's evaluator threshold {thr['ape']:.6f} m = 0.1 x its diameter "
                  f"{LINEMOD_DIAMETERS[0] * 1000:.2f} mm; the whole phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        if old_root is None:
            os.environ.pop("POSECNN_DATA", None)
        else:
            os.environ["POSECNN_DATA"] = old_root
    return launches


def mesh_inputs(work: str, dev) -> dict:
    """The f32 mesh steps' inputs, written to <work>/mesh/: lov_color_2d.yml
    on the phase-15 tree (B=2, 640x480, 22 classes, float32, TF32 off), its
    first global host batch with its GT pose rows put at the detections of a
    training forward on the card (`gt_rows_at_detections`, as phase 14 (b)),
    and that forward's draws, recorded to be replayed. Returns the config
    file, the output directory and the one-process step on the card: its
    loss terms, the updated MESH_PARAMS and its launches; the step's own
    spread (run again from the seed weights) and the f32 trunk's conv5_3 at
    B=2 against one image at a time, which place the meshes' differences."""
    import torch

    from posecnn_torch.core import config as C
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.data.minibatch import rescale_points
    from posecnn_torch.engine import train as T
    from posecnn_torch.models.posecnn import posecnn_forward
    from posecnn_torch.ops import conv3x3, voting
    from tests.torch_parity import gt_rows_at_detections, lov_batch_cfg, port_lov_batches

    lov_root = os.path.join(work, "datasets", "LOV")
    cfg = lov_batch_cfg(lov_root)
    imdb = get_imdb("lov_train")
    model_cfg = dataclasses.replace(C.train_model_cfg(cfg, imdb.num_classes), compute_dtype=torch.float32)
    hp = C.train_hparams(cfg)
    weights = init_params_numpy(cfg.RNG_SEED, model_cfg)
    ext, sym = np.asarray(imdb._extents, np.float32), np.asarray(imdb._symmetry, np.float32)
    points = rescale_points(np.asarray(imdb._points_all, np.float32), ext, sym,
                            C.minibatch_cfg(cfg, imdb.num_classes).is_symmetric)
    consts = [torch.from_numpy(a).to(dev) for a in (points, sym, ext)]
    batch = port_lov_batches(lov_root, 1)[0]
    outs = []

    def forward(*a, **k):
        out = posecnn_forward(*a, **k)
        outs.append({n: out[n].detach().cpu() for n in ("rois", "rois_valid", "poses_init")})
        return out

    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.RNG_SEED)
    draws = T.Draws(gen, record=True)
    with torch.no_grad():
        T.compute_losses(make_model(model_cfg, weights, dev), model_cfg, hp, T.to_device(batch, dev), *consts, draws,
                         forward)
    batch["poses"] = gt_rows_at_detections(outs.pop(), batch["poses"])
    recorded = {k: v.cpu() for k, v in draws.recorded.items()}
    d = os.path.join(work, "mesh")
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "batch.npz"), **batch)
    np.savez(os.path.join(d, "consts.npz"), points=points, symmetry=sym, extents=ext)
    torch.save(recorded, os.path.join(d, "draws.pt"))
    with open(os.path.join(d, "cfg.json"), "w") as f:
        json.dump({"model_cfg": {k: v for k, v in dataclasses.asdict(model_cfg).items() if k != "compute_dtype"},
                   "hp": dataclasses.asdict(hp), "seed": cfg.RNG_SEED}, f)
    step = T.make_train_step(model_cfg, hp, *consts)
    runs = []
    for _ in range(2):  # twice: the one-process step's own spread
        state = T.create_train_state(make_model(model_cfg, weights, dev), hp)
        voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = 0
        got = {k: float(v) for k, v in step(state, T.to_device(batch, dev), T.Draws(replay=recorded)).items()}
        runs.append({k: p.detach().cpu() for k, p in state.model.named_parameters() if k in MESH_PARAMS})
    params = runs[0]
    spread = {k: float((runs[1][k] - v).abs().max()) / float(v.abs().max()) for k, v in params.items()}
    # cuDNN's f32 trunk on the batch's two images at once and one at a time
    with torch.no_grad():
        x = T.to_device(batch, dev)["data"].float() - torch.tensor(hp.pixel_means, device=dev).reshape(1, 1, 1, 3)
        both = state.model.trunk(x, compute_dtype=torch.float32)["conv5_3"]
        one_at_a_time = torch.cat([state.model.trunk(x[i:i + 1], compute_dtype=torch.float32)["conv5_3"]
                                   for i in range(x.shape[0])])
        trunk_gap = float((both - one_at_a_time).abs().max() / both.abs().max())
    return {"losses": got, "params": params, "n_gt": int((batch["poses"][:, 1] > 0).sum()), "dir": d,
            "launches": {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES},
            "spread": spread, "trunk_gap": trunk_gap}


def mesh_rank(d: str) -> int:
    """One of the two ranks of phase 16 (b)'s f32 steps (`python3
    chip_smoke.py mesh-rank <dir>`, started by `parallel.launch.run_ranks`
    with gloo): the step at mesh (2,1) and then at (1,2) (fc6 and fc7 split
    at their full width) on the inputs `mesh_inputs` wrote, the recorded
    draws replayed (each rank takes its rows of them). Rank 0 writes the
    gathered MESH_PARAMS and the loss terms of each; every rank prints one
    line 'mesh-rank {json}': its launches, stream ms and peak MiB of each
    step, and the ms of one all-reduce of every gradient over the data
    group (the (2,1) step's collective)."""
    import torch

    sys.path.insert(0, ROOT)
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.engine import train as T
    from posecnn_torch.engine.test import set_float32_precision
    from posecnn_torch.ops import conv3x3, nms, voting
    from posecnn_torch.parallel import launch
    from posecnn_torch.parallel import mesh as M

    dev = torch.device("cuda", 0)
    world = launch.initialize(device=dev)
    try:
        set_float32_precision()
        with open(os.path.join(d, "cfg.json")) as f:
            spec = json.load(f)
        model_cfg = PoseCNNConfig(compute_dtype=torch.float32, **spec["model_cfg"])
        hp = T.TrainHParams(**{k: tuple(v) if isinstance(v, list) else v for k, v in spec["hp"].items()})
        weights = init_params_numpy(spec["seed"], model_cfg)
        with np.load(os.path.join(d, "batch.npz")) as z:
            batch = {k: z[k] for k in z.files}
        with np.load(os.path.join(d, "consts.npz")) as z:
            consts = [torch.from_numpy(z[k]).to(dev) for k in ("points", "symmetry", "extents")]
        recorded = torch.load(os.path.join(d, "draws.pt"))
        rank = torch.distributed.get_rank()
        record = {"rank": rank, "backend": torch.distributed.get_backend()}
        for data, model in ((2, 1), (1, 2)):
            mesh = M.make_mesh(M.MeshSpec(data=data, model=model), world)
            state = T.create_train_state(M.shard_model(make_model(model_cfg, weights, dev), mesh), hp)
            step = T.make_train_step(model_cfg, hp, *consts, mesh=mesh)
            local = T.to_device(M.shard_batch(mesh, batch), dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = nms.NMS_LAUNCHES = 0
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            got = {k: float(v) for k, v in step(state, local, T.Draws(replay=recorded)).items()}
            e1.record()
            e1.synchronize()
            key = f"{data}x{model}"
            record[key] = {"launches": {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES,
                                        "nms": nms.NMS_LAUNCHES},
                           "stream_ms": e0.elapsed_time(e1), "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                           "split": [n for n, p in state.model.named_parameters() if M.tp_mesh(p) is not None]}
            whole = {k: M.gather_rows(p).cpu() for k, p in state.model.named_parameters() if k in MESH_PARAMS}
            if data > 1:
                # the step's collective alone: every gradient, flattened, summed
                flat = torch.cat([p.grad.reshape(-1) for p in state.model.parameters()])
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    mesh.data_sum(flat)
                    torch.cuda.synchronize()
                    record[key]["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
                record[key]["allreduce_mib"] = flat.numel() * 4 / 2**20
                del flat
            if rank == 0:
                torch.save({"losses": got, "params": whole}, os.path.join(d, f"mesh_{key}.pt"))
            del state, step, local
            torch.cuda.empty_cache()
        print("mesh-rank " + json.dumps(record), flush=True)
        return 0
    finally:
        launch.shutdown()


def mesh_phase(work: str, dev, smi: str) -> dict:
    """Phase 16: more than one rank on the one card. (a) NCCL at world size
    1 in this process: an all-reduce and an all-gather held to their
    values, and the all-reduce of NCCL_FLOATS timed. (b) `train_net --cfg
    lov_color_2d.yml --imdb lov_train` on phase 15's YCB-Video tree as two
    ranks on cuda:0 over gloo (`parallel.launch.run_ranks`,
    POSECNN_BACKEND=gloo): MESH_STEPS steps at mesh (2,1), one image a rank,
    4 hough_vote and 2 conv3x3 launches a step on each rank, every rank at
    the same end step, finite losses; then the f32 steps of `mesh_rank` at
    (2,1) and (1,2) against the one-process step on the card on the same
    batch and draws (`mesh_inputs`): loss terms within MESH_LOSS_LIMIT
    relative, MESH_PARAMS within their limits of their largest magnitude
    (no more than MESH_FC6_ROWS of fc6's rows past 1e-5), loss_pose > 0. (c) `entry.dryrun_multichip(2)` on the card.
    Returns the launches of each path (rank 0's; each rank's is checked)."""
    import torch
    import torch.distributed as dist

    from posecnn_torch.entry import dryrun_multichip
    from posecnn_torch.parallel import launch

    t_phase = time.perf_counter()
    launches = {}
    # (a) NCCL at world size 1
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{launch.free_port()}", world_size=1, rank=0,
                            device_id=dev)
    try:
        x = torch.arange(1024, dtype=torch.float32, device=dev)
        y = x.clone()
        dist.all_reduce(y)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x)
        torch.cuda.synchronize()
        check(torch.equal(y, x) and torch.equal(parts[0], x), "NCCL at world size 1: all-reduce or all-gather wrong")
        big = torch.ones(NCCL_FLOATS, device=dev)
        dist.all_reduce(big)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            dist.all_reduce(big)
        e1.record()
        e1.synchronize()
        nccl_ms = e0.elapsed_time(e1) / 5
        check(bool((big == 1).all()), "NCCL at world size 1: the all-reduce changed its tensor")
        del big
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    phase(16, f"NCCL at world size 1 ({torch.cuda.nccl.version()}): all-reduce and all-gather of 1024 floats "
              f"equal to their inputs; all-reduce of {NCCL_FLOATS} floats ({NCCL_FLOATS * 4 / 2**20:.0f} MiB) "
              f"{nccl_ms:.3f} ms (events, mean of 5) [{smi}]")

    # (b) lov_color_2d.yml at two ranks on the one card
    root = os.path.join(work, "datasets")
    cfg_file = os.path.join(work, "lov_color_2d_tree.yml")
    out = os.path.join(work, "mesh_train")
    logs = [os.path.join(work, f"mesh_train_rank{r}.log") for r in range(2)]
    t0 = time.perf_counter()
    rcs = launch.run_ranks(["-m", "posecnn_torch.train_net", "--cfg", cfg_file, "--imdb", "lov_train", "--iters",
                            str(MESH_STEPS), "--output", out, "--device", "cuda:0"], 2, backend="gloo",
                           env={**os.environ, "POSECNN_DATA": root}, logs=logs, timeout=300, cwd=ROOT)
    wall = time.perf_counter() - t0
    texts = [open(p).read() for p in logs]
    check(rcs == [0, 0], f"train_net at two ranks exited {rcs}:\n" + "\n".join(t[-3000:] for t in texts))
    CLI_RUNS.append({"args": f"posecnn_torch.train_net --cfg lov_color_2d_tree.yml (2 ranks, gloo)",
                     "where": "two processes", "wall_s": wall, "first_step_s": None})
    with open(os.path.join(out, "train_timing.json")) as fh:
        timing = json.load(fh)
    # a rank's step: one image, so 2 hough_vote (coarse, refine) and 2 conv3x3
    # (conv1_2's forward and dx): 4 and 4 a step over the two ranks
    want = {"hough_vote": 2 * MESH_STEPS, "conv3x3": 2 * MESH_STEPS, "nms": 0}
    ranks = timing["by_rank"]
    check(timing["world_size"] == 2 and timing["mesh"] == {"data": 2, "model": 1}
          and all(r["launches"] == want and r["end_step"] == MESH_STEPS for r in ranks),
          f"train_net at two ranks: {[(r['end_step'], r['launches']) for r in ranks]}, want {want} a rank")
    launches["mesh_train_cli"] = ranks[0]["launches"]
    losses = _cli_losses(texts[0], 1, MESH_STEPS)
    snap = os.path.join(out, f"vgg16_fcn_color_single_frame_2d_pose_add_iter_{MESH_STEPS}.npz")
    with np.load(snap) as z:
        finite = all(np.isfinite(z[k]).all() for k in z.files)
    check(all(np.isfinite(v) for v in losses.values()) and finite and texts[1].count("iter ") == 0,
          f"two ranks: step-1 losses {losses}, snapshot finite {finite}, rank 1 logged {texts[1].count('iter ')} "
          f"step lines (rank 0 alone logs)")
    stream = [statistics.median(r["ms"]["step_stream"][1:]) for r in ranks]
    host = [statistics.median(r["ms"]["step"][1:]) for r in ranks]
    # each rank makes the whole global batch and keeps its image: the host
    # work of 2 batches a step on this host
    wait = [statistics.median(r["ms"]["data_wait"][1:]) for r in ranks]
    phase(16, f"train_net --cfg lov_color_2d.yml --imdb lov_train --iters {MESH_STEPS} as 2 ranks on cuda:0 over "
              f"gloo, mesh (2,1), one 640x480 image a rank, bf16 ({wall:.1f} s with the ranks' start): per step "
              f"(median of steps 2-{MESH_STEPS}) stream ms by rank {[round(v, 3) for v in stream]}, host ms "
              f"{[round(v, 3) for v in host]}, data wait ms {[round(v, 3) for v in wait]} (each rank makes the "
              f"global batch); peak MiB by rank {[round(r['peak_memory_mib'], 1) for r in ranks]}; "
              f"launches by rank {[r['launches'] for r in ranks]} (a rank's step: 2 hough_vote, 2 conv3x3); step 1 "
              f"losses {losses}; the step-{MESH_STEPS} snapshot (rank 0's, gathered) finite [{smi}]")

    # the f32 steps at (2,1) and (1,2) against the one-process step
    t0 = time.perf_counter()
    old_root = os.environ.get("POSECNN_DATA")
    os.environ["POSECNN_DATA"] = root
    try:
        one = mesh_inputs(work, dev)
    finally:
        if old_root is None:
            os.environ.pop("POSECNN_DATA", None)
        else:
            os.environ["POSECNN_DATA"] = old_root
    torch.cuda.empty_cache()
    logs = [os.path.join(work, f"mesh_rank{r}.log") for r in range(2)]
    rcs = launch.run_ranks([os.path.join(ROOT, "chip_smoke.py"), "mesh-rank", one["dir"]], 2, backend="gloo",
                           logs=logs, timeout=300, cwd=ROOT)
    texts = [open(p).read() for p in logs]
    check(rcs == [0, 0], f"the f32 mesh steps exited {rcs}:\n" + "\n".join(t[-3000:] for t in texts))
    recs = [json.loads(next(ln for ln in t.splitlines() if ln.startswith("mesh-rank "))[len("mesh-rank "):])
            for t in texts]
    for key, label in (("2x1", "(2,1)"), ("1x2", "(1,2)")):
        got = torch.load(os.path.join(one["dir"], f"mesh_{key}.pt"))
        ref = one["losses"]
        rel = {k: _rel(got["losses"][k], ref[k]) for k in ref if k.startswith("loss") or k == "grad_norm"}
        diff = {k: (got["params"][k] - one["params"][k]).abs() / one["params"][k].abs().max() for k in MESH_PARAMS}
        perr = {k: float(v.max()) for k, v in diff.items()}
        fc6_rows = int((diff["fc6.weight"] > 1e-5).any(dim=1).sum())
        per_rank = [r[key]["launches"] for r in recs]
        check(all(v <= MESH_LOSS_LIMIT for v in rel.values()) and all(perr[k] <= lim for k, lim in MESH_PARAMS.items())
              and fc6_rows <= MESH_FC6_ROWS and got["losses"]["loss_pose"] > 0 and ref["loss_pose"] > 0,
              f"f32 step at {label} against one process: relative {rel} (limit {MESH_LOSS_LIMIT}), parameters "
              f"{perr} (limits {MESH_PARAMS}), fc6 rows over 1e-5 {fc6_rows} (limit {MESH_FC6_ROWS}); loss_pose "
              f"{got['losses']['loss_pose']} vs {ref['loss_pose']}")
        check(all(p == {"hough_vote": 4 // (2 if key == "2x1" else 1), "conv3x3": 0, "nms": 0} for p in per_rank),
              f"f32 step at {label}: launches by rank {per_rank}")
        launches[f"mesh_f32_{key}"] = per_rank[0]
        extra = (f"; the gradients' all-reduce ({recs[0][key]['allreduce_mib']:.0f} MiB over gloo, CUDA tensors) "
                 f"ms by rank {[round(r[key]['allreduce_ms'], 3) for r in recs]}" if key == "2x1" else
                 f"; split {recs[0][key]['split']}")
        phase(16, f"f32 step at {label} as 2 ranks over gloo on cuda:0 (lov_color_2d.yml's first global batch, B=2 "
                  f"640x480, {one['n_gt']} GT rows at the detections, the draws replayed) against the one-process "
                  f"step on the card: " + "; ".join(f"{k} {got['losses'][k]:.6g} vs {ref[k]:.6g}, rel {rel[k]:.3g}"
                                                     for k in rel)
                  + " (limit " + f"{MESH_LOSS_LIMIT}); " + "; ".join(f"{k} {v:.3g} of its largest magnitude (limit "
                                                                    f"{MESH_PARAMS[k]})" for k, v in perr.items())
                  + f"; fc6 rows over 1e-5: {fc6_rows} of {diff['fc6.weight'].shape[0]} (limit {MESH_FC6_ROWS}); "
                  f"stream ms by rank "
                  f"{[round(r[key]['stream_ms'], 3) for r in recs]} (the one-step call, first use); peak MiB by rank "
                  f"{[round(r[key]['peak_mib'], 1) for r in recs]}; launches by rank {per_rank}{extra} [{smi}]")
    phase(16, f"the f32 mesh steps took {time.perf_counter() - t0:.1f} s (the inputs, the one-process step and the "
              f"ranks' start included); the one-process step's launches {one['launches']}; run twice, its "
              f"parameters part by " + ", ".join(f"{k} {v:.3g}" for k, v in one["spread"].items())
              + f" of their largest magnitude; cuDNN's f32 trunk (the step's weights, the batch's images) gives "
              f"conv5_3 {one['trunk_gap']:.3g} of its largest magnitude apart at B=2 and at B=1 + 1 [{smi}]")

    # (c) the multichip dry run on the card
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device="cuda")
    check(dry["metrics"]["loss_pose"] > 0 and dry["mesh"] == {"data": 1, "model": 2}, f"dryrun_multichip(2): {dry}")
    phase(16, f"dryrun_multichip(2) on the card ({dry['backend']}, {dry['device']}; {time.perf_counter() - t0:.1f} "
              f"s): mesh {dry['mesh']}, split {dry['split']}, metrics {dry['metrics']}; the whole phase "
              f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
    return launches


def _eval_cli(args: list, out: str, n: int, what: str) -> dict:
    """`test_net` with `args` and --output `out` over n frames, its
    detections finite, its summary in range and its launches 2 hough_vote
    and 1 conv3x3 a frame; prints its line of phase 15. Returns the
    launches."""
    rc, log = run_cli(["posecnn_torch.test_net", *args, "--output", out], out + ".log", 600)
    check(rc == 0, f"test_net --cfg {what} exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(out, "eval_summary.json")) as fh:
        summary = json.load(fh)
    with open(os.path.join(out, "eval_timing.json")) as fh:
        timing = json.load(fh)
    with np.load(os.path.join(out, "detections.npz")) as d:
        dets = {k: d[k] for k in d.files}
    want = {"hough_vote": 2 * n, "conv3x3": n, "nms": 0}
    check(timing["frames"] == n and timing["launches"] == want,
          f"{what}: {timing['frames']} frames, launches {timing['launches']}, want {want}")
    check(all(np.isfinite(v).all() and v.shape[1:] == (7,) for v in dets.values()), f"{what}: detections")
    check(0 <= summary["mean_iou"] <= 1 and 0 <= summary["adds_auc"] <= 1, f"{what}: summary {summary}")
    ev_ms = {k: statistics.median(v[EVAL_WARMUP:]) for k, v in timing["ms"].items()}
    phase(15, f"test_net --cfg {what} --model <the snapshot>: {n} frames, "
              f"{sum(len(v) for k, v in dets.items() if k.endswith('_rois'))} detections, mean IoU "
              f"{summary['mean_iou']:.4f}, ADD-S AUC {summary['adds_auc']:.4f} (a few steps from seed weights: shows "
              f"the scorer runs); per frame (median of frames {EVAL_WARMUP + 1}-{n}) "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ev_ms.items())
              + f"; peak {timing['peak_memory_mib']:.1f} MiB; launches {timing['launches']}")
    return timing["launches"]


def toy_phase3(kernels: dict, w_t, dev) -> None:
    """Phase 3 at the toy path's shapes (experiments/cfgs/toy_pose.yml):
    conv3x3 at conv1_2, B=2, 96x128, 64->64, in the path's mode below 128
    rows (the zero-bias sum: the JAX trunk's plain bf16 conv2d there, its
    f32 bias and ReLU after the kernel) and dx, within 1 bf16 ulp of the
    plain version, timed from CUDA graphs back to back and as single calls
    beside cuDNN's bf16 conv; and hough_vote's coarse (the 24x32 grid at stride 4, 768 centres)
    and refine passes at S=8, P=1024 on the ground truth of the first 8
    toy_train frames, votes equal to the plain version's. Adds `toy_*`
    numbers to each kernel's entry of `kernels`."""
    import torch
    import torch.nn.functional as F

    from posecnn_torch.ops import conv3x3, voting
    from tests.torch_parity import bf16_ulp_excess, toy_vote_inputs

    rng = np.random.RandomState(2)
    B, H, W = 2, 96, 128
    zeros = torch.zeros(64, device=dev)
    for label in ("forward (the zero-bias sum; the bias and ReLU follow in f32)", "dx"):
        dx = label == "dx"
        x = torch.from_numpy(rng.randn(B, H, W, 64).astype(np.float32)).to(dev)
        x = (x if dx else torch.relu(x)).to(torch.bfloat16)
        w_c = conv3x3.flip_transpose(w_t) if dx else w_t
        kern = functools.partial(conv3x3._launch, x, conv3x3.pack_weights(w_t, dgrad=dx), None, 0)
        plain = functools.partial(conv3x3.conv3x3_plain, x, w_c, zeros, False)
        y_k, y_p = kern(), plain()
        torch.cuda.synchronize()
        ulps = bf16_ulp_excess(y_k, y_p)
        check(ulps <= 1.0, f"conv3x3 toy {label}: kernel {ulps:.3g} bf16 ulps from the plain version")
        err = (y_k.float() - y_p.float()).abs().max().item()
        w_l = w_c.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = lambda: F.conv2d(x.permute(0, 3, 1, 2), w_l, None, padding=1)  # noqa: E731
        # a call's host work outlasts the kernel at this size: CUDA graphs
        k_ms = statistics.median([graph_ms([kern] * 10) for _ in range(2)])
        l_ms = statistics.median([graph_ms([lib] * 10) for _ in range(2)])
        p_ms = median_ms(plain, reps=5, inner=2)
        k_one, l_one = single_ms(kern), single_ms(lib)
        b_ms, b_by = conv_bound(B, H, W, 64, 64)
        key = "toy_dx" if dx else "toy"
        kernels["conv3x3"].update({f"{key}_ms": k_ms, f"{key}_plain_ms": p_ms, f"{key}_library_ms": l_ms,
                                   f"{key}_bound_ms": b_ms, f"{key}_bound_by": b_by, f"{key}_max_abs_err": err,
                                   f"{key}_ms_single": k_one, f"{key}_library_ms_single": l_one})
        phase(3, f"conv3x3 toy {label}, B=2, 96x128, 64->64: {ulps:.3g} bf16 ulps at most (limit 1), max|err| "
                 f"{err:.3g}; kernel {k_ms * 1e3:.2f} us back to back (CUDA graph of 10 calls), {k_one * 1e3:.2f} "
                 f"single; cuDNN bf16 {l_ms * 1e3:.2f} / {l_one * 1e3:.2f} us; plain {p_ms * 1e3:.1f} us; bound "
                 f"{b_ms * 1e3:.2f} us ({b_by})")
    ins = [toy_vote_inputs(i, dev) for i in range(8)]
    for pass_name, key in (("coarse", "coarse"), ("refine", "window")):
        r = {k: [] for k in ("ms", "single", "plain", "err", "bytes", "inside")}
        for d in ins:
            smp, cen, gw = d["samples"], d[key], d["grid_w"] if key == "coarse" else 0
            call = functools.partial(voting.accumulate_votes, smp, cen, grid_w=gw)
            v_k, d_k = call()
            v_p, d_p = voting.accumulate_votes_plain(smp, cen)
            torch.cuda.synchronize()
            check(torch.equal(v_k, v_p), f"hough_vote toy {pass_name}: votes differ from the plain version")
            torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-4)
            r["err"].append(max((v_k - v_p).abs().max().item(), (d_k - d_p).abs().max().item()))
            r["ms"].append(graph_ms([call] * 10))
            r["single"].append(single_ms(call))
            r["plain"].append(median_ms(lambda: voting.accumulate_votes_plain(smp, cen), reps=3, inner=1))
            r["inside"].append(vote_pairs(smp, cen)[0])
            r["bytes"].append((smp.numel() + cen.numel() + 2 * smp.shape[0] * cen.shape[2]) * 4)
        mean = {k: statistics.fmean(v) for k, v in r.items() if k != "err"}
        b_ms, b_by = vote_bound(mean["bytes"], mean["inside"])
        pre = "toy" if pass_name == "coarse" else "toy_refine"
        kernels["hough_vote"].update({f"{pre}_ms": mean["ms"], f"{pre}_plain_ms": mean["plain"],
                                      f"{pre}_bound_ms": b_ms, f"{pre}_bound_by": b_by,
                                      f"{pre}_ms_single": mean["single"], f"{pre}_max_abs_err": max(r["err"])})
        phase(3, f"hough_vote toy {pass_name} (the first 8 toy_train frames' ground truth, S=8, P=1024, "
                 f"{ins[0][key].shape[2]} centres{' a slot' if key == 'window' else ''}; valid samples "
                 f"{[int((d['samples'][:, 7] > 0).sum()) for d in ins]}): votes equal, dsum max|err| "
                 f"{max(r['err']):.3g}; kernel {mean['ms'] * 1e3:.2f} us back to back (CUDA graph of 10 calls; "
                 f"cases {[round(x * 1e3, 2) for x in r['ms']]}), {mean['single'] * 1e3:.2f} single; plain "
                 f"{mean['plain'] * 1e3:.1f} us; bound {b_ms * 1e3:.3f} us ({b_by})")
    del ins


def _start_time(pid: int):
    """The start time of process `pid` (from /proc; None when it is gone):
    with the pid, it names one process even if the pid is reused later."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[19])
    except (OSError, ValueError, IndexError):
        return None


def _children(pid: int) -> list:
    """The pids whose parent is `pid` (from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.append(int(d))
            except (OSError, ValueError, IndexError):
                pass
    return out


def _supervised_run(work: str) -> dict:
    """Phase 17 (e): `python -m posecnn_torch.tools.supervise_train` around
    `train_net --cfg toy_pose.yml --iters SUP_STEPS` (its own process, the
    child its own session). Once the metrics file has its step-SUP_PAUSE_AT
    row the child is stopped (SIGSTOP); the supervisor's stall check
    (--stall-sec SUP_STALL_S, polled every 10 s) sends SIGTERM, which the
    child takes once it is continued (SIGCONT on the supervisor's stall
    line): it snapshots the step reached and exits, and the supervisor
    relaunches it with --resume to the end. Returns the record."""
    import threading

    from posecnn_torch.core import config as C

    cfg = os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml")
    prefix = C.cfg_from_file(cfg).TRAIN.SNAPSHOT_PREFIX
    out, child_log = os.path.join(work, "supervised"), os.path.join(work, "supervised_child.log")
    csv_path = os.path.join(out, "train_metrics.csv")
    cmd = [sys.executable, "-m", "posecnn_torch.tools.supervise_train", "--cfg", cfg, "--imdb", "toy_train",
           "--iters", str(SUP_STEPS), "--output", out, "--stall-sec", str(SUP_STALL_S), "--warmup-sec", "300",
           "--grace-sec", "120", "--settle-sec", "5", "--log", child_log]
    lines, t0 = [], time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")), daemon=True)
    reader.start()
    child = child_start = t_stop = t_term = None
    try:
        while proc.poll() is None and time.perf_counter() - t0 < 400:
            if t_stop is None:
                try:
                    with open(csv_path) as f:
                        rows = [ln.split(",")[0] for ln in f.read().splitlines()[1:]]
                except OSError:
                    rows = []
                if any(r.isdigit() and int(r) >= SUP_PAUSE_AT for r in rows):
                    kids = _children(proc.pid)
                    check(len(kids) == 1, f"supervise_train: children {kids}")
                    child = kids[0]
                    child_start = _start_time(child)
                    os.kill(child, signal.SIGSTOP)
                    t_stop = time.perf_counter()
            elif t_term is None and any("stall at iter" in ln for ln in lines):
                t_term = time.perf_counter()
                os.kill(child, signal.SIGCONT)
            time.sleep(0.05)
        rc = proc.wait(timeout=30)
    finally:
        # cut short: end the supervisor's children (each its own session),
        # the one paused here too if it is still that process, then it
        kids = _children(proc.pid) if proc.poll() is None else []
        if child is not None and _start_time(child) == child_start:
            kids.append(child)
        for pid in kids:
            for sig in (signal.SIGCONT, signal.SIGKILL):
                try:
                    os.killpg(pid, sig)
                except (ProcessLookupError, PermissionError):
                    pass
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    wall = time.perf_counter() - t0
    text = "".join(lines)
    with open(child_log) as f:
        clog = f.read()
    check(rc == 0 and t_stop is not None and t_term is not None,
          f"supervise_train exited {rc} (paused: {t_stop is not None}, stall seen: {t_term is not None}):\n"
          f"{text[-3000:]}\n{clog[-3000:]}")
    check(text.count("stall at iter") == 1 and text.count(": SIGTERM") == 1 and "complete at iter" in text
          and re.search(r"stall handled: (clean|snapshot-kill)", text) is not None,
          f"supervise_train's record:\n{text[-3000:]}")
    signalled = re.findall(r"signal received: snapshotting at iteration (\d+)", clog)
    resumed = re.findall(r"resumed from \S+_iter_(\d+)\.npz at iteration (\d+)", clog)
    check(len(signalled) == 1 and len(resumed) == 1 and resumed[0][0] == signalled[0]
          and os.path.exists(os.path.join(out, f"{prefix}_iter_{SUP_STEPS}.npz")),
          f"the child's snapshots and resume: signalled {signalled}, resumed {resumed}\n{clog[-3000:]}")
    runs = re.findall(r"done at iteration (\d+); launches hough_vote (\d+) conv3x3 (\d+) nms (\d+)", clog)
    check(len(runs) == 2 and int(runs[1][0]) == SUP_STEPS, f"the child's runs {runs}")
    return {"wall_s": wall, "stall_s": t_term - t_stop, "signalled_at": int(signalled[0]),
            "launches": {k: sum(int(r[i]) for r in runs) for i, k in enumerate(("hough_vote", "conv3x3", "nms"), 1)},
            "lines": [ln.strip() for ln in lines if ln.startswith("[supervisor]")]}


def _vis_train_run(work: str) -> dict:
    """Phase 17 (f): `train_net --cfg toy_pose.yml --imdb toy_train --iters
    VIS_TRAIN_STEPS --vis`. The Solver's hook is called once a step with
    the host batch (recorded here); it draws the first 8 batches, one PNG
    an image, named iter<step>_im<i>.png. Each PNG decodes to the batch's
    image size and equals the visualizer run again on the recorded batch.
    Returns the run's launches."""
    import copy

    from posecnn_torch.engine import visualize as VIS
    from posecnn_torch.utils.png import IMREAD_UNCHANGED, imread

    records, hook_ms = [], []
    orig = VIS.MinibatchVisualizer.__call__

    def recording(self, iteration, batch):
        records.append((copy.copy(self), iteration, {k: np.array(batch[k]) for k in
                                                     ("data", "gt_label_2d", "meta_data", "poses", "gt_centers")
                                                     if k in batch}))
        t0 = time.perf_counter()
        orig(self, iteration, batch)
        hook_ms.append((time.perf_counter() - t0) * 1e3)

    cfg = os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml")
    out = os.path.join(work, "vis_train")
    VIS.MinibatchVisualizer.__call__ = recording
    try:
        rc, log = run_cli(["posecnn_torch.train_net", "--cfg", cfg, "--imdb", "toy_train", "--iters",
                           str(VIS_TRAIN_STEPS), "--vis", "--output", out], os.path.join(work, "vis_train.log"), 600)
    finally:
        VIS.MinibatchVisualizer.__call__ = orig
    check(rc == 0, f"train_net --vis exited {rc}:\n{log[-3000:]}")
    n = launches_of(log)
    check(n == {"step": VIS_TRAIN_STEPS, "hough_vote": 4 * VIS_TRAIN_STEPS, "conv3x3": 2 * VIS_TRAIN_STEPS, "nms": 0},
          f"train_net --vis launches {n}")
    check([it for _, it, _ in records] == list(range(1, VIS_TRAIN_STEPS + 1)), f"vis hook calls {len(records)}")
    drawn = records[:records[0][0].max_batches]
    B = drawn[0][2]["data"].shape[0]
    names = sorted(os.listdir(os.path.join(out, "vis_minibatch")))
    check(len(drawn) == 8 and names == sorted(f"iter{it:06d}_im{i}.png" for _, it, _ in drawn for i in range(B)),
          f"vis_minibatch holds {names}")
    host = os.path.join(work, "vis_train_host")
    for vis, it, batch in drawn:
        again = copy.copy(vis)
        again.out_dir, again._seen = os.path.join(host, "vis_minibatch"), 0
        os.makedirs(again.out_dir, exist_ok=True)
        orig(again, it, batch)
        for i in range(B):
            name = f"iter{it:06d}_im{i}.png"
            png = imread(os.path.join(out, "vis_minibatch", name), IMREAD_UNCHANGED)
            check(png.shape == batch["data"].shape[1:3] + (3,) and png.dtype == np.uint8, f"{name}: {png.shape}")
            check(np.array_equal(png, imread(os.path.join(again.out_dir, name), IMREAD_UNCHANGED)),
                  f"{name} differs from the host redraw")
    phase(17, f"(f) train_net --cfg toy_pose.yml --imdb toy_train --iters {VIS_TRAIN_STEPS} --vis: {len(names)} PNGs "
              f"of {B} images x {len(drawn)} batches ({png.shape[1]}x{png.shape[0]}), each equal to the visualizer run "
              f"again on its recorded host batch; the hook takes {statistics.median(hook_ms[:len(drawn)]):.3f} ms a "
              f"drawn batch (median), {statistics.median(hook_ms[len(drawn):]):.4f} ms after; launches {n}")
    return {k: n[k] for k in ("hough_vote", "conv3x3", "nms")}


def _roi_pool_timing(dev) -> None:
    """Phase 17 (g): phase 6's flagship inference (`entry`'s seed-0 model,
    `make_inference_fn`, phase 6's first frame) with its two
    `roi_pool_batched` calls recorded (conv5_3 and conv4_3 with the frame's
    rois); on those inputs the doubling-table
    forward and the masked max it replaced (`tests/torch_parity.py:
    roi_pool_masked_max`) are held equal and timed in turn (new, old, old,
    new; ROI_REPS back-to-back calls each, CUDA events, inference mode)."""
    import torch

    from posecnn_torch.config import PIXEL_MEANS, flagship_cfg
    from posecnn_torch.engine.test import make_inference_fn
    from posecnn_torch.entry import entry
    from posecnn_torch.models import posecnn as PM
    from posecnn_torch.ops.roi_pool import roi_pool_batched
    from posecnn_torch.utils.meta import build_meta_data
    from tests.torch_parity import roi_pool_masked_max

    _, (model, _, _, extents) = entry(dev)
    infer = make_inference_fn(flagship_cfg(is_train=False), PIXEL_MEANS, dev)
    with np.load(os.path.join(FRAMES_DIR, sorted(os.listdir(FRAMES_DIR))[0])) as f:
        color = torch.from_numpy(np.ascontiguousarray(f["color"][None])).to(dev)
        meta = torch.from_numpy(build_meta_data(f["intrinsic_matrix"])[None]).to(dev)
    calls = []

    def recording(feat, rois, pooled, scale):
        calls.append((feat.clone(), rois.clone(), pooled, scale))
        return roi_pool_batched(feat, rois, pooled, scale)

    PM.roi_pool_batched = recording
    try:
        infer(model, color, meta, extents)
    finally:
        PM.roi_pool_batched = roi_pool_batched
    del model
    check(len(calls) == 2, f"roi_pool_batched called {len(calls)} times by the flagship inference")

    def timed(f, args):
        with torch.inference_mode():
            for _ in range(3):
                f(*args)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(ROI_REPS):
                f(*args)
            e1.record()
            e1.synchronize()
        return e0.elapsed_time(e1) / ROI_REPS

    parts = []
    for args in calls:
        with torch.inference_mode():
            check(torch.equal(roi_pool_batched(*args), roi_pool_masked_max(*args)),
                  "the doubling-table forward differs from the masked max")
        t = {"new": [], "old": []}
        for which in ("new", "old", "old", "new"):
            t[which].append(timed(roi_pool_batched if which == "new" else roi_pool_masked_max, args))
        feat = args[0]
        parts.append(f"{tuple(feat.shape)} {str(feat.dtype)[6:]} at 1/{round(1 / args[3])}: doubling table "
                     f"{t['new'][0]:.4f} / {t['new'][1]:.4f} ms, masked max {t['old'][0]:.4f} / {t['old'][1]:.4f} ms")
    phase(17, f"(g) roi_pool_batched's forward on the flagship inference's inputs ({calls[0][1].shape[1]} rois), "
              f"equal to the masked max; a call, back to back: " + "; ".join(parts))


def cli_surface_phase(work: str, dev, seed0: str) -> dict:
    """Phase 17: the rest of the JAX CLIs' surface. (a) ResNet-50 at full
    width: `train_net --cfg rgbd_scene_single_color_fcn8.yml --network
    resnet50 --imdb lov_syn_val_v4 --iters R50_STEPS` (an FCN8VGG cfg:
    --network resnet50 takes over, as in the JAX CLI; B=2, 640x480, bf16;
    stream ms a step, data wait, peak memory, losses at steps 1 and 20, no
    kernel launched: ResNet-50 runs cuDNN throughout), `test_net` with the
    same flags on its snapshot (ms a frame, mean IoU), and the float32
    forward (TF32 off) against the JAX golden (`check_resnet50_golden`:
    score within 1e-4 of its largest magnitude, labels equal outside
    ties). (b) `test_net --model <seed-0 snapshot> --max_frames VIS_FRAMES
    --vis`: one 480x640x3 PNG a frame, each equal to the port's visualizer
    called again on the host on the outputs it was given (recorded in this
    process), the ms a frame it adds. (c) `tools.diag_rot` on that snapshot
    (DIAG_FRAMES frames of lov_syn_val_v4, both arms): the report, each
    arm's vote launches (2 a frame), the wall seconds. (d)
    `tools.isolate_pose --iters ISO_STEPS --report_every ISO_REPORT
    --frames ISO_FRAMES` on the YCB-Video tree of phase 15 (POSECNN_DATA at
    it for this part): the step ms, the evaluations, finite losses. (e)
    `tools.supervise_train` around the toy run, one stall, one SIGTERM,
    one snapshot and one --resume to the end (`_supervised_run`). (f)
    `train_net --vis` on the toy cfg (`_vis_train_run`). (g) the RoI
    pool's forward, the doubling table against the masked max it
    replaced, on the flagship inference's inputs (`_roi_pool_timing`).
    Returns each path's launches."""
    from posecnn_torch.data.lov_syn import LovSynVal
    from posecnn_torch.engine import visualize as VIS
    from posecnn_torch.utils.png import IMREAD_UNCHANGED, imread
    from tests.torch_parity import check_resnet50_golden, resnet50_on_golden, write_lov_tree

    launches = {}
    # (a) ResNet-50
    cfg = os.path.join(ROOT, "experiments", "cfgs", "rgbd_scene_single_color_fcn8.yml")
    out = os.path.join(work, "resnet50")
    rc, log = run_cli(["posecnn_torch.train_net", "--cfg", cfg, "--network", "resnet50", "--imdb", "lov_syn_val_v4",
                       "--iters", str(R50_STEPS), "--output", out], os.path.join(work, "resnet50_train.log"), 900)
    check(rc == 0, f"train_net --network resnet50 exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(out, "train_timing.json")) as f:
        timing = json.load(f)
    first, last = _cli_losses(log, 1, R50_STEPS), _cli_losses(log, R50_STEPS, R50_STEPS)
    n = launches_of(log)
    check(all(np.isfinite(v) for v in (*first.values(), *last.values())) and "loss_cls" in last,
          f"resnet50 losses {first} {last}")
    check(n == {"step": R50_STEPS, "hough_vote": 0, "conv3x3": 0, "nms": 0}, f"resnet50 train launches {n}")
    launches["resnet50_train_cli"] = {k: n[k] for k in ("hough_vote", "conv3x3", "nms")}
    snap = os.path.join(out, f"fcn8_color_single_iter_{R50_STEPS}.npz")
    with np.load(snap) as d:
        check("['params']['bn5c_branch2c']['variance']" in d.files, "the snapshot is not ResNet-50's")
    ms = {k: statistics.median(timing["ms"][k][R50_WARMUP:]) for k in ("step_stream", "step", "data_wait")}
    phase(17, f"(a) train_net --cfg rgbd_scene_single_color_fcn8.yml --network resnet50 --imdb lov_syn_val_v4 "
              f"(B=2, 640x480, bf16): {ms['step_stream']:.3f} ms stream a step, {ms['step']:.3f} ms host, data wait "
              f"{ms['data_wait']:.3f} ms (medians of steps {R50_WARMUP + 1}-{R50_STEPS}), peak memory "
              f"{timing['peak_memory_mib']:.1f} MiB; loss step 1 {first}, step {R50_STEPS} {last}; launches "
              f"{n} (cuDNN throughout)")
    print("resnet50 stream ms " + json.dumps([round(x, 3) for x in timing["ms"]["step_stream"]]), flush=True)
    ev = os.path.join(work, "resnet50_eval")
    rc, log = run_cli(["posecnn_torch.test_net", "--cfg", cfg, "--network", "resnet50", "--imdb", "lov_syn_val_v4",
                       "--model", snap, "--max_frames", str(R50_EVAL_FRAMES), "--output", ev],
                      os.path.join(work, "resnet50_eval.log"), 600)
    check(rc == 0, f"test_net --network resnet50 exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(ev, "eval_timing.json")) as f:
        et = json.load(f)
    with open(os.path.join(ev, "eval_summary.json")) as f:
        miou = json.load(f)["mean_iou"]
    check(et["network"] == "resnet50" and et["frames"] == R50_EVAL_FRAMES and 0 <= miou <= 1,
          f"resnet50 eval {et.get('network')} {et['frames']} {miou}")
    infer_ms = statistics.median(et["ms"]["infer"][R50_EVAL_WARMUP:])
    r50_mem = et["peak_memory_mib"]
    out_g, g = resnet50_on_golden(dev)
    e = check_resnet50_golden(out_g, g)
    del out_g
    phase(17, f"(a) test_net --network resnet50 on the iter-{R50_STEPS} snapshot, {R50_EVAL_FRAMES} frames: "
              f"{infer_ms:.3f} ms a frame to the label map on the host (median of frames {R50_EVAL_WARMUP + 1}-"
              f"{R50_EVAL_FRAMES}), peak memory {r50_mem:.1f} MiB, mean IoU {miou:.4f}; the float32 forward (TF32 "
              f"off) against the JAX golden: score max|err| {e['score']:.3g} of {e['score_max']:.3g} (limit 1e-4 x), "
              f"labels {e['label_agreement']:.6f} equal ({e['ties']} pixels within ties)")

    # (b) test_net --vis, each overlay drawn again on the host from its inputs
    records = []
    orig = VIS.PredictionVisualizer.__call__

    def recording(self, index, frame, out_, rois, poses):
        records.append((index, frame, {"label_2d": np.array(out_["label_2d"])}, np.array(rois),
                        None if poses is None else np.array(poses)))
        return orig(self, index, frame, out_, rois, poses)

    ev = os.path.join(work, "vis_eval")
    VIS.PredictionVisualizer.__call__ = recording
    try:
        rc, log = run_cli(["posecnn_torch.test_net", "--model", seed0, "--max_frames", str(VIS_FRAMES), "--vis",
                           "--output", ev], os.path.join(work, "vis_eval.log"), 600)
    finally:
        VIS.PredictionVisualizer.__call__ = orig
    check(rc == 0, f"test_net --vis exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(ev, "eval_timing.json")) as f:
        et = json.load(f)
    ds = LovSynVal()
    vis = VIS.PredictionVisualizer(os.path.join(work, "vis_host"), ds.classes, ds._extents)
    check(len(records) == VIS_FRAMES and sorted(os.listdir(os.path.join(ev, "vis"))) == [
        f"{i:06d}-vis.png" for i in range(VIS_FRAMES)], f"vis: {len(records)} calls, {os.listdir(ev)}")
    drawn = 0
    for index, frame, o, rois, poses in records:
        png = imread(os.path.join(ev, "vis", f"{index:06d}-vis.png"), IMREAD_UNCHANGED)
        check(png.shape == (480, 640, 3) and png.dtype == np.uint8, f"vis png {png.shape} {png.dtype}")
        check(np.array_equal(png, vis.render(frame, o, rois, poses)), f"vis frame {index}: the PNG differs")
        drawn += int((png != frame.color).any(-1).sum())
    check(et["launches"] == {"hough_vote": 2 * VIS_FRAMES, "conv3x3": VIS_FRAMES, "nms": 0},
          f"test_net --vis launches {et['launches']}")
    launches["vis_eval"] = et["launches"]
    vis_ms = statistics.median(et["ms"]["vis"])
    phase(17, f"(b) test_net --model <seed-0> --max_frames {VIS_FRAMES} --vis: {VIS_FRAMES} PNGs of 480x640x3, each "
              f"equal to the visualizer run again on the host on its recorded inputs ({drawn} pixels drawn over the "
              f"frames); the visualizer adds {vis_ms:.3f} ms a frame (median; frame "
              f"{statistics.median(et['ms']['frame']):.3f} ms); launches {et['launches']}")

    # (c) diag_rot
    dr = os.path.join(work, "diag_rot.json")
    rc, log = run_cli(["posecnn_torch.tools.diag_rot", "--model", seed0, "--frames", str(DIAG_FRAMES), "--imdb",
                       "lov_syn_val_v4", "--out", dr], os.path.join(work, "diag_rot.log"), 600)
    check(rc == 0, f"diag_rot exited {rc}:\n{log[-3000:]}")
    with open(dr) as f:
        report = json.load(f)
    m = re.search(r"^launches (\{.*\}); seconds", log, re.M)
    check(m is not None and sorted(report) == ["frames", "gt_hough", "imdb", "model", "pred_hough"]
          and report["frames"] == DIAG_FRAMES and report["gt_hough"]["n_rot"] > 0, f"diag_rot:\n{log[-2000:]}")
    arms = json.loads(m.group(1))
    per_arm = {"hough_vote": 2 * DIAG_FRAMES, "conv3x3": DIAG_FRAMES, "nms": 0}
    check(arms == {"gt_hough": per_arm, "pred_hough": per_arm}, f"diag_rot launches {arms}")
    launches["diag_rot"] = {k: sum(a[k] for a in arms.values()) for k in per_arm}
    phase(17, f"(c) diag_rot --model <seed-0> --frames {DIAG_FRAMES} --imdb lov_syn_val_v4: {CLI_RUNS[-1]['wall_s']:.1f} s; "
              f"launches by arm {arms}; report {json.dumps({k: report[k] for k in ('gt_hough', 'pred_hough')})}")

    # (d) isolate_pose on the YCB-Video tree
    root = os.path.join(work, "datasets")
    if not os.path.isdir(os.path.join(root, "LOV")):
        write_lov_tree(root)
    old_root = os.environ.get("POSECNN_DATA")
    os.environ["POSECNN_DATA"] = root
    iso = os.path.join(work, "isolate_pose")
    try:
        rc, log = run_cli(["posecnn_torch.tools.isolate_pose", "--iters", str(ISO_STEPS), "--report_every",
                           str(ISO_REPORT), "--frames", str(ISO_FRAMES), "--out", iso],
                          os.path.join(work, "isolate_pose.log"), 600)
    finally:
        if old_root is None:
            os.environ.pop("POSECNN_DATA", None)
        else:
            os.environ["POSECNN_DATA"] = old_root
    check(rc == 0, f"isolate_pose exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(iso, "report.json")) as f:
        rep = json.load(f)
    traj = rep["trajectory"]
    m = re.search(r"launches hough_vote (\d+) conv3x3 (\d+) nms (\d+)", log)
    check([t["iter"] for t in traj] == list(range(0, ISO_STEPS + 1, ISO_REPORT)) and m is not None
          and all(np.isfinite(t["loss_pose"]) for t in traj[1:]) and int(m.group(1)) > 0,
          f"isolate_pose:\n{log[-2000:]}")
    launches["isolate_pose"] = {k: int(m.group(i)) for i, k in enumerate(("hough_vote", "conv3x3", "nms"), 1)}
    step_ms = rep["timing"]["step_ms"]
    phase(17, f"(d) isolate_pose --iters {ISO_STEPS} --report_every {ISO_REPORT} --frames {ISO_FRAMES} (B=2, "
              f"640x480, bf16, roi pooling): {statistics.median(step_ms[2:]):.3f} ms stream a step (median of steps "
              f"3-{ISO_STEPS}; first {step_ms[0]:.1f} ms); launches {launches['isolate_pose']}; evaluations "
              + "; ".join(json.dumps({k: (round(v, 4) if isinstance(v, float) else v) for k, v in t.items()})
                          for t in traj))

    # (e) the supervisor
    sup = _supervised_run(work)
    launches["supervised_toy"] = sup["launches"]
    phase(17, f"(e) supervise_train around train_net --cfg toy_pose.yml --iters {SUP_STEPS}: child paused after its "
              f"step-{SUP_PAUSE_AT} row, the stall seen {sup['stall_s']:.1f} s later (--stall-sec {SUP_STALL_S}), "
              f"SIGTERM, snapshot at {sup['signalled_at']}, --resume to {SUP_STEPS}; {sup['wall_s']:.1f} s in all; "
              f"launches {sup['launches']}")
    for ln in sup["lines"]:
        print(ln, flush=True)

    # (f) train_net --vis: the host minibatches drawn, each PNG against the host redraw
    launches["vis_train_cli"] = _vis_train_run(work)
    # (g) the RoI pool's forward at the flagship inference's shapes: the doubling table against the masked max
    _roi_pool_timing(dev)
    return launches


def _rel_to_max(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| over max |ref|, NaN where both hold one left out."""
    got, ref = np.nan_to_num(np.asarray(got, np.float64)), np.nan_to_num(np.asarray(ref, np.float64))
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def video_phase(work: str, dev) -> dict:
    """Phase 18: dense host targets (TPU.DEVICE_TARGETS False), TPU.DEBUG_NANS,
    the video models and KinectFusion. (a) The video golden on the card at
    float32 (TF32 off): video_forward, video3d_forward (grid 6), one
    make_video_train_step and the KinectFusion track on the analytic scene
    against JAX (`check_video_golden`'s limits) and against the CPU port on
    the same inputs. On phase 15's YCB-Video tree (POSECNN_DATA pointed at
    it for the phase; its videos are 8 unrelated v4 frames each, no camera
    motion), at full width (VideoConfig: 22 classes, 64 units, 640x480,
    bf16, seed weights): (b) make_video_train_step for VIDEO_STEPS steps on
    GtDataLayer windows (T=5, B=1) through the prefetch thread: stream ms a
    step, data wait, peak memory, finite losses, conv3x3 2 launches a frame
    (forward, dx); (c) test_net_video over video 0000 (8 frames) with
    KinectFusion at grid 128: ms a frame (reading, network step, fusion),
    peak memory, the surface, conv3x3 1 a frame; (d) video3d_forward
    (Video3DConfig, grid 32) over one window, its grid fitted by Voxelizer
    to the first frame's points: ms a frame, observed voxels, conv3x3 1 a
    frame; (e) `train_net --cfg <lov_color_2d.yml with phase 15's
    SYNROOT, DISPLAY 10 and TPU.DEVICE_TARGETS False>` for DENSE_STEPS
    steps: the dense batches' host time (data wait), stream ms, peak
    memory, finite losses, 4 hough_vote and 2 conv3x3 launches a step;
    (f) `train_net --cfg <toy_pose.yml with TPU.DEBUG_NANS True>` for
    NANS_STEPS steps against phase 10's toy run (the debug mode's cost);
    (g) `python -m posecnn_torch.tools.test_kinect_fusion` on 640x480 depth
    PNGs of the analytic scene written here. Returns each path's
    launches."""
    import torch

    from posecnn_torch.config import PIXEL_MEANS, RNG_SEED
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.data.imdb import PoseEvaluator
    from posecnn_torch.data.layer import prefetch
    from posecnn_torch.data.minibatch import MinibatchConfig
    from posecnn_torch.data.video_layer import GtDataLayer
    from posecnn_torch.engine import train as T
    from posecnn_torch.engine.test import test_net_video
    from posecnn_torch.models import video as V
    from posecnn_torch.ops import conv3x3, nms, voting
    from posecnn_torch.tools.test_kinect_fusion import K_DEMO
    from posecnn_torch.utils.debug_nans import debug_nans
    from posecnn_torch.utils.png import write_png
    from posecnn_torch.utils.voxelizer import Voxelizer
    from tests.torch_parity import (
        VIDEO_REL, check_video_golden, goldens, kfusion_on_golden, load_npz, video_on_golden, video_step_on_golden,
    )

    t_phase = time.perf_counter()
    launches = {}

    def reset():
        voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = nms.NMS_LAUNCHES = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def counts():
        return {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES, "nms": nms.NMS_LAUNCHES}

    def peak_mib():
        return torch.cuda.max_memory_allocated() / 2**20

    # (a) the small golden, and the card against the CPU port on its inputs
    t0 = time.perf_counter()
    G = goldens()
    card = (video_on_golden(dev), video_on_golden(dev, three_d=True), video_step_on_golden(dev), kfusion_on_golden(dev))
    err = check_video_golden(*card, load_npz(G.VIDEO_GOLDEN))
    cpu = (video_on_golden("cpu"), video_on_golden("cpu", three_d=True))
    vs_cpu = {"video/score": _rel_to_max(card[0][0]["score"], cpu[0][0]["score"]),
              "video/state0": _rel_to_max(card[0][1][0], cpu[0][1][0]),
              "video3d/score": _rel_to_max(card[1][0]["score"], cpu[1][0]["score"]),
              "video3d/state": _rel_to_max(card[1][1][0], cpu[1][1][0])}
    check(all(v <= VIDEO_REL for v in vs_cpu.values())
          and np.array_equal(card[1][0]["flag_3d"], cpu[1][0]["flag_3d"]),
          f"video golden inputs: card against the CPU port {vs_cpu} (limit {VIDEO_REL}), or flag_3d differs")
    worst = sorted(err, key=err.get, reverse=True)[:4]
    phase(18, f"(a) the video golden on the card (float32, TF32 off, the full trunk on 3 frames of 32x32) against "
              f"JAX, within check_video_golden's limits ({time.perf_counter() - t0:.1f} s): largest "
              + ", ".join(f"{k} {err[k]:.3g}" for k in worst)
              + f"; the KinectFusion track {err['kfusion/track']:.3g}, surface {err['kfusion/surface']:.3g} m; "
              f"against the CPU port: " + ", ".join(f"{k} {v:.3g}" for k, v in vs_cpu.items())
              + f" of their largest magnitude (limit {VIDEO_REL}), flag_3d equal")

    root = os.path.join(work, "datasets")  # phase 15's trees
    old_root = os.environ.get("POSECNN_DATA")
    os.environ["POSECNN_DATA"] = root
    try:
        imdb = get_imdb("lov_train")
        mcfg = MinibatchConfig(num_classes=imdb.num_classes)

        # (b) the video train step at full width
        cfg = V.VideoConfig(num_classes=imdb.num_classes)
        hp = T.TrainHParams()
        state = T.create_train_state(V.make_video_model(cfg, V.init_video_params_numpy(RNG_SEED, cfg), dev), hp)
        step = T.make_video_train_step(cfg, hp)
        layer = GtDataLayer(imdb, mcfg, num_steps=cfg.num_steps, ims_per_batch=1, seed=RNG_SEED)
        data = prefetch(iter(layer), depth=4)
        reset()
        stream, wait, out = [], [], []
        try:
            for _ in range(VIDEO_STEPS):
                t0 = time.perf_counter()
                batch = T.to_device(next(data), dev)
                wait.append((time.perf_counter() - t0) * 1e3)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                m = step(state, batch)
                e1.record()
                e1.synchronize()
                stream.append(e0.elapsed_time(e1))
                out.append({k: float(v) for k, v in m.items()})
        finally:
            data.close()
        launches["video_train"] = counts()
        peak = peak_mib()
        want = {"hough_vote": 0, "conv3x3": 2 * cfg.num_steps * VIDEO_STEPS, "nms": 0}
        check(launches["video_train"] == want, f"video train: launches {launches['video_train']}, want {want}")
        check(all(np.isfinite(v) for m in out for v in m.values()) and state.step == VIDEO_STEPS,
              f"video train: metrics {out}")
        phase(18, f"(b) make_video_train_step at full width (22 classes, 64 units, T=5, B=1, 640x480, bf16) on "
                  f"GtDataLayer windows of the tree, {VIDEO_STEPS} steps: per step (median of steps "
                  f"{VIDEO_WARMUP + 1}-{VIDEO_STEPS}) {statistics.median(stream[VIDEO_WARMUP:]):.3f} ms stream "
                  f"(first {stream[0]:.1f}), data wait {statistics.median(wait[VIDEO_WARMUP:]):.3f} ms (the prefetch "
                  f"thread reading 5 frames a step, and the copy); peak memory {peak:.1f} MiB; loss step 1 "
                  f"{out[0]['loss']:.6g}, step {VIDEO_STEPS} {out[-1]['loss']:.6g}, lr {out[-1]['lr']:g}; launches "
                  f"{launches['video_train']} ({2 * cfg.num_steps} conv3x3 a step: conv1_2 forward and dx a frame)")
        print("video train per-step ms " + json.dumps({"stream": [round(x, 3) for x in stream],
                                                       "data_wait": [round(x, 3) for x in wait]}), flush=True)

        # (c) test_net_video over one video with KinectFusion at grid 128
        model = state.model
        del state
        torch.cuda.empty_cache()
        ev = PoseEvaluator(imdb.classes, imdb._extents, imdb._points, [])
        timings = {}
        reset()
        test_net_video(model, cfg, imdb, PIXEL_MEANS, evaluator=ev, max_videos=1, kfusion=True, kfusion_grid=128,
                       log=None, timings=timings)
        launches["video_eval"] = counts()
        peak = peak_mib()
        n = len(timings["video_step"])
        check(n == 8 and launches["video_eval"] == {"hough_vote": 0, "conv3x3": n, "nms": 0},
              f"test_net_video: {n} frames, launches {launches['video_eval']}")
        pts, labels = ev.surfaces[0]
        check(pts.ndim == 2 and pts.shape[1] == 3 and np.isfinite(pts).all() and len(labels) == len(pts),
              f"test_net_video: surface {pts.shape}")
        med = {k: statistics.median(v[VIDEO_EVAL_WARMUP:]) for k, v in timings.items()}
        phase(18, f"(c) test_net_video over video 0000 of the tree ({n} frames, 640x480, bf16) with KinectFusion at "
                  f"grid 128: per frame (median of frames {VIDEO_EVAL_WARMUP + 1}-{n}) video_step "
                  f"{med['video_step']:.3f} ms, kfusion {med['kfusion']:.3f} ms (feed_data, solve_pose, feed_label, "
                  f"fuse_depth; the card synchronized after each), reading {med['load']:.3f} ms; peak memory "
                  f"{peak:.1f} MiB; surface {pts.shape[0]} points; mean IoU {ev.summary()['mean_iou']:.4f} (seed "
                  f"weights); launches {launches['video_eval']}")
        del model
        torch.cuda.empty_cache()

        # (d) video3d_forward at grid 32 over one window, the grid fitted by Voxelizer
        cfg3 = V.Video3DConfig(num_classes=imdb.num_classes)
        model3 = V.make_video_model(cfg3, V.init_video3d_params_numpy(RNG_SEED, cfg3), dev)
        item = GtDataLayer(imdb, mcfg, num_steps=cfg3.num_steps, seed=RNG_SEED).forward()
        K0 = item["meta_data"][0, 0, 0:9].reshape(3, 3)
        vox = Voxelizer(grid_size=cfg3.grid_size, margin=0.05)
        pts0 = Voxelizer.backproject_camera(item["depth"][0, 0], K0).T
        vox.voxelize(pts0[pts0[:, 2] > 0])
        item["meta_data"][..., 42:48] = vox.meta_fields()
        batch = T.to_device(item, dev)
        reset()
        calls_ms = []
        with torch.no_grad():
            for _ in range(2):  # the first call builds cuDNN's plans
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                o3, s3 = V.video3d_forward(model3, cfg3, batch["data"], batch["depth"], batch["meta_data"])
                e1.record()
                e1.synchronize()
                calls_ms.append(e0.elapsed_time(e1))
        launches["video3d"] = counts()
        peak = peak_mib()
        flags = o3["flag_3d"].mean(dim=(1, 2, 3, 4, 5)).tolist()
        check(launches["video3d"] == {"hough_vote": 0, "conv3x3": 2 * cfg3.num_steps, "nms": 0},
              f"video3d: launches {launches['video3d']}")
        check(flags[0] > 0 and bool(torch.isfinite(s3).all())
              and tuple(o3["label_2d"].shape) == tuple(batch["depth"].shape),
              f"video3d: observed voxel shares {flags}, or the state or labels amiss")
        phase(18, f"(d) video3d_forward over a window of {cfg3.num_steps} frames (grid {cfg3.grid_size}, fitted by "
                  f"Voxelizer to frame 1's points: step {np.round(vox.meta_fields()[:3], 4).tolist()} m), twice: "
                  f"{calls_ms[1] / cfg3.num_steps:.3f} ms stream a frame (the second call; the first "
                  f"{calls_ms[0] / cfg3.num_steps:.1f}); observed voxels a frame {np.round(flags, 4).tolist()} (frame "
                  f"1 the grid's own; the others other scenes); peak memory {peak:.1f} MiB; launches "
                  f"{launches['video3d']} (two calls)")
        del model3, batch, o3, s3
        torch.cuda.empty_cache()

        # (e) lov_color_2d.yml with dense host targets
        with open(os.path.join(work, "lov_color_2d_tree.yml")) as f:  # phase 15's cfg
            text = f.read()
        cfg_file = os.path.join(work, "lov_color_2d_dense.yml")
        with open(cfg_file, "w") as f:
            f.write(text.replace("TRAIN:\n", f"TRAIN:\n  DISPLAY: {DENSE_STEPS}\n", 1)
                    + "TPU:\n  DEVICE_TARGETS: False\n")
        out = os.path.join(work, "lov_dense")
        rc, log = run_cli(["posecnn_torch.train_net", "--cfg", cfg_file, "--imdb", "lov_train", "--iters",
                           str(DENSE_STEPS), "--output", out], os.path.join(work, "lov_dense.log"), 600)
        check(rc == 0, f"train_net (dense targets) exited {rc}:\n{log[-3000:]}")
        with open(os.path.join(out, "train_timing.json")) as fh:
            timing = json.load(fh)
        launches["dense_train_cli"] = timing["launches"]
        want = {"hough_vote": 4 * DENSE_STEPS, "conv3x3": 2 * DENSE_STEPS, "nms": 0}
        check(timing["launches"] == want, f"dense targets: launches {timing['launches']}, want {want}")
        losses = {it: _cli_losses(log, it, DENSE_STEPS) for it in (1, DENSE_STEPS)}
        check(all(np.isfinite(v) for m in losses.values() for v in m.values())
              and all("loss_vertex" in m for m in losses.values()), f"dense targets: losses {losses}")
        ms = {k: statistics.median(v[DENSE_WARMUP:]) for k, v in timing["ms"].items()}
        phase(18, f"(e) train_net --cfg lov_color_2d.yml + TPU.DEVICE_TARGETS False --imdb lov_train --iters "
                  f"{DENSE_STEPS} (B=2, 640x480, bf16; dense (2,480,640,66) f32 targets and weights, 2 x 162 MB a "
                  f"batch): per step (median of steps {DENSE_WARMUP + 1}-{DENSE_STEPS}) {ms['step_stream']:.3f} ms "
                  f"stream, {ms['step']:.3f} ms host, data wait {ms['data_wait']:.3f} ms; peak memory "
                  f"{timing['peak_memory_mib']:.1f} MiB; losses "
                  + "; ".join(f"step {it}: {m}" for it, m in losses.items())
                  + f"; launches {timing['launches']}")
        print("dense-targets train per-step ms " + json.dumps({k: [round(x, 3) for x in v]
                                                                for k, v in timing["ms"].items()}), flush=True)
    finally:
        if old_root is None:
            os.environ.pop("POSECNN_DATA", None)
        else:
            os.environ["POSECNN_DATA"] = old_root

    # (f) the toy trainer under TPU.DEBUG_NANS, against phase 10's run
    cfg_file = os.path.join(work, "toy_debug_nans.yml")
    with open(os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml")) as f:
        text = f.read()
    with open(cfg_file, "w") as f:
        f.write(text + "TPU:\n  DEBUG_NANS: True\n")
    out = os.path.join(work, "toy_nans")
    rc, log = run_cli(["posecnn_torch.train_net", "--cfg", cfg_file, "--imdb", "toy_train", "--iters",
                       str(NANS_STEPS), "--output", out], os.path.join(work, "toy_nans.log"), 600)
    check(rc == 0, f"train_net (DEBUG_NANS) exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(out, "train_timing.json")) as fh:
        timing = json.load(fh)
    with open(os.path.join(work, "toy", "train_timing.json")) as fh:
        toy = json.load(fh)
    launches["debug_nans_cli"] = timing["launches"]
    check(timing["launches"] == {"hough_vote": 4 * NANS_STEPS, "conv3x3": 2 * NANS_STEPS, "nms": 0},
          f"DEBUG_NANS: launches {timing['launches']}")
    check(timing["debug_nans_checked_outputs"] > 0, "DEBUG_NANS: no output checked")
    ms = {k: statistics.median(v[NANS_WARMUP:]) for k, v in timing["ms"].items()}
    base = {k: statistics.median(v[TOY_WARMUP:]) for k, v in toy["ms"].items()}
    # the backward on the card runs on the autograd engine's device thread:
    # the mode must reach it (sqrt'(0) * 0 is a NaN)
    x = torch.zeros(2, device=dev, requires_grad=True)
    try:
        with debug_nans():
            (torch.sqrt(x) * 0.0).sum().backward()
        raised = False
    except FloatingPointError:
        raised = True
    check(raised, "DEBUG_NANS: a NaN made in a backward on the card raised nothing")
    phase(18, f"(f) train_net --cfg toy_pose.yml + TPU.DEBUG_NANS True --iters {NANS_STEPS}: no FloatingPointError; "
              f"{timing['debug_nans_checked_outputs']} floating outputs checked "
              f"({timing['debug_nans_checked_outputs'] / NANS_STEPS:.0f} a step); per step (median of steps "
              f"{NANS_WARMUP + 1}-{NANS_STEPS}) {ms['step_stream']:.3f} ms stream, {ms['step']:.3f} ms host, "
              f"against phase 10's run without it {base['step_stream']:.3f} / {base['step']:.3f} ms "
              f"({ms['step_stream'] / base['step_stream']:.2f}x stream); launches {timing['launches']}; a NaN made in "
              f"a backward on the card raised FloatingPointError")

    # (g) the KinectFusion tool on depth PNGs of the analytic scene
    images = os.path.join(work, "kfusion_images")
    os.makedirs(images, exist_ok=True)
    depths, truth = G.kfusion_scene(hw=(480, 640), K=K_DEMO, frames=KF_TOOL_FRAMES)
    for j, d in enumerate(depths):
        write_png(os.path.join(images, f"{j:06d}-depth.png"), np.round(d * 10000).astype(np.uint16))
    out = os.path.join(work, "kfusion_tool")
    reset()
    t0 = time.perf_counter()
    rc, log = run_cli(["posecnn_torch.tools.test_kinect_fusion", "--images", images, "--grid", "128", "--output", out],
                      os.path.join(work, "kfusion_tool.log"), 300)
    wall = time.perf_counter() - t0
    launches["kfusion_tool"] = counts()
    check(rc == 0 and os.path.exists(os.path.join(out, "raycast.png")), f"test_kinect_fusion exited {rc}:\n{log[-3000:]}")
    surf = re.search(r"surface points: (\d+)", log)
    hit = re.search(r"raycast hit fraction: ([\d.]+)", log)
    track = re.findall(r"frame (\d+): pose t = \[(.*)\]", log)
    check(surf is not None and int(surf.group(1)) > 0 and hit is not None and len(track) == KF_TOOL_FRAMES - 1,
          f"test_kinect_fusion output:\n{log[-2000:]}")
    phase(18, f"(g) python -m posecnn_torch.tools.test_kinect_fusion --images <{KF_TOOL_FRAMES} depth PNGs of the "
              f"analytic scene, 640x480, the camera moving (1, 0.5, 0) cm a frame> --grid 128: {wall:.2f} s; tracked "
              f"t (world2cam) {[t for _, t in track]} (truth {[np.round(p[:, 3], 4).tolist() for p in truth[1:]]}); "
              f"surface {surf.group(1)} points; raycast hit fraction {hit.group(1)}; launches "
              f"{launches['kfusion_tool']}; the whole phase {time.perf_counter() - t_phase:.1f} s")
    return launches



# a tiny valid JPEG (8x8 grey ramp, cv2's encoder): the online server must
# refuse it in its answer (no JPEG decoder in the port)
JPEG_8X8_B64 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAIBAQEBAQIBAQECAgICAgQDAgICAgUEBAMEBgUGBgYFBgYGBwkIBgcJBwYGCAsICQoKCgoKBggL"
    "DAsKDAkKCgr/2wBDAQICAgICAgUDAwUKBwYHCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgr/wAAR"
    "CAAIAAgDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEG"
    "E1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWG"
    "h4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEB"
    "AQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYk"
    "NOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0"
    "tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwCv8Nv+Dbj/AFf/ABQXp/y7f/WooooA/9k="
)


def _dets_close(got: list, ref: list, what: str) -> tuple:
    """Holds one frame's detections (the online tool's JSON) to another's at
    the card's limits between two runs of the network: the same count and
    classes, boxes within 4 px and votes within 2 (phase 6's), translations
    and quaternions within EVAL_ICP_T and 1 - |cos| EVAL_ICP_Q (phase 9's).
    Returns (box, votes, translation, quaternion) max errors."""
    check(len(got) == len(ref) and [d["class"] for d in got] == [d["class"] for d in ref],
          f"{what}: {len(got)} detections {[d['class'] for d in got]}, want {[d['class'] for d in ref]}")
    qk = "quaternion_wxyz" if got and "quaternion_wxyz" in got[0] else "pose_quat_wxyz"
    tk = "translation" if qk == "quaternion_wxyz" else "pose_t"
    err = [0.0, 0.0, 0.0, 0.0]
    for g, r in zip(got, ref):
        err[0] = max(err[0], float(np.abs(np.subtract(g["box"], r["box"])).max()))
        err[1] = max(err[1], abs(g["score"] - r["score"]))
        err[2] = max(err[2], float(np.abs(np.subtract(g[tk], r[tk])).max()))
        qg, qr = np.asarray(g[qk]), np.asarray(r[qk])
        cos = abs(float(qg @ qr)) / max(float(np.linalg.norm(qg) * np.linalg.norm(qr)), 1e-12)
        err[3] = max(err[3], 1 - cos)
    check(err[0] <= 4.0 and err[1] <= 2.0 and err[2] <= EVAL_ICP_T and err[3] <= EVAL_ICP_Q,
          f"{what}: box {err[0]} px (limit 4), votes {err[1]} (limit 2), t {err[2]} m (limit {EVAL_ICP_T}), "
          f"1-|cos| {err[3]} (limit {EVAL_ICP_Q})")
    return tuple(err)


# processes a phase started and has not stopped yet (the online server)
_CHILDREN = []


def _stop_children() -> None:
    """Stop every process in _CHILDREN: SIGTERM, then SIGKILL after 30 s."""
    while _CHILDREN:
        proc = _CHILDREN.pop()
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ask(port: int, req: dict, deadline: float) -> dict:
    """One JSON-line request to the online server on 127.0.0.1:`port`,
    connecting until `deadline` (time.time())."""
    import socket

    while True:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=1)
            break
        except OSError:
            check(time.time() < deadline, f"the online server on port {port} did not come up")
            time.sleep(0.05)
    with s:
        s.settimeout(120)
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 20)
            check(bool(chunk), "the online server closed the connection without an answer")
            buf += chunk
    return json.loads(buf)


def _multi_on_cpu(args, kw, valid, rois, poses) -> None:
    """Phase 19 (b)'s CPU side: hough_voting_multi on the CPU port on the
    frame's inputs, held to the card's rows."""
    import torch

    from posecnn_torch.ops.hough_voting import hough_voting_multi

    t0 = time.perf_counter()
    cpu = hough_voting_multi(*args, is_train=False, **kw)
    check(torch.equal(cpu.valid, valid) and torch.equal(cpu.rois, rois),
          "multi mode: the card's rois differ from the CPU port's")
    err = float((cpu.poses_init - poses).abs().max())
    check(err <= 1e-4, f"multi mode: poses_init {err} from the CPU port (limit 1e-4)")
    phase(19, f"(b) hough_voting_multi on frame v4/000000's ground truth on the CPU port "
              f"({time.perf_counter() - t0:.1f} s on the CPU thread): valid rows and rois equal to the card's, "
              f"poses_init max|err| {err:.3g} (limit 1e-4)")


def serving_phase(work: str, dev, seed0: str, kernels: dict) -> dict:
    """Phase 19: the multi-instance Hough mode, the weight readers and the
    serving tools. (a) hough_vote on the dense grid of the multi mode (S=8
    slots, 640x480 = 307,200 centres shared by the slots, P=1024 samples) on
    synthetic samples and on the multi golden frames' own, against its plain
    version (phase 3's comparison and timing), beside its bound. (b)
    `hough_voting_multi` on the card on frames v4/000000 and 000001, fed their
    ground-truth labels and vertex fields: rois and valid rows equal to the
    JAX golden (`tools/make_torch_goldens.py:hough_multi_golden`), poses_init
    within 1e-4 (phase 4's); frame 000000 against the CPU port (rois equal,
    poses_init within 1e-4); then `test_net --cfg <lov_syn_capstone.yml with
    TEST.VOTING_THRESHOLD 100>` over MULTI_EVAL_FRAMES frames of the seed-0
    weights: ms a frame, 1 hough_vote and 1 conv3x3 launch a frame. (c) the
    readers: `train_net --cfg rgbd_scene_single_rgbd.yml --weights <a
    vgg16.npy pickled here from perturbed seed weights> --iters 0`: its
    iteration-0 snapshot holds the file's conv1_1-conv5_3 in both trunks
    (the `_p` scopes) bit-equal; the committed TF1 checkpoint read here (no
    TensorFlow) equal to its npz twin; `test_net --model <the TF1
    checkpoint>` (its variables over the seed-0 weights) and `test_net
    --model <an npz of those weights>` over 2 frames, their detections equal.
    (d) `python -m posecnn_torch.tools.online --serve` in a process of its
    own with phase 8's seed-0 snapshot: 4 file and 4 base64 requests of v4
    frames against the same engine in this process, a JPEG refused in its
    answer, ms a request; `online --watch DIR --once` over SERVE_FRAMES
    frames against the same engine; `tools.demo --visualize` over
    DEMO_FRAMES frames. The tools read phase 8's seed-0 snapshot, which
    detects (30 steps from it label every pixel background). Returns each
    path's launches."""
    import base64
    import types

    import torch

    from posecnn_torch.config import RNG_SEED, flagship_eval_cfg
    from posecnn_torch.core import config as C
    from posecnn_torch.core.checkpoint import load_tf1_checkpoint
    from posecnn_torch.core.convert import init_params_numpy
    from posecnn_torch.core.tf1_bundle import TF1Checkpoint
    from posecnn_torch.ops import conv3x3, nms, voting
    from posecnn_torch.ops.hough_voting import coarse_centers, hough_voting_multi, slot_samples
    from posecnn_torch.tools import online
    from posecnn_torch.utils.png import IMREAD_COLOR, imread, write_png
    from tests.torch_parity import goldens, load_npz, t

    t_phase = time.perf_counter()
    G = goldens()
    launches = {}
    g = load_npz(G.MULTI_GOLDEN)
    kw = {k[len("settings/"):]: g[k].item() for k in g if k.startswith("settings/")}

    # (a) the dense grid
    _, _, grid = coarse_centers(480, 640, 1, dev)
    samples, _, _ = vote_inputs(np.random.RandomState(19), 8, 1024, 480, 640)
    cases = {"synthetic": [(torch.from_numpy(samples).to(dev), grid, 640)], "path": []}
    for path in G.MULTI_FRAMES:
        label, vert, extents, meta = G.hough_inputs(path)
        _, _, _, packed = slot_samples(
            t(label).reshape(-1).to(dev), t(vert).reshape(-1, 3 * kw["num_classes"]).to(dev), t(meta).to(dev),
            t(extents).to(dev), torch.arange(480 * 640, device=dev), 640, num_classes=kw["num_classes"],
            class_slots=kw["class_slots"], label_threshold=kw["label_threshold"], skip=kw["skip_pixels"],
            max_samples=kw["max_samples"])
        cases["path"].append((packed, grid, 640))
    for label, cs in cases.items():
        r = time_votes(cs, cold=True)
        phase(19, "(a) " + vote_line(f"dense grid of the multi mode, {label} (S=8, P=1024, 640x480 = 307,200 "
                                     f"centres)", r, 8 * 1024 * 307200))
        if label == "path":
            mean = {k: statistics.fmean(r[k]) for k in ("ms", "single", "plain")}
            kernels["hough_vote"].update(
                dense_ms=mean["ms"], dense_ms_cold_l2=r["cold"], dense_ms_single=mean["single"],
                dense_plain_ms=mean["plain"], dense_bound_ms=r["bound"], dense_bound_by=r["by"],
                dense_max_abs_err=max(r["err"]))
    del cases
    torch.cuda.empty_cache()

    # (d)'s server starts here, in a process of its own: its start-up runs
    # beside (b) and (c)
    capstone = os.path.join("experiments", "cfgs", "lov_syn_capstone.yml")
    port = _free_port()
    t_serve = time.perf_counter()
    with open(os.path.join(work, "serve.log"), "w") as logf:
        _CHILDREN.append(subprocess.Popen(
            [sys.executable, "-m", "posecnn_torch.tools.online", "--serve", str(port), "--cfg", capstone, "--model",
             seed0], cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT))

    # (b) the multi mode on the card against JAX and the CPU port
    t0 = time.perf_counter()
    errs, ms = [], []
    for i, path in enumerate(G.MULTI_FRAMES):
        label, vert, extents, meta = G.hough_inputs(path)
        args = [t(label[None]), t(vert[None]), t(extents), t(meta[None]), torch.zeros((1, 13))]
        v0 = voting.VOTE_LAUNCHES
        for rep in range(3):  # the first call builds nothing new; its time is kept beside the others
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = hough_voting_multi(*[a.to(dev) for a in args], is_train=False, **kw)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        check(voting.VOTE_LAUNCHES == v0 + 3, "hough_voting_multi: one vote launch a call")
        valid, rois, poses = (x.cpu().numpy() for x in (out.valid, out.rois, out.poses_init))
        check(np.array_equal(valid, g[f"{i}/valid"]) and np.array_equal(rois, g[f"{i}/rois"]),
              f"multi mode, {path}: rois or valid rows differ from the JAX golden:\n{rois[valid]}\n"
              f"{g[f'{i}/rois'][g[f'{i}/valid']]}")
        e = float(np.abs(poses - g[f"{i}/poses_init"]).max())
        check(e <= 1e-4, f"multi mode, {path}: poses_init {e} from the JAX golden (limit 1e-4)")
        errs.append(e)
        if i == 0:
            defer(19, "the multi mode on the CPU port", functools.partial(
                _multi_on_cpu, args, kw, out.valid.cpu(), out.rois.cpu(), out.poses_init.cpu()))
    phase(19, f"(b) hough_voting_multi on the card, frames v4/000000-000001's ground truth ({kw}): "
              f"{[int(g[f'{i}/valid'].sum()) for i in range(2)]} detections, rois and valid rows equal to the JAX "
              f"golden (ties among equal votes in index order), poses_init max|err| {max(errs):.3g} (limit 1e-4); "
              f"stream ms a call {[round(x, 3) for x in ms]} (one vote launch each; {time.perf_counter() - t0:.1f} s); "
              f"frame 000000 on the CPU port on the CPU thread")

    # test_net on the flagship test cfg with VOTING_THRESHOLD > 0
    cfg_multi = os.path.join(work, "capstone_multi.yml")
    with open(os.path.join(ROOT, "experiments", "cfgs", "lov_syn_capstone.yml")) as f:
        text = f.read()
    check("\nTEST:\n" in text, "lov_syn_capstone.yml has no TEST section")
    with open(cfg_multi, "w") as f:
        f.write(text.replace("\nTEST:\n", f"\nTEST:\n  VOTING_THRESHOLD: {kw['voting_threshold']}\n"))
    check(C.cfg_from_file(cfg_multi).TEST.VOTING_THRESHOLD == kw["voting_threshold"], "the multi cfg's threshold")
    eval_cfg = flagship_eval_cfg()
    out = os.path.join(work, "eval_multi")
    rc, log = run_cli(["posecnn_torch.test_net", "--cfg", cfg_multi, "--imdb", "lov_syn_val_v4", "--model", seed0,
                       "--max_frames", str(MULTI_EVAL_FRAMES), "--output", out], out + ".log", 600)
    check(rc == 0, f"test_net on the multi cfg exited {rc}:\n{log[-3000:]}")
    with open(os.path.join(out, "eval_timing.json")) as fh:
        timing = json.load(fh)
    with np.load(os.path.join(out, "detections.npz")) as d:
        dets = {k: d[k] for k in d.files}
    want = {"hough_vote": MULTI_EVAL_FRAMES, "conv3x3": MULTI_EVAL_FRAMES, "nms": 0}
    check(timing["launches"] == want, f"test_net, multi mode: launches {timing['launches']}, want {want}")
    check(all(np.isfinite(v).all() for v in dets.values()), "test_net, multi mode: detections not finite")
    launches["multi_eval"] = timing["launches"]
    ev_ms = {k: statistics.median(v[1:]) for k, v in timing["ms"].items()}
    n_dets = sum(len(v) for k, v in dets.items() if k.endswith("_rois"))
    phase(19, f"(b) test_net --cfg <lov_syn_capstone.yml, TEST.VOTING_THRESHOLD {kw['voting_threshold']}> --model "
              f"<seed-0> --max_frames {MULTI_EVAL_FRAMES}: {n_dets} detections; per frame (median of frames "
              f"2-{MULTI_EVAL_FRAMES}) "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ev_ms.items())
              + f"; peak {timing['peak_memory_mib']:.1f} MiB; launches {timing['launches']}")

    # (c) the weight readers: vgg16.npy through train_net --weights
    t0 = time.perf_counter()
    rgbd = os.path.join("experiments", "cfgs", "rgbd_scene_single_rgbd.yml")
    rcfg = C.cfg_from_file(os.path.join(ROOT, rgbd))
    rng = np.random.RandomState(19)
    seed_w = init_params_numpy(RNG_SEED, C.train_model_cfg(rcfg, 22))
    npy = {name: {leaf: (a + np.float32(0.01) * rng.randn(*a.shape).astype(np.float32)).astype(np.float32)
                  for leaf, a in seed_w[name].items()}
           for name in seed_w if re.fullmatch(r"conv\d_\d", name)}
    npy_path = os.path.join(work, "vgg16.npy")
    np.save(npy_path, npy, allow_pickle=True)
    out = os.path.join(work, "weights_npy")
    rc, log = run_cli(["posecnn_torch.train_net", "--cfg", rgbd, "--imdb", "lov_syn_val_v4", "--weights", npy_path,
                       "--iters", "0", "--output", out], out + ".log", 600)
    check(rc == 0, f"train_net --weights exited {rc}:\n{log[-3000:]}")
    snap = [f for f in os.listdir(out) if f.endswith("_iter_0.npz")]
    check(len(snap) == 1, f"train_net --iters 0 wrote {os.listdir(out)}")
    n_eq = 0
    with np.load(os.path.join(out, snap[0])) as d:
        for name, leaves in npy.items():
            for scope in (name, name + "_p"):
                for leaf, a in leaves.items():
                    check(np.array_equal(d[f"['params']['{scope}']['{leaf}']"], a),
                          f"train_net --weights: {scope}/{leaf} differs from the vgg16.npy")
                    n_eq += 1
    assigned = len(re.findall(r"assigned$", log, re.M))
    check(assigned == n_eq, f"train_net --weights logged {assigned} assignments, {n_eq} leaves compared")
    npy_s = time.perf_counter() - t0

    # the TF1 checkpoint, read without TensorFlow, against its twin
    reader = TF1Checkpoint(G.TF1_GOLDEN)
    with np.load(G.TF1_TWIN) as twin:
        for name in twin.files:
            check(np.array_equal(reader.get_tensor(name), twin[name]), f"TF1 golden: {name} differs from its twin")
        n_tf1 = len(twin.files)
    merged = load_tf1_checkpoint(G.TF1_GOLDEN, init_params_numpy(0, eval_cfg))
    twin_npz = os.path.join(work, "tf1_twin.npz")
    _write_params(twin_npz, merged)
    evals = {}
    for what, model in (("tf1", G.TF1_GOLDEN), ("npz", twin_npz)):
        out = os.path.join(work, f"eval_{what}")
        rc, log = run_cli(["posecnn_torch.test_net", "--model", model, "--max_frames", "2", "--output", out],
                          out + ".log", 600)
        check(rc == 0, f"test_net --model <{what}> exited {rc}:\n{log[-3000:]}")
        with np.load(os.path.join(out, "detections.npz")) as d:
            evals[what] = {k: d[k] for k in d.files}
        with open(os.path.join(out, "eval_timing.json")) as fh:
            launches[f"eval_{what}"] = json.load(fh)["launches"]
    check(evals["tf1"].keys() == evals["npz"].keys()
          and all(np.array_equal(evals["tf1"][k], evals["npz"][k]) for k in evals["tf1"]),
          "test_net --model: the TF1 checkpoint's detections differ from its npz twin's")
    phase(19, f"(c) train_net --cfg rgbd_scene_single_rgbd.yml --weights <vgg16.npy of {len(npy)} ops, perturbed "
              f"seed weights> --iters 0: the iteration-0 snapshot holds the file's {n_eq} leaves bit-equal, "
              f"conv*_p included ({npy_s:.1f} s); the TF1 checkpoint tests/golden/torch_port_tf1.ckpt read without "
              f"TensorFlow: {n_tf1} variables equal to its npz twin; test_net --model <it> and --model <an npz of the "
              f"same weights> over 2 frames: detections equal "
              f"({sum(len(v) for k, v in evals['npz'].items() if k.endswith('_rois'))} rois), launches "
              f"{launches['eval_npz']}")

    # (d) the serving tools on phase 8's seed-0 snapshot
    frames_dir = os.path.join(work, "serve_frames")
    demo_dir = os.path.join(work, "demo_frames")
    os.makedirs(frames_dir)
    os.makedirs(demo_dir)
    names = sorted(os.listdir(FRAMES_DIR))[:DEMO_FRAMES]
    for i, fname in enumerate(names):
        with np.load(os.path.join(FRAMES_DIR, fname)) as f:
            for d in ([frames_dir, demo_dir] if i < SERVE_FRAMES else [demo_dir]):
                write_png(os.path.join(d, f"{i:06d}-color.png"), np.ascontiguousarray(f["color"]))
    engine_args = types.SimpleNamespace(cfg_file=os.path.join(ROOT, capstone), model=seed0, device=str(dev))
    voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = nms.NMS_LAUNCHES = 0
    process = online.build_engine(engine_args)
    pngs = [os.path.join(frames_dir, f"{i:06d}-color.png") for i in range(SERVE_FRAMES)]
    ref = [process(imread(p, IMREAD_COLOR))[0] for p in pngs]
    launches["online_ref"] = {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES,
                              "nms": nms.NMS_LAUNCHES}
    check(launches["online_ref"] == {"hough_vote": 2 * SERVE_FRAMES, "conv3x3": SERVE_FRAMES, "nms": 0},
          f"the online engine's launches {launches['online_ref']}")
    try:
        answers, req_ms = [], []
        for i, p in enumerate(pngs + pngs):
            if i < SERVE_FRAMES:
                req = {"file": p}
            else:
                with open(p, "rb") as f:
                    req = {"image_b64": base64.b64encode(f.read()).decode()}
            t1 = time.perf_counter()
            answers.append(_ask(port, req, time.time() + 300))
            req_ms.append((time.perf_counter() - t1) * 1e3)
            if i == 0:
                up_s = time.perf_counter() - t_serve
        jpeg = _ask(port, {"image_b64": JPEG_8X8_B64}, time.time() + 60)
    finally:
        _stop_children()
    CLI_RUNS.append({"args": "posecnn_torch.tools.online --serve", "where": "own process",
                     "wall_s": time.perf_counter() - t_serve, "first_step_s": None})
    errs = []
    for i, a in enumerate(answers):
        check(a.get("ok") is True, f"online request {i}: {a}")
        errs.append(_dets_close(a["detections"], ref[i % SERVE_FRAMES], f"online request {i}"))
    check(jpeg.get("ok") is False and "not a PNG" in jpeg.get("error", ""), f"online, a JPEG: {jpeg}")
    worst = [max(e[k] for e in errs) for k in range(4)]
    del process
    torch.cuda.empty_cache()
    check(sum(len(a["detections"]) for a in answers) > 0, "online: no detection in any answer")
    phase(19, f"(d) online --serve in its own process (--cfg lov_syn_capstone.yml --model <phase 8's seed-0 "
              f"snapshot>): {SERVE_FRAMES} file and {SERVE_FRAMES} base64 PNG requests of v4 frames answered with "
              f"{[len(a['detections']) for a in answers]} detections, against this process's engine: box "
              f"{worst[0]:.3g} px, votes {worst[1]:.3g}, t {worst[2]:.3g} m, 1-|cos| {worst[3]:.3g}; a JPEG answered "
              f"ok: false ({jpeg['error'][:80]!r}); ms a request {[round(x, 1) for x in req_ms]} (the first "
              f"answered {up_s:.1f} s after the server's start, which ran beside (b) and (c)); this process's "
              f"engine: launches {launches['online_ref']}")

    rc, log = run_cli(["posecnn_torch.tools.online", "--watch", frames_dir, "--once", "--cfg", capstone, "--model",
                       seed0], os.path.join(work, "watch.log"), 600)
    check(rc == 0, f"online --watch exited {rc}:\n{log[-3000:]}")
    for i in range(SERVE_FRAMES):
        with open(os.path.join(frames_dir, f"{i:06d}-posecnn.json")) as f:
            got = json.load(f)
        check(got["frame"] == f"{i:06d}", f"watch: frame {got['frame']}")
        _dets_close(got["detections"], ref[i], f"online --watch frame {i}")
    launches["online_watch"] = json.loads(re.search(r"^launches (.*)$", log, re.M).group(1))
    check(launches["online_watch"] == {"hough_vote": 2 * SERVE_FRAMES, "conv3x3": SERVE_FRAMES, "nms": 0},
          f"online --watch launches {launches['online_watch']}")
    watch_s = CLI_RUNS[-1]["wall_s"]

    out = os.path.join(work, "demo_out")
    rc, log = run_cli(["posecnn_torch.tools.demo", "--images", demo_dir, "--output", out, "--model", seed0,
                       "--visualize"], os.path.join(work, "demo.log"), 600)
    check(rc == 0, f"demo exited {rc}:\n{log[-3000:]}")
    n_demo = 0
    for i in range(DEMO_FRAMES):
        with open(os.path.join(out, f"{i:06d}-dets.json")) as f:
            dets = json.load(f)
        check(all(np.isfinite(d["box"] + d["pose_quat_wxyz"] + d["pose_t"]).all() for d in dets), "demo: not finite")
        n_demo += len(dets)
        for suffix, shape in (("label", (480, 640, 3)), ("vis", (480, 640, 3))):
            im = imread(os.path.join(out, f"{i:06d}-{suffix}.png"))
            check(im.shape == shape, f"demo: {i:06d}-{suffix}.png is {im.shape}")
    launches["demo"] = json.loads(re.search(r"^launches (.*)$", log, re.M).group(1))
    check(launches["demo"] == {"hough_vote": 2 * DEMO_FRAMES, "conv3x3": DEMO_FRAMES, "nms": 0},
          f"demo launches {launches['demo']}")
    phase(19, f"(d) online --watch <{SERVE_FRAMES} frames> --once: the JSON beside each frame within the limits of "
              f"this process's engine, {watch_s:.1f} s, launches {launches['online_watch']}; tools.demo --visualize "
              f"over {DEMO_FRAMES} frames: {n_demo} detections, a label and an overlay PNG a frame, "
              f"{CLI_RUNS[-1]['wall_s']:.1f} s, launches {launches['demo']}; the whole phase "
              f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def _write_params(path: str, params: dict) -> None:
    """JAX-layout parameters as a train-state npz (`['params'][scope][leaf]`)."""
    np.savez(path, **{f"['params']['{s}']['{k}']": v for s, leaves in params.items() for k, v in leaves.items()},
             **{"['step']": np.asarray(0, np.int32)})



def time_votes(cases, cold: bool) -> dict:
    """cases: [(samples, centers, grid_w)] on the card. Checks each against
    the plain version and returns per-case lists of times, errors, bounds
    and pair counts."""
    import torch

    from posecnn_torch.ops import voting

    r = {k: [] for k in ("ms", "eager", "single", "plain", "err", "bytes", "inside", "valid", "tested")}
    for smp, cen, gw in cases:
        call = functools.partial(voting.accumulate_votes, smp, cen, grid_w=gw)
        v_k, d_k = call()
        v_p, d_p = voting.accumulate_votes_plain(smp, cen)
        v_2, d_2 = call()
        torch.cuda.synchronize()
        check(torch.equal(v_k, v_p), "hough_vote: kernel votes differ from the plain version")
        torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-4)
        check(torch.equal(v_k, v_2) and torch.equal(d_k, d_2), "hough_vote: two launches differ")
        r["err"].append(max((v_k - v_p).abs().max().item(), (d_k - d_p).abs().max().item()))
        r["ms"].append(statistics.median([graph_ms([call] * 10) for _ in range(2)]))
        r["eager"].append(median_ms(call))
        r["single"].append(single_ms(call))
        r["plain"].append(median_ms(lambda: voting.accumulate_votes_plain(smp, cen), reps=3, inner=1))
        inside, valid = vote_pairs(smp, cen)
        r["bytes"].append((smp.numel() + cen.numel() + 2 * smp.shape[0] * cen.shape[2]) * 4)
        r["inside"].append(inside)
        r["valid"].append(valid)
        r["tested"].append(pruned_pairs(smp, cen, gw))
    # the bound of the mean case: its bytes and pairs; and the bound that
    # counts every valid pair, the earlier definition, beside it
    mean_bytes = statistics.fmean(r["bytes"])
    r["bound"], r["by"] = vote_bound(mean_bytes, statistics.fmean(r["inside"]))
    r["old"] = vote_bound(mean_bytes, statistics.fmean(r["valid"]))[0]
    r["cases"] = [vote_bound(b, i)[0] for b, i in zip(r["bytes"], r["inside"])]
    r["cold"] = None
    if cold:
        n = -(-150_000_000 // int(mean_bytes)) + 1
        rot = [(cases[i % len(cases)][0].clone(), cases[i % len(cases)][1].clone(), cases[i % len(cases)][2])
               for i in range(n)]
        r["cold"] = graph_ms([functools.partial(voting.accumulate_votes, a, b, grid_w=g) for a, b, g in rot],
                             reps=5)
        del rot
    return r

def vote_line(label: str, r: dict, total_pairs: int) -> str:
    mean = lambda k: statistics.fmean(r[k])  # noqa: E731
    us = lambda xs: [round(x * 1e3, 2) for x in xs]  # noqa: E731
    cold = "cold L2 not measured" if r["cold"] is None else f"{r['cold'] * 1e3:.2f} cold L2"
    return (f"hough_vote {label}: votes equal, two launches bit-equal, dsum max|err| {max(r['err']):.3g} "
            f"(rtol 1e-5, atol 1e-4); kernel {mean('ms') * 1e3:.2f} us back to back (mean; cases {us(r['ms'])}), "
            f"{cold}, {mean('single') * 1e3:.2f} single, {mean('eager') * 1e3:.2f} "
            f"eager back to back; plain {mean('plain') * 1e3:.1f} us; bound {r['bound'] * 1e3:.3f} us "
            f"({r['by']}; cases {us(r['cases'])}), counting the pairs inside a valid "
            f"sample's box: {[round(x / total_pairs, 4) for x in r['inside']]} of all pairs (the earlier bound "
            f"counted every valid pair, {[round(x / total_pairs, 4) for x in r['valid']]} of all: "
            f"{r['old'] * 1e3:.3f} us); pairs tested after pruning "
            f"{[round(x / total_pairs, 4) for x in r['tested']]} of all")

def main() -> int:
    import torch
    import torch.nn.functional as F

    # phase 1: the device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from posecnn_torch import _build
    from posecnn_torch.config import PIXEL_MEANS, RNG_SEED, flagship_cfg, flagship_train_cfg
    from posecnn_torch.engine import train as T
    from posecnn_torch.engine.test import make_inference_fn, postprocess_detections, set_float32_precision
    from posecnn_torch.entry import entry, train_entry, train_objects
    from posecnn_torch.ops import conv3x3, voting
    from posecnn_torch.utils.meta import build_meta_data
    from tests.torch_parity import (
        bf16_ulp_excess, check_hough_golden, check_slice_golden, check_train_golden, hough_on_golden_frame,
        path_vote_inputs, small_slice_on_golden, small_train_on_golden,
    )

    dev = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    set_float32_precision()
    phase(1, f"device {device_name}; torch {torch.__version__} cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    print(smi, flush=True)

    # phase 2: build every kernel of the path
    phase(2, f"built and loaded the CUDA kernels, the host rasterizer, the bilateral filter and the PNG row "
             f"filters in {_build.build_all():.2f} s")

    # phase 3: each kernel against its plain version at the main path's shapes
    # hough_vote, both passes: on synthetic inputs (uniform positions) and on
    # the path's own (the ground truth of the 8 frozen frames, packed by the
    # functions hough_voting calls) at P=512 (inference) and P=1024
    # (training). Votes equal to the plain version's, dsum within rtol 1e-5,
    # atol 1e-4. The kernel's time is read from a CUDA graph of its calls,
    # which leaves no host work between them: back to back (10 calls on one
    # input), cold L2 (the inputs and outputs of more calls than fill 150 MB,
    # in turn); single calls (events around one wrapper call on an idle
    # card, host work included) and eager back-to-back calls (10 wrapper
    # calls between events; the host's part of a call shows where it is
    # longer than the kernel) beside them.
    kernels = {}

    for P in (512, 1024):  # inference and training sample counts
        samples, coarse, window = vote_inputs(np.random.RandomState(0), 8, P, 480, 640)
        s_t, c_t, w_t = (torch.from_numpy(a).to(dev) for a in (samples, coarse, window))
        for label, cen, gw in ((f"synthetic coarse (S=8, P={P}, 160x120 grid)", c_t, 160),
                               (f"synthetic refine (S=8, P={P}, 256 per slot)", w_t, 0)):
            r = time_votes([(s_t, cen, gw)], cold=False)
            phase(3, vote_line(label, r, 8 * P * cen.shape[2]))
    vote_frames = [os.path.join("data", "lov_syn_val_v4", f) for f in sorted(os.listdir(FRAMES_DIR))[:N_FRAMES]]
    for P in (512, 1024):
        ins = [path_vote_inputs(f, P, dev) for f in vote_frames]
        for pass_name, key in (("coarse", "coarse"), ("refine", "window")):
            r = time_votes([(d["samples"], d[key], d["grid_w"] if key == "coarse" else 0) for d in ins], cold=True)
            total = 8 * P * ins[0][key].shape[2]
            phase(3, vote_line(f"path {pass_name} (the {len(vote_frames)} frames' ground truth, S=8, P={P})", r,
                               total))
            if P == 1024:  # the training step's passes
                mean = {k: statistics.fmean(r[k]) for k in ("ms", "single", "plain", "eager")}
                if pass_name == "coarse":
                    kernels["hough_vote"] = dict(
                        max_abs_err=max(r["err"]), ms=mean["ms"], plain_ms=mean["plain"], bound_ms=r["bound"],
                        bound_by=r["by"], library_ms=None, ms_cold_l2=r["cold"], ms_single=mean["single"],
                        ms_eager=mean["eager"], bound_ms_every_valid_pair=r["old"])
                else:
                    kernels["hough_vote"].update(refine_ms=mean["ms"], refine_ms_cold_l2=r["cold"],
                                                 refine_ms_single=mean["single"], refine_bound_ms=r["bound"])
        del ins
    torch.cuda.empty_cache()

    # conv3x3 at conv1_2, 480x640, 64->64, at B=1 (inference) and B=2
    # (training): the trunk's mode (the sum rounded to bf16, the bias added
    # in bf16, ReLU), the Pallas module's (f32 bias + ReLU), zero bias with
    # no ReLU, and dx at B=1 (the video step) and B=2 (flipped, transposed
    # weights folded into the weight image). Within 1 bf16 ulp of the plain version: the same f32
    # sums in another order, each rounded to bf16 once (in the trunk's mode
    # the sum, and the epilogue exactly). Timed three ways,
    # the kernel (its weight image made beforehand) and cuDNN's bf16
    # channels-last conv (with its bias, one call) alike: back to back,
    # cold L2 (rotating through inputs and outputs over 3x the 50 MB L2) and
    # single calls (the host's part of the call included); and the wrapper
    # as the path calls it (the weight image made in the call), single.
    rng = np.random.RandomState(1)
    w_np = (rng.randn(3, 3, 64, 64) * np.sqrt(2.0 / (9 * 64))).astype(np.float32)
    w_t = torch.from_numpy(w_np).to(dev).to(torch.bfloat16)
    b_t = torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32)).to(dev)
    zeros = torch.zeros(64, device=dev)
    for B, label, relu, bf16_bias, b_c in (
        (1, "trunk mode (bf16 bias + ReLU)", True, True, b_t), (1, "bias + ReLU", True, False, b_t),
        (1, "zero bias, no ReLU", False, False, zeros),
        (2, "trunk mode (bf16 bias + ReLU)", True, True, b_t), (2, "bias + ReLU", True, False, b_t),
        (2, "zero bias, no ReLU", False, False, zeros), (1, "dx", False, False, None),
        (2, "dx", False, False, None),
    ):
        dx = b_c is None
        xs = [torch.from_numpy(rng.randn(B, 480, 640, 64).astype(np.float32)).to(dev)]
        xs[0] = (xs[0] if dx else torch.relu(xs[0])).to(torch.bfloat16)  # a cotangent / a ReLU output
        xs += [xs[0].clone() for _ in range(max(3, -(-150_000_000 // xs[0].nbytes)) - 1)]
        x = xs[0]
        if dx:
            w_c = conv3x3.flip_transpose(w_t)  # the plain version's and cuDNN's weights
            wrapper = lambda: conv3x3.conv3x3_dgrad(x, w_t)
            kern_x = functools.partial(conv3x3._launch, wp=conv3x3.pack_weights(w_t, dgrad=True), b=None, flags=0)
            plain = lambda: conv3x3.conv3x3_plain(x, w_c, zeros, False)
        else:
            w_c = w_t
            wrapper = lambda: conv3x3.conv3x3_raw(x, w_t, b_c, relu, bf16_bias)
            kern_x = functools.partial(conv3x3._launch, wp=conv3x3.pack_weights(w_t), b=b_c,
                                       flags=int(relu) | 2 * int(bf16_bias))
            plain = lambda: conv3x3.conv3x3_plain(x, w_c, b_c, relu, bf16_bias)
        y_k, y_w, y_p = kern_x(x), wrapper(), plain()
        torch.cuda.synchronize()
        check(torch.equal(y_k, y_w), f"conv3x3 {label} B={B}: the wrapper differs from the kernel on its image")
        y_c, p_c = y_k, y_p
        if bf16_bias:
            # rounded twice, to bf16 and again with the bias: where the bias
            # cancels most of the sum, 1 ulp of the sum is many ulps of the
            # result. So the sum (the zero-bias launch) is held to 1 ulp and
            # the epilogue exactly to the kernel's own rounded sum.
            y_c, p_c = kern_x(x, b=None, flags=0), conv3x3.conv3x3_plain(x, w_c, zeros, False)
            check(torch.equal(y_k, torch.relu(y_c + b_c.to(torch.bfloat16))),
                  f"conv3x3 {label} B={B}: the trunk epilogue differs from relu(bf16 sum + bf16 bias)")
        ulps = bf16_ulp_excess(y_c, p_c)
        err = (y_k.float() - y_p.float()).abs().max().item()
        check(ulps <= 1.0, f"conv3x3 {label} B={B}: kernel {ulps:.3g} bf16 ulps from the plain version")
        w_l = w_c.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b_l = None if dx or not bool(b_c.any()) else b_c.to(torch.bfloat16)
        lib_x = lambda xi: F.conv2d(xi.permute(0, 3, 1, 2), w_l, b_l, padding=1)  # NHWC as channels_last
        kern = lambda: kern_x(x)
        lib = lambda: lib_x(x)
        t = {"kernel": [median_ms(kern) for _ in range(2)], "cuDNN": [median_ms(lib) for _ in range(2)]}
        k_ms, l_ms = statistics.median(t["kernel"]), statistics.median(t["cuDNN"])
        k_cold, l_cold = cold_ms(kern_x, xs), cold_ms(lib_x, xs)
        k_one, l_one, w_one = single_ms(kern), single_ms(lib), single_ms(wrapper)
        p_ms = median_ms(plain, reps=5, inner=2)
        b_ms, b_by = conv_bound(B, 480, 640, 64, 64)
        if B == 2 and label.startswith("trunk"):  # conv1_2 of the training step
            kernels["conv3x3"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                      library_ms=l_ms, ms_cold_l2=k_cold, ms_single=k_one, library_ms_cold_l2=l_cold,
                                      library_ms_single=l_one, wrapper_ms_single=w_one)
        extra = ""
        if label.startswith("trunk"):  # what the trunk ran before its bias and ReLU moved into the kernel
            lib3 = lambda: torch.relu(lib() + b_t.to(torch.bfloat16).view(1, -1, 1, 1))  # NCHW view
            extra = f"; cuDNN + bf16 bias add + ReLU (3 calls) {median_ms(lib3) * 1e3:.1f} us back to back"
        phase(3, f"conv3x3 {label}, B={B}, 480x640, 64->64: {ulps:.3g} bf16 ulps at most (limit 1"
                 f"{'; the sum, with the epilogue exact' if bf16_bias else ''}), max|err| "
                 f"{err:.3g}; kernel {k_ms * 1e3:.1f} us back to back, {k_cold * 1e3:.1f} cold L2, {k_one * 1e3:.1f} "
                 f"single (wrapper with its weight image {w_one * 1e3:.1f}); cuDNN bf16 {l_ms * 1e3:.1f} / "
                 f"{l_cold * 1e3:.1f} / {l_one * 1e3:.1f} us; plain {p_ms * 1e3:.1f} us; bound {b_ms * 1e3:.1f} us "
                 f"({b_by}){extra} (back to back: a call in 10, median of 20, runs {t}; cold: {len(xs)} inputs "
                 f"and outputs in turn, median of 10 rounds; single: events around one call, median of 20)")
    # the later phases' peak memory must not count this phase's tensors
    del x, xs, y_k, y_w, y_p, y_c, p_c, kern, kern_x, lib, lib_x, wrapper, plain
    torch.cuda.empty_cache()
    toy_phase3(kernels, w_t, dev)

    # phase 4: Hough voting on the card against the JAX golden
    before = voting.VOTE_LAUNCHES
    h = hough_on_golden_frame(dev)
    torch.cuda.synchronize()
    check(voting.VOTE_LAUNCHES == before + 2, "hough_voting did not launch the kernel twice")
    e = check_hough_golden(h)
    phase(4, f"hough_voting on frame v4/000000's ground truth: {e['detections']} detections, classes "
             f"{e['classes']} match JAX; rois max|err| {e['rois']:.3g} (atol 1e-3), poses_init "
             f"{e['poses_init']:.3g} (atol 1e-4)")

    # phase 5: the whole network on the card against the JAX golden
    e = check_slice_golden(*small_slice_on_golden(dev))
    phase(5, "small slice (f32, TF32 off) against JAX, labels, valid rows and classes exact: "
             + "; ".join(f"{k} max|err| {v:.3g}" for k, v in e.items())
             + " (score, vertex_pred within 1e-5 x max; rois 1e-3, poses_init 1e-4, poses_tanh 1e-5)")
    e = check_train_golden(*small_train_on_golden(dev))
    phase(5, "small training step (f32, TF32 off) against JAX: "
             + "; ".join(f"{k} max|err| {v:.3g}" for k, v in e.items())
             + " (losses and grad norm 1e-5 relative; each grad 5e-5 x its max; the update from the golden grads)")

    # phase 6: flagship inference through the user entry points
    fn, (model, raw0, meta0, extents) = entry(dev)
    ex = fn(model, raw0, meta0, extents)
    shapes = [tuple(x.shape) for x in ex]
    check(shapes == [(1, 480, 640), (1, 480, 640, 66), (8, 7), (8, 7), (8, 88)], f"entry shapes {shapes}")
    check(all(bool(torch.isfinite(x.float()).all()) for x in ex), "entry outputs not finite")
    infer = make_inference_fn(flagship_cfg(is_train=False), PIXEL_MEANS, dev)
    files = sorted(os.listdir(FRAMES_DIR))[:N_FRAMES]
    frames = []
    for fname in files:
        with np.load(os.path.join(FRAMES_DIR, fname)) as f:
            frames.append((np.ascontiguousarray(f["color"][None]), build_meta_data(f["intrinsic_matrix"])[None]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dev_ms, host_ms, n_rois, outs = [], [], [], []
    voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = 0
    for color, meta in frames:
        t0 = time.perf_counter()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = infer(model, torch.from_numpy(color).to(dev), torch.from_numpy(meta).to(dev), extents)
        e1.record()
        rois, poses = postprocess_detections(out)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(e0.elapsed_time(e1))
        check(out["label_2d"].shape == (1, 480, 640) and out["rois"].shape == (8, 7), "output shapes")
        check(all(bool(torch.isfinite(out[k]).all()) for k in ("rois", "poses_init", "poses_tanh")), "not finite")
        check(np.isfinite(rois).all() and np.isfinite(poses).all() and poses.shape == (rois.shape[0], 7), "host")
        n_rois.append(int(out["num_rois"]))
        outs.append({k: v.cpu() for k, v in out.items()})
    launches = voting.VOTE_LAUNCHES
    conv_launches = conv3x3.CONV3X3_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    check(launches == 2 * len(frames), f"hough_vote launched {launches} times for {len(frames)} frames")
    check(conv_launches == len(frames), f"conv3x3 launched {conv_launches} times for {len(frames)} frames")
    infer_launches = {"hough_vote": launches, "conv3x3": conv_launches}
    lat = statistics.median(dev_ms[N_WARMUP:])
    phase(6, f"flagship 640x480 bf16, {len(frames)} frames: per-frame {lat:.3f} ms stream (CUDA events around "
             f"the call, host gaps included; median of frames {N_WARMUP + 1}-{len(frames)}; first {dev_ms[0]:.1f} ms), "
             f"{statistics.median(host_ms[N_WARMUP:]):.3f} ms wall incl. NMS; num_rois {n_rois}; launches "
             f"{infer_launches}; peak memory {peak / 2**20:.1f} MiB")
    print(f"per-frame stream ms {[round(x, 3) for x in dev_ms]}; wall ms {[round(x, 3) for x in host_ms]}", flush=True)

    # the card against the CPU port (held to JAX by the CPU tests), same
    # model and frames, at bf16 limits: the two round the bf16 convolutions'
    # f32 sums in other orders, so a few labels flip and near-tied vote
    # counts can move a centre by a pixel or two
    infer_cpu = make_inference_fn(flagship_cfg(is_train=False), PIXEL_MEANS, "cpu")
    model_cpu = copy.deepcopy(model).cpu()
    t0, agree, box_err, vote_err = time.perf_counter(), [], 0.0, 0.0
    for (color, meta), out in list(zip(frames, outs))[:N_CPU_FRAMES]:
        ref = infer_cpu(model_cpu, torch.from_numpy(color), torch.from_numpy(meta), extents.cpu())
        agree.append(float((out["label_2d"] == ref["label_2d"]).double().mean()))
        check(torch.equal(out["rois_valid"], ref["rois_valid"]), "valid slots differ from the CPU port")
        rois, ref_rois = out["rois"], ref["rois"]
        check(torch.equal(rois[:, :2], ref_rois[:, :2]), "roi batch or class differs from the CPU port")
        box_err = max(box_err, (rois[:, 2:6] - ref_rois[:, 2:6]).abs().max().item())
        vote_err = max(vote_err, (rois[:, 6] - ref_rois[:, 6]).abs().max().item())
    check(min(agree) >= 0.999 and box_err <= 4.0 and vote_err <= 2.0,
          f"card against CPU: label agreement {agree}, roi box max|err| {box_err} px, votes {vote_err}")
    phase(6, f"card against the CPU port on the first {N_CPU_FRAMES} of the frames ({time.perf_counter() - t0:.1f} s): "
             f"label_2d agreement min {min(agree):.6f} (limit 0.999), valid slots and classes equal, roi box "
             f"max|err| {box_err:.3g} px (limit 4), votes max|err| {vote_err:.3g} (limit 2)")

    del model, infer, outs
    torch.cuda.empty_cache()

    # phase 7: flagship training through the user entry point
    t0 = time.perf_counter()
    step, state, bank = train_entry(dev)
    _, hp = flagship_train_cfg()
    sched = T.lr_schedule(hp)
    model0 = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    phase(7, f"train_entry: seed-0 model, bank of {bank['data'].shape[0]} frames on the card "
             f"({sum(v.numel() * v.element_size() for v in bank.values()) / 2**20:.1f} MiB) in "
             f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(RNG_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_wall, losses, per_step = [], [], [], []
    first_draws = first_grads = None
    voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = 0
    for i in range(N_STEPS):
        v0, c0 = voting.VOTE_LAUNCHES, conv3x3.CONV3X3_LAUNCHES
        draws = T.Draws(gen, record=(i == 0))
        lr_expected = sched(state.step)
        t0 = time.perf_counter()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(state, bank, draws)
        e1.record()
        e1.synchronize()
        step_wall.append((time.perf_counter() - t0) * 1e3)
        step_ms.append(e0.elapsed_time(e1))
        losses.append({k: float(v) for k, v in out.items()})
        per_step.append((voting.VOTE_LAUNCHES - v0, conv3x3.CONV3X3_LAUNCHES - c0))
        check(losses[-1]["lr"] == lr_expected, f"step {i}: lr {losses[-1]['lr']} is not lr_schedule({i})")
        if i == 0:
            first_draws = {k: v.cpu() for k, v in draws.recorded.items()}
            first_grads = {k: p.grad.detach().float().cpu() for k, p in state.model.named_parameters()
                           if p.grad is not None}
    train_launches = {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    check(all(p == (4, 2) for p in per_step), f"launches (hough_vote, conv3x3) per step {per_step}, want (4, 2)")
    check(all(np.isfinite(v) for m in losses for v in m.values()), f"losses not finite: {losses}")
    check(any(m["loss_pose"] > 0 for m in losses), "loss_pose is 0 on every step: the pose branch is inert")
    moved = max(float((v.cpu() - model0[k]).abs().max()) for k, v in state.model.state_dict().items())
    check(moved > 0 and state.step == N_STEPS, f"parameters did not move ({moved}) or step {state.step}")
    phase(7, f"flagship training B=2 640x480 bf16, {N_STEPS} steps: per-step {statistics.median(step_ms[2:]):.3f} ms "
             f"stream (CUDA events around the step, host gaps included; median of steps 3-{N_STEPS}; first "
             f"{step_ms[0]:.1f} ms), {statistics.median(step_wall[2:]):.3f} ms wall; peak memory {peak / 2**20:.1f} "
             f"MiB; launches {train_launches} ({per_step[0]} a step); largest parameter move {moved:.3g}")
    for i, m in enumerate(losses):
        print(f"step {i + 1}: " + " ".join(f"{k} {v:.6g}" for k, v in sorted(m.items())), flush=True)
    print(f"per-step stream ms {[round(x, 3) for x in step_ms]}; wall ms {[round(x, 3) for x in step_wall]}", flush=True)

    # the card's first step against the CPU port: the same model, batch and
    # draws (replayed), forward and backward, on the CPU thread (`defer`)
    cfg, hp = flagship_train_cfg()
    model_cpu = copy.deepcopy(state.model).cpu()
    model_cpu.load_state_dict(model0)
    bank_cpu = {k: v.cpu() for k, v in bank.items()}
    loss0 = losses[0]

    def step_on_cpu(model_cpu=model_cpu, bank_cpu=bank_cpu, cfg=cfg, hp=hp, loss0=loss0, first_draws=first_draws,
                    first_grads=first_grads):
        t0 = time.perf_counter()
        state_cpu = T.create_train_state(model_cpu, hp)
        replay = T.Draws(replay=first_draws)
        batch = T.sample_batch(bank_cpu, 2, 24, True, True, replay)
        points, symmetry, extents = (torch.from_numpy(a) for a in train_objects(cfg.num_classes))
        loss_cpu, ref = T.compute_losses(model_cpu, cfg, hp, batch, points, symmetry, extents, replay)
        ref = {k: float(v.detach()) for k, v in ref.items()}
        ref["grad_norm"] = float(T.train_update(state_cpu, loss_cpu, sched(0)))
        rel = {k: abs(loss0[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in TRAIN_LOSS_LIMITS}
        # each gradient: max |card - CPU| over the CPU's largest magnitude
        grad_rel = {}
        for k, p in model_cpu.named_parameters():
            g = p.grad.float()
            grad_rel[k] = float((first_grads[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        worst = sorted(grad_rel, key=grad_rel.get, reverse=True)[:3]
        check(all(rel[k] <= lim for k, lim in TRAIN_LOSS_LIMITS.items())
              and all(grad_rel[k] <= lim for k, lim in TRAIN_GRAD_LIMITS.items()),
              f"card against CPU on step 1: relative errors {rel}, limits {TRAIN_LOSS_LIMITS}; gradients "
              + ", ".join(f"{k} {grad_rel[k]:.3g}" for k in list(TRAIN_GRAD_LIMITS) + worst)
              + f", limits {TRAIN_GRAD_LIMITS}")
        phase(7, f"card against the CPU port on step 1 ({time.perf_counter() - t0:.1f} s on the CPU thread): "
                 + "; ".join(f"{k} {loss0[k]:.6g} vs {ref[k]:.6g}, rel {rel[k]:.3g} (limit {TRAIN_LOSS_LIMITS[k]})"
                             for k in TRAIN_LOSS_LIMITS)
                 + "; " + "; ".join(f"{k} gradient {grad_rel[k]:.3g} of its largest magnitude (limit {lim})"
                                    for k, lim in TRAIN_GRAD_LIMITS.items())
                 + "; worst gradients (not held: the pose head follows Hough's rois) "
                 + ", ".join(f"{k} {grad_rel[k]:.3g}" for k in worst)
                 + f"; loss_pose {loss0['loss_pose']:.6g} vs {ref['loss_pose']:.6g} (not held: Hough follows labels)")

    defer(7, "the flagship step on the CPU port", step_on_cpu)

    # the rest of the run drives the CLIs (`run_cli`); their scratch
    # directory (under the git-ignored output/) goes at the end
    os.makedirs(os.path.join(ROOT, "output"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "output"))
    try:
        final, seed0, train_launches_cli = snapshot_phase(state, model0, work, dev)
        del state, bank
        torch.cuda.empty_cache()
        eval_launches = eval_phase(final, seed0, work, dev)
        toy_launches = toy_phase(work, dev)
        refresh_launches = refresh_phase(work, dev)
        input_launches = input_modes_phase(work, dev)
        nms_record, det_launches = det_3d_phase(work, dev)
        slice_j_launches = full_adapt_gan_phase(work, dev)
        dataset_launches = datasets_phase(work, dev)
        mesh_launches = mesh_phase(work, dev, smi)
        surface_launches = cli_surface_phase(work, dev, seed0)
        video_launches = video_phase(work, dev)
        serving_launches = serving_phase(work, dev, seed0, kernels)
        drain()
    finally:
        _stop_children()
        shutil.rmtree(work, ignore_errors=True)

    print_timeline()
    print(smi, flush=True)
    sources = {"hough_vote": ("posecnn_torch/csrc/hough_vote.cu", "posecnn_tpu/ops/pallas/voting.py:36"),
               "conv3x3": ("posecnn_torch/csrc/conv3x3.cu", "posecnn_tpu/ops/pallas/conv3x3.py:72")}
    det_paths = {f"launches_{path}": n for path, n in {**det_launches, **slice_j_launches, **dataset_launches,
                                                        **mesh_launches, **surface_launches,
                                                        **video_launches, **serving_launches}.items()}
    line = [{"name": k, "route": "cuda", "source": sources[k][0], "replaces": sources[k][1],
             "launches": train_launches[k], "launches_inference": infer_launches[k], "launches_eval": eval_launches[k],
             "launches_train_cli": train_launches_cli[k], "launches_toy_train_cli": toy_launches["train"][k],
             "launches_toy_eval": toy_launches["eval"][k], "launches_refresh_cli": refresh_launches["cli"][k],
             "launches_refresh_ab": refresh_launches["ab"][k],
             **{f"launches_{path}": n[k] for path, n in input_launches.items()},
             **{key: n[k] for key, n in det_paths.items()}, **kernels[k]}
            for k in ("hough_vote", "conv3x3")]
    # the NMS kernel has no Pallas counterpart: it replaces the JAX
    # package's fori_loop sweep, nms_jax; its main path is the detection
    # trainer's run (phase 13 (b))
    line.append({"name": "nms", "route": "cuda", "source": "posecnn_torch/csrc/nms.cu",
                 "replaces": "posecnn_tpu/ops/nms.py:38", "launches": det_launches["det_train_cli"]["nms"],
                 **{key: n["nms"] for key, n in det_paths.items()}, **nms_record})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2]))
    sys.exit(main())
