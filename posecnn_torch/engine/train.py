"""Training engine: the loss, the optimizer, the host-fed and device-bank
steps, and the training loop.

Port of `posecnn_tpu/engine/train.py` for the PoseCNN training steps
(`compute_losses`, `make_train_step` on one device, with its
`forward_fn` hook for VGG16FULL, `make_bank_train_step`, the training loop
of `Solver`) and the segmentation step (`make_seg_train_step`, FCN-8s):

  * losses as the reference's `train_net` assembles them: L2 regularization
    (`upscore*` carry none, and the port holds no parameters for them),
    the fused hard-label cross entropy, the fused vertex smooth-L1, the
    ADD/ADD-S loss (normalized by the valid Hough rows with
    `pose_norm_valid`), the quaternion auxiliary loss, the render-and-compare
    matching loss at `matching_w` (TRAIN.MATCHING, `ops/matching_loss.py`,
    on the raw metre-scale clouds) and, with the domain head
    (`adaptation`), the domain cross entropy at `adapt_weight`;
  * the optimizer is momentum SGD at unit learning rate after global-norm
    clipping; the step scales the update by `lr_schedule(hp)(step)`, where
    `step` is the solver's counter. No learning rate lives in any state
    (hazard 7: a scheduler's or optimizer's own step count re-initialized by
    a light resume would apply the undecayed rate while the log shows the
    decayed one);
  * the host-fed step takes a host minibatch moved to the device
    (`to_device`); the bank step samples the batch and the augmentation
    draws on the device. Random numbers come from a `torch.Generator`,
    through a `Draws` object that a test or a check can record and replay;
  * `Solver` snapshots the state in the JAX npz layout
    (`core/checkpoint.py`), resumes from the latest snapshot, and snapshots
    on SIGTERM or SIGINT before it returns;
  * the video model's step (`make_video_train_step`);
  * over a mesh of ranks (`parallel/mesh.py`), the step computes the
    one-process step's function on the global batch, as JAX's sharded jit
    does: every normalizer that spans the batch is the global batch's (the
    local sum over the count all-reduced over the data group), the L2 term
    is counted once, the gradients are summed over the data group, the
    clipping norm counts a sharded gradient's rows over the model group,
    and the draws with a batch axis are drawn at the global batch's shape
    and sliced. The Solver's rank 0 alone logs and writes.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from posecnn_torch.config import PIXEL_MEANS, RNG_SEED, PoseCNNConfig
from posecnn_torch.core.profiler import LAYERS, Recorder, recording, span
from posecnn_torch.models.posecnn import PoseCNN, posecnn_forward
from posecnn_torch.ops.add_loss import average_distance_loss
from posecnn_torch.ops.chromatic import add_noise_field, chromatic_device
from posecnn_torch.ops.losses import (loss_cross_entropy_hard_label_sparse, loss_cross_entropy_single_frame,
                                      smooth_l1_loss_vertex, sparse_softmax_cross_entropy)
from posecnn_torch.ops.matching_loss import render_compare_batched
from posecnn_torch.ops.vertex_targets import smooth_l1_loss_vertex_sparse, smooth_l1_loss_vertex_sparse3d
from posecnn_torch.utils.debug_nans import jitted


@dataclass(frozen=True)
class TrainHParams:
    """`engine/train.py:TrainHParams`, field for field (same defaults)."""

    learning_rate: float = 0.001
    momentum: float = 0.9
    gamma: float = 0.1
    stepsize: int = 30000
    weight_reg: float = 0.0001
    vertex_w: float = 5.0
    pose_w: float = 1.0
    adapt_weight: float = 0.1
    margin: float = 0.01
    pose_norm_valid: bool = False
    vertex_w_inside: float = 10.0
    vertex_z_obj_norm: bool = False
    matching_w: float = 0.0
    quat_w: float = 0.0
    clip_grad_norm: float = 0.0
    pixel_means: Tuple[float, float, float] = PIXEL_MEANS


def lr_schedule(hp: TrainHParams) -> Callable[[int], float]:
    """Staircase exponential decay (tf.train.exponential_decay, staircase):
    learning_rate * gamma ** (step // stepsize)."""

    def sched(step: int) -> float:
        return hp.learning_rate * hp.gamma ** (int(step) // hp.stepsize)

    return sched


# the draws with a batch axis (images, or Hough's rows, which go image by
# image): over a data mesh each rank draws them at the global batch's shape
# and keeps its rows
BATCH_DRAWS = ("dropout/", "hough_gt_mix", "noise/field")


class Draws:
    """The random numbers of one training step, by name.

    Drawn from `generator` on the step's device, and kept when `record`;
    with `replay`, the recorded tensors are handed back instead (moved to
    the asking device), so one step can be run again elsewhere with the same
    randomness. `sharded(n, i)` gives rank i of n data ranks its view."""

    def __init__(self, generator: Optional[torch.Generator] = None, replay: Optional[Dict[str, torch.Tensor]] = None,
                 record: bool = False):
        self.generator = generator
        self.replay = replay
        self.recorded: Optional[Dict[str, torch.Tensor]] = {} if record else None
        self.shard: Optional[Tuple[int, int]] = None

    def sharded(self, n: int, i: int) -> "Draws":
        """The same draws (generator, replay and record shared) as rank i of
        n data ranks: a draw of `BATCH_DRAWS` is made (or replayed, or
        recorded) at n times its leading size and its i-th block of rows is
        handed back, so the draws of ranks whose generators share one seed
        are the one-process step's."""
        out = Draws(self.generator, self.replay)
        out.recorded, out.shard = self.recorded, (n, i)
        return out

    def _get(self, name: str, device, make) -> torch.Tensor:
        if self.replay is not None:
            return self.replay[name].to(device)
        x = make()
        if self.recorded is not None:
            self.recorded[name] = x
        return x

    def _batched(self, name: str, shape, device, make) -> torch.Tensor:
        shape = tuple(shape)
        if self.shard is None or self.shard[0] == 1 or not name.startswith(BATCH_DRAWS):
            return self._get(name, device, lambda: make(shape))
        n, i = self.shard
        x = self._get(name, device, lambda: make((n * shape[0],) + shape[1:]))
        return x[i * shape[0]:(i + 1) * shape[0]]

    def uniform(self, name: str, shape, device) -> torch.Tensor:
        return self._batched(name, shape, device,
                             lambda s: torch.rand(s, generator=self.generator, device=device))

    def normal(self, name: str, shape, device) -> torch.Tensor:
        return self._batched(name, shape, device,
                             lambda s: torch.randn(s, generator=self.generator, device=device))

    def randint(self, name: str, high: int, shape, device) -> torch.Tensor:
        return self._get(
            name, device, lambda: torch.randint(0, high, tuple(shape), generator=self.generator, device=device)
        )

    def choice(self, name: str, p: torch.Tensor, shape) -> torch.Tensor:
        """Indices into the last axis of `p` (..., N), drawn with replacement
        with probabilities p, `shape` of them for each leading row (...,
        *shape): `jax.random.choice(key, N, shape, p=p)`'s formula, the
        cumulative sum searched for cumsum[-1] * (1 - u). A replay hands
        back the recorded indices."""
        def make():
            cum = torch.cumsum(p, dim=-1)
            lead = p.shape[:-1]
            u = torch.rand(tuple(lead) + tuple(shape), generator=self.generator, device=p.device)
            r = cum[..., -1:].reshape(tuple(lead) + (1,) * len(shape)) * (1 - u)
            idx = torch.searchsorted(cum.contiguous(), r.reshape(tuple(lead) + (-1,)).contiguous())
            return idx.reshape(u.shape)

        return self._get(name, p.device, make)


class MomentumSGD:
    """`optax.chain(clip_by_global_norm(clip), sgd(1.0, momentum))`: the
    gradients are clipped to a global norm (0 = off), the momentum trace is
    g + momentum * trace, and the parameters move by -lr * trace with the lr
    handed to `step`. Its state is the trace alone; there is no lr in it.
    Parameters are updated in place."""

    def __init__(self, params: List[torch.Tensor], momentum: float, clip_grad_norm: float = 0.0):
        self.params = list(params)
        self.momentum = momentum
        self.clip = clip_grad_norm
        self.trace = [torch.zeros_like(p) for p in self.params]

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients of the whole parameters: the
        squares of a parameter split over a model axis (`tp_mesh`) are summed
        over its model group, a replicated one's counted once."""
        from posecnn_torch.parallel.mesh import tp_mesh

        whole, split, mesh = [], [], None
        for p, g in zip(self.params, grads):
            sq = (g.float() * g.float()).sum()
            if tp_mesh(p) is None:
                whole.append(sq)
            else:
                split.append(sq)
                mesh = tp_mesh(p)
        total = sum(whole)
        if split:
            total = total + mesh.model_sum(sum(split))
        return torch.sqrt(total)

    @torch.no_grad()
    def step(self, lr: float) -> torch.Tensor:
        """Apply one update from the parameters' .grad; returns the global
        gradient norm before clipping."""
        with span("optimizer"):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
            g_norm = self.global_norm(grads)
            if self.clip > 0:
                keep = g_norm < self.clip
                grads = [torch.where(keep, g, (g / g_norm) * self.clip) for g in grads]
            for p, g, t in zip(self.params, grads, self.trace):
                t.mul_(self.momentum).add_(g)
                p.add_(t, alpha=-lr)
            return g_norm

    def state_dict(self) -> Dict[str, List[torch.Tensor]]:
        return {"trace": self.trace}


@dataclass
class TrainState:
    """(params, opt_state, step) of the JAX package: the model, the
    optimizer's trace and the solver's step counter."""

    model: torch.nn.Module  # models.posecnn.PoseCNN or models.fcn8.FCN8
    optimizer: MomentumSGD
    step: int = 0


def create_train_state(model: PoseCNN, hp: TrainHParams, step: int = 0) -> TrainState:
    model.train()
    return TrainState(model, MomentumSGD(list(model.parameters()), hp.momentum, hp.clip_grad_norm), step)


def regularization_loss(model: PoseCNN, scale: float) -> torch.Tensor:
    """scale * sum(w^2) / 2 over every conv and fc weight and bias
    (`train.py:regularization_loss`); the bilinear `upscore*` filters are
    not parameters of the port."""
    total = sum((p * p).sum() for p in model.parameters())
    return scale * 0.5 * total


def mesh_regularization_loss(model: PoseCNN, scale: float, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The L2 term over a mesh: (the term this rank differentiates, its
    share of the reported value). The first is this rank's
    `regularization_loss` (its rows of a split parameter, every replicated
    one) on the data axis's rank 0, and zero elsewhere, so the gradients'
    sum over the data group holds it once. The second, detached, is the
    whole term (a split parameter's squares summed over the model group) on
    data rank 0 and zero elsewhere, so its sum over the data group is the
    one-process value."""
    from posecnn_torch.parallel.mesh import tp_mesh

    whole = sum((p * p).sum() for p in model.parameters() if tp_mesh(p) is None)
    split = [(p * p).sum() for p in model.parameters() if tp_mesh(p) is not None]
    local = scale * 0.5 * (whole + sum(split)) if split else scale * 0.5 * whole
    reported = scale * 0.5 * (whole.detach() + mesh.model_sum(sum(split))) if split else local.detach()
    if mesh.d == 0:
        return local, reported
    return local * 0.0, torch.zeros_like(reported)


def preprocess(data: torch.Tensor, hp: TrainHParams, batch: Dict[str, torch.Tensor], draws: Optional[Draws]) -> torch.Tensor:
    """uint8 BGR -> mean-subtracted float, with the HLS jitter and the noise
    field when the batch asks for them (`train.py:173-194`)."""
    means = torch.tensor(hp.pixel_means, dtype=torch.float32, device=data.device).reshape(1, 1, 1, 3)
    if data.dtype != torch.uint8:
        return data
    data = data.to(torch.float32)
    if "chroma_dhls" in batch:
        data = chromatic_device(data, batch["chroma_dhls"])
    if "noise_sigma" in batch:
        field = draws.normal("noise/field", data.shape[:3], data.device)
        data = add_noise_field(data, batch["noise_sigma"], field)
    return data - means


def compute_losses(
    model: PoseCNN,
    model_cfg: PoseCNNConfig,
    hp: TrainHParams,
    batch: Dict[str, torch.Tensor],
    points: torch.Tensor,
    symmetry: torch.Tensor,
    extents: torch.Tensor,
    draws: Optional[Draws] = None,
    forward_fn: Optional[Callable] = None,
    ce_threshold: Optional[float] = None,
    mesh=None,
    points_raw: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The flagship loss (`train.py:compute_losses`): returns (loss, the
    named loss terms). `forward_fn` is the network (default
    `posecnn_forward`; `posecnn_full.posecnn_full_forward` for VGG16FULL,
    which reads no `data_p`) and `ce_threshold` the hard-label gate of the
    cross entropy in place of `threshold_label` (VGG16FULL: 0.7).
    `points_raw` (C,P,3) are the metre-scale clouds the matching loss
    renders (`points` where None, as in JAX). A uint8
    `data_p` (the RGBD input's depth image) has the pixel means subtracted
    and nothing else. Without `draws`, random numbers come from torch's
    default generator.

    With a `mesh` (`parallel/mesh.py`) of several data ranks, `batch` is
    this rank's part of the global batch (`mesh.shard_batch`) and each term
    is this rank's share of the global batch's: its local sum over the
    global count (the hard-label gate's, the vertex weights', the valid
    Hough rows'; all-reduced over the data group), and its mean over the
    global rows (ADD's, the domain loss's R). The shares sum to the
    one-process terms over the data group; the L2 term is
    `mesh_regularization_loss`'s. The matching loss reads the intrinsics
    of the global batch's first image on every rank (JAX's
    `meta_data[0]`, ROADMAP Queue 3 item 55)."""
    draws = draws if draws is not None else Draws()
    n_data = 1 if mesh is None else mesh.data
    total = None if n_data == 1 else mesh.data_sum
    forward = posecnn_forward if forward_fn is None else forward_fn
    thr = model_cfg.threshold_label if ce_threshold is None else ce_threshold
    with span("sample"):
        data = preprocess(batch["data"], hp, batch, draws)
        data_p = batch.get("data_p") if forward is posecnn_forward else None
        if data_p is not None and data_p.dtype == torch.uint8:
            # the RGBD depth image: the pixel means only (train.py:205-208)
            data_p = data_p.to(torch.float32) - torch.tensor(hp.pixel_means, device=data_p.device).reshape(1, 1, 1, 3)
    out = forward(
        model, model_cfg, data, extents, batch["meta_data"], gt_poses=batch.get("poses"),
        gt_label_2d=batch["gt_label_2d"], gt_centers=batch.get("gt_centers"), draws=draws, data_p=data_p,
    )
    with span("losses"):
        losses: Dict[str, torch.Tensor] = {}
        if mesh is None:
            loss = regularization_loss(model, hp.weight_reg)
            losses["loss_regu"] = loss
        else:
            loss, losses["loss_regu"] = mesh_regularization_loss(model, hp.weight_reg, mesh)
        loss_cls = loss_cross_entropy_hard_label_sparse(out["score"], batch["gt_label_2d"], thr, total)
        losses["loss_cls"] = loss_cls
        loss = loss + loss_cls
        if model_cfg.vertex_reg:
            if "vertex_targets3" in batch:
                # VERTEX_REG_3D: the compact scaled object coordinates (train.py:225-232)
                loss_vertex = hp.vertex_w * smooth_l1_loss_vertex_sparse3d(
                    out["vertex_pred"], batch["gt_label_2d"], batch["vertex_targets3"], batch["vertex_weights3"],
                    model_cfg.num_classes, total=total,
                )
            elif "vertex_targets" in batch:
                # dense host targets, TPU.DEVICE_TARGETS False (train.py:234-238)
                loss_vertex = hp.vertex_w * smooth_l1_loss_vertex(
                    out["vertex_pred"], batch["vertex_targets"], batch["vertex_weights"], total=total)
            else:
                loss_vertex = hp.vertex_w * smooth_l1_loss_vertex_sparse(
                    out["vertex_pred"], batch["gt_label_2d"], batch["gt_centers"], model_cfg.num_classes,
                    hp.vertex_w_inside, z_obj_norm=hp.vertex_z_obj_norm, total=total,
                )
            losses["loss_vertex"] = loss_vertex
            loss = loss + loss_vertex
            if model_cfg.pose_reg:
                poses_pred = out["poses_pred"]
                n_rows = poses_pred.shape[0] * n_data  # the global batch's rows
                valid = out["rois_valid"].float().sum()
                n_valid = torch.clamp(valid if total is None else total(valid), min=1.0)
                loss_pose = average_distance_loss(
                    poses_pred, out["poses_target"], out["poses_weight"], points, symmetry, hp.margin
                )
                if n_data > 1:
                    loss_pose = loss_pose / n_data  # the mean over the global rows
                if hp.pose_norm_valid:
                    loss_pose = loss_pose * (n_rows / n_valid)
                loss_pose = hp.pose_w * loss_pose
                losses["loss_pose"] = loss_pose
                loss = loss + loss_pose
                if hp.quat_w > 0:
                    Cq = poses_pred.shape[1] // 4
                    qp = poses_pred.reshape(-1, Cq, 4)
                    qt = out["poses_target"].reshape(-1, Cq, 4)
                    wq = out["poses_weight"].reshape(-1, Cq, 4)[..., 0]
                    nonsym = (symmetry[:Cq] <= 0).float()[None, :]
                    per_roi = torch.minimum(((qp - qt) ** 2).sum(dim=-1), ((qp + qt) ** 2).sum(dim=-1)) * wq * nonsym
                    loss_quat = hp.quat_w * per_roi.sum() / n_valid
                    losses["loss_quat"] = loss_quat
                    loss = loss + loss_quat
                if hp.matching_w > 0:
                    # render and compare (train.py:288-308): the first image's
                    # intrinsics for every row; over a mesh the global batch's
                    # first image, data rank 0's
                    meta0 = batch["meta_data"][0]
                    if n_data > 1:
                        meta0 = total(meta0 if mesh.d == 0 else torch.zeros_like(meta0))
                    loss_match = hp.matching_w * render_compare_batched(
                        poses_pred, out["poses_target"], out["poses_weight"], out["poses_init"], out["rois"],
                        points if points_raw is None else points_raw, meta0, model_cfg.num_classes, total=total)
                    losses["loss_matching"] = loss_match
                    loss = loss + loss_match
                if model_cfg.adaptation:
                    # the mean over all R rows, invalid ones (domain 0) included
                    # (train.py:311-316)
                    loss_domain = hp.adapt_weight * sparse_softmax_cross_entropy(out["domain_score"],
                                                                                 out["label_domain"])
                    if n_data > 1:
                        loss_domain = loss_domain / n_data
                    losses["loss_domain"] = loss_domain
                    loss = loss + loss_domain
        if mesh is None:
            losses["loss"] = loss
        else:
            losses["loss"] = sum(v.detach() for v in losses.values())
    return loss, losses


def assemble_pose_rows(rows: torch.Tensor, max_gt: int) -> torch.Tensor:
    """(B,G,13) per-frame GT pose rows -> the (max_gt,13) batch `poses`
    (`train.py:_assemble_pose_rows`): column 0 becomes the image index of
    each real row, real rows go first in their order (a stable sort), and
    the result is cut or zero-padded to max_gt rows."""
    B, G, _ = rows.shape
    valid = rows[:, :, 1] > 0
    bidx = torch.arange(B, dtype=rows.dtype, device=rows.device)[:, None].expand(B, G)
    rows = rows.clone()
    rows[:, :, 0] = torch.where(valid, bidx, torch.zeros((), dtype=rows.dtype, device=rows.device))
    flat = rows.reshape(B * G, 13)
    order = torch.sort((~valid.reshape(B * G)).to(torch.uint8), stable=True).indices
    flat = flat[order]
    if B * G >= max_gt:
        return flat[:max_gt]
    out = torch.zeros((max_gt, 13), dtype=flat.dtype, device=flat.device)
    out[: B * G] = flat
    return out


def sample_batch(bank: Dict[str, torch.Tensor], batch_size: int, max_gt: int, chromatic: bool, add_noise: bool,
                 draws: Draws) -> Dict[str, torch.Tensor]:
    """The batch and its augmentation parameters, drawn on the bank's device
    (`train.py:445-471`): frames uniformly with replacement; HLS deltas
    U(-.5,.5) * (0.02*180, 0.2*256, 0.2*256); noise on 90% of the images
    with sigma = sqrt(U(0,1) * 0.3 * 256)."""
    dev = bank["data"].device
    idx = draws.randint("bank/index", bank["data"].shape[0], (batch_size,), dev)
    batch = {
        "data": bank["data"][idx],
        "gt_label_2d": bank["label"][idx].to(torch.int32),
        "meta_data": bank["meta_data"][idx],
        "gt_centers": bank["gt_centers"][idx],
        "poses": assemble_pose_rows(bank["pose_rows"][idx], max_gt),
    }
    if chromatic:
        u = draws.uniform("chroma", (batch_size, 3), dev) - 0.5
        batch["chroma_dhls"] = u * torch.tensor([0.02 * 180.0, 0.2 * 256.0, 0.2 * 256.0], device=dev)
    if add_noise:
        gate = draws.uniform("noise/gate", (batch_size,), dev) < 0.9
        sigma = torch.sqrt(draws.uniform("noise/sigma", (batch_size,), dev) * 0.3 * 256.0)
        batch["noise_sigma"] = torch.where(gate, sigma, torch.zeros((), device=dev))
    return batch


def train_update(state: TrainState, loss: torch.Tensor, lr: float, mesh=None) -> torch.Tensor:
    """Backward and one optimizer update at `lr`; returns the gradient's
    global norm before clipping. With a `mesh`, the gradients are summed
    over its data group first (one all-reduce of them all, flattened)."""
    params = state.optimizer.params
    for p in params:
        p.grad = None
    with span("backward"):
        loss.backward()
    if mesh is not None and mesh.data > 1:
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            flat = mesh.data_sum(torch.cat([g.reshape(-1) for g in grads]))
            for p, g in zip(params, torch.split(flat, [g.numel() for g in grads])):
                p.grad = g.view_as(p)
    g_norm = state.optimizer.step(lr)
    state.step += 1
    return g_norm


def make_bank_train_step(
    model_cfg: PoseCNNConfig,
    hp: TrainHParams,
    points: torch.Tensor,
    symmetry: torch.Tensor,
    extents: torch.Tensor,
    batch_size: int,
    max_gt: int = 24,
    chromatic: bool = False,
    add_noise: bool = False,
    points_raw: Optional[torch.Tensor] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor], Draws], Dict[str, torch.Tensor]]:
    """Train step over a device bank (`train.py:make_bank_train_step`):
    step(state, bank, draws) samples the batch, computes the losses and
    their gradients, and updates the state in place at
    lr_schedule(hp)(state.step). `points_raw` as in `compute_losses`.
    Returns the loss terms (detached), the lr and the gradient norm."""
    host_step = make_train_step(model_cfg, hp, points, symmetry, extents, points_raw=points_raw)

    def step_fn(state: TrainState, bank: Dict[str, torch.Tensor], draws: Draws) -> Dict[str, torch.Tensor]:
        with span("sample"):
            batch = sample_batch(bank, batch_size, max_gt, chromatic, add_noise, draws)
        return host_step(state, batch, draws)

    return step_fn


def make_train_step(
    model_cfg: PoseCNNConfig,
    hp: TrainHParams,
    points: torch.Tensor,
    symmetry: torch.Tensor,
    extents: torch.Tensor,
    forward_fn: Optional[Callable] = None,
    ce_threshold: Optional[float] = None,
    mesh=None,
    points_raw: Optional[torch.Tensor] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor], Draws], Dict[str, torch.Tensor]]:
    """Train step over a batch on the device (`train.py:make_train_step`):
    step(state, batch, draws) computes the losses and their gradients and
    updates the state in place at lr_schedule(hp)(state.step). `batch` is a
    host minibatch (`data.minibatch.get_minibatch`) moved to the device
    (`to_device`). `forward_fn`, `ce_threshold` and `points_raw` as in
    `compute_losses` (VGG16FULL: `posecnn_full_forward`, 0.7). Returns the loss terms
    (detached), the lr and the gradient norm.

    `mesh` None is the one-process step. With a mesh (`parallel/mesh.py`),
    `batch` is this rank's part of the global batch (`mesh.shard_batch`),
    the model has been split (`mesh.shard_model`) before its state was
    made, and every rank's generator has the same seed: the step then
    computes the one-process step's function on the global batch, up to
    the order of its sums (`compute_losses`, `train_update`), and returns
    the global batch's loss terms on every rank."""
    sched = lr_schedule(hp)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], draws: Draws) -> Dict[str, torch.Tensor]:
        if mesh is not None:
            draws = draws.sharded(mesh.data, mesh.d)
        loss, losses = compute_losses(state.model, model_cfg, hp, batch, points, symmetry, extents, draws,
                                      forward_fn, ce_threshold, mesh, points_raw)
        lr = sched(state.step)
        g_norm = train_update(state, loss, lr, mesh)
        if mesh is not None and mesh.data > 1:
            # the global batch's terms: the ranks' shares summed
            names = list(losses)
            summed = mesh.data_sum(torch.stack([losses[k].detach().float() for k in names]))
            losses = dict(zip(names, summed.unbind()))
        out = {k: v.detach() for k, v in losses.items()}
        out["lr"] = torch.tensor(lr, dtype=torch.float64)
        out["grad_norm"] = g_norm
        return out

    return step_fn


def make_seg_train_step(
    apply_fn: Callable, hp: TrainHParams, num_classes: int
) -> Callable[[TrainState, Dict[str, torch.Tensor], Draws], Dict[str, torch.Tensor]]:
    """Train step of the segmentation networks (`train.py:make_seg_train_step`,
    FCN8VGG and RESNET50): the cross entropy of the log-softmax `prob`
    against the one-hot labels of the pixels with a label >= 0, plus the L2
    term over every parameter but ResNet-50's batch-norm `mean` and
    `variance` (which the update moves all the same, as in JAX; the
    bilinear upscore filters are not parameters). The step reads
    only `data` and `gt_label_2d`: uint8 data has the pixel means subtracted
    and nothing else, so a batch's `chroma_dhls` and `noise_sigma` are not
    applied, as in the JAX step. `apply_fn(model, data, draws)` returns the
    endpoints. step(state, batch, draws) updates the state in place at
    lr_schedule(hp)(state.step) and returns the loss terms (detached), the
    lr and the gradient norm."""
    sched = lr_schedule(hp)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], draws: Draws) -> Dict[str, torch.Tensor]:
        data = batch["data"]
        if data.dtype == torch.uint8:
            data = data.to(torch.float32) - torch.tensor(hp.pixel_means, device=data.device).reshape(1, 1, 1, 3)
        out = apply_fn(state.model, data, draws)
        logp = out["prob"]
        gt = batch["gt_label_2d"].long()
        onehot = torch.nn.functional.one_hot(gt.clamp(0, num_classes - 1), num_classes).to(logp.dtype)
        onehot = onehot * (gt >= 0).to(logp.dtype)[..., None]
        loss_cls = loss_cross_entropy_single_frame(logp, onehot)
        # the L2 term leaves out ResNet-50's batch-norm statistics (bn*)
        reg = sum((p * p).sum() for k, p in state.model.named_parameters() if not k.startswith("bn"))
        loss = loss_cls + hp.weight_reg * 0.5 * reg
        lr = sched(state.step)
        g_norm = train_update(state, loss, lr)
        return {"loss": loss.detach(), "loss_cls": loss_cls.detach(),
                "lr": torch.tensor(lr, dtype=torch.float64), "grad_norm": g_norm}

    return step_fn


def make_video_train_step(video_cfg, hp: TrainHParams, mesh=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Train step of the video model (`train.py:make_video_train_step`
    :739-790): the mean over the T frames of each frame's cross entropy
    (`loss_cross_entropy_single_frame`, one-hot labels; a label outside
    [0, C) weighs nothing), plus the L2 term over every parameter (the
    `upscore*` filters are not parameters); momentum SGD at unit rate (with
    the global-norm clip of `hp`) scaled by lr_schedule(hp)(state.step).
    step(state, batch, draws=None) takes the (T,B,...) batch of
    `data.video_layer.GtDataLayer` on the device (data, gt_label_2d, depth,
    meta_data), updates the state in place and returns the loss terms
    (detached), the lr and the gradient norm.

    With a `mesh` of data ranks, as JAX's sharded step (the batch split over
    its second axis, `P(None, DATA_AXIS)`; the parameters replicated, no
    model axis): `batch` is this rank's images of the global batch
    (`mesh.shard_video_batch`), whose GRU state the rank carries; each
    frame's cross entropy is normalized by the one-hot label sum over the
    data group, the L2 term is counted once, the gradients are summed over
    the data group, and the global batch's terms are returned on every
    rank."""
    from posecnn_torch.models.video import video_forward

    if mesh is not None and mesh.model > 1:
        raise ValueError(f"the video step replicates its parameters (no model axis): mesh {mesh.shape}")
    sched = lr_schedule(hp)
    n_data = 1 if mesh is None else mesh.data
    total = None if n_data == 1 else mesh.data_sum

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], draws: Optional[Draws] = None):
        outs, _ = video_forward(state.model, video_cfg, batch["data"], batch["depth"], batch["meta_data"])
        prob = outs["prob"]
        with span("losses"):
            classes = torch.arange(prob.shape[-1], device=prob.device)
            loss_cls = 0.0
            for t in range(prob.shape[0]):
                onehot = (batch["gt_label_2d"][t].long()[..., None] == classes).to(prob.dtype)
                loss_cls = loss_cls + loss_cross_entropy_single_frame(prob[t], onehot, total)
            loss_cls = loss_cls / prob.shape[0]
            if mesh is None:
                reg = reported = regularization_loss(state.model, hp.weight_reg)
            else:
                reg, reported = mesh_regularization_loss(state.model, hp.weight_reg, mesh)
        lr = sched(state.step)
        g_norm = train_update(state, loss_cls + reg, lr, mesh)
        losses = {"loss_cls": loss_cls.detach(), "loss_regu": reported.detach()}
        losses["loss"] = losses["loss_cls"] + losses["loss_regu"]
        if n_data > 1:
            names = list(losses)
            losses = dict(zip(names, mesh.data_sum(torch.stack([losses[k].float() for k in names])).unbind()))
        return {**losses, "lr": torch.tensor(lr, dtype=torch.float64), "grad_norm": g_norm}

    # JAX jits the step: under DEBUG_NANS its outputs and the parameters
    # are checked, not the NaN points of the state it starts from
    return jitted(step_fn, "the video train step", extra=_step_parameters)


def _step_parameters(state: TrainState, *args) -> List[torch.Tensor]:
    return list(state.model.parameters())


def to_device(item: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch on `device`: numpy arrays are copied there (through pinned
    memory and without blocking the host, on a card), tensors moved (a bank
    already there stays as it is)."""
    dev = torch.device(device)
    out = {}
    for k, v in item.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
            if dev.type == "cuda":
                v = v.pin_memory()
        out[k] = v.to(dev, non_blocking=True)
    return out


def resume_seed(seed: int, start_iter: int) -> int:
    """The step generator's seed for a run that starts at `start_iter`:
    `seed` itself at 0, else a hash of (seed, start_iter) (the counterpart
    of JAX's `fold_in(rng, start_iter)`), so a resumed run never replays
    step 0's draws."""
    if start_iter == 0:
        return seed
    return int(np.random.SeedSequence([seed, start_iter]).generate_state(1)[0])


class Solver:
    """The iteration loop of `engine/train.py:Solver`: one step an
    iteration on the next item of a data iterator (host minibatches, or the
    device bank again and again), each step with its own draws from one
    generator on the model's device, seeded with
    `resume_seed(RNG_SEED, start_iter)`. The next item is fetched and its
    copy to the device started before the step runs, as JAX's solver does.

    Every `display` steps (and at a run's first step) a log line of the
    losses and lr, and with an `output_dir` a row of `train_metrics.csv`
    (`core/metrics.py`). With an `output_dir`, a snapshot every
    `snapshot_iters` steps and at the end (`snapshot_final`), named
    `<snapshot_prefix>_iter_<step>.npz` (or the orbax directory
    `<snapshot_prefix>_iter_<step>` with `snapshot_format` "orbax"), with
    the momentum trace when `snapshot_opt_state`; `resume` restores the
    latest.

    `vis_hook` (TRAIN.VISUALIZE: `engine.visualize.MinibatchVisualizer`) is
    called before each step with (step + 1, the item as the data iterator
    gave it, before its copy to the device), as JAX's solver calls its
    hook; its time is in no step's timings.

    Over a `mesh` of ranks, every rank runs the loop (and resumes from the
    same snapshot) and takes part in each snapshot's gather, rank 0 alone
    logs, writes `train_metrics.csv` and writes the snapshots, and a signal
    seen by any rank stops every rank after the same step (the stop flag is
    all-reduced each step)."""

    def __init__(self, step_fn, output_dir: Optional[str] = None, snapshot_iters: int = 10000,
                 snapshot_prefix: str = "posecnn", display: int = 20, snapshot_opt_state: bool = True,
                 snapshot_final: bool = True, mesh=None, vis_hook=None, snapshot_format: str = "npz"):
        from posecnn_torch.core.metrics import MetricsLogger

        self.mesh = mesh
        self.rank0 = mesh is None or mesh.rank == 0
        # JAX jits the step: under DEBUG_NANS it is checked at its outputs
        self.step_fn = jitted(step_fn, "the train step", extra=_step_parameters)
        self.output_dir = output_dir
        self.snapshot_iters = snapshot_iters
        self.snapshot_prefix = snapshot_prefix
        self.display = display
        self.snapshot_opt_state = snapshot_opt_state
        self.snapshot_final = snapshot_final
        self.snapshot_format = snapshot_format
        self.vis_hook = vis_hook
        self.metrics_logger = MetricsLogger(output_dir) if output_dir and self.rank0 else None

    def resume(self, state: TrainState, log: Optional[Callable[[str], None]] = print) -> Tuple[TrainState, int]:
        """Restore the latest snapshot of `output_dir` into `state`, if there
        is one. Returns (state, the step to start from)."""
        from posecnn_torch.core.checkpoint import latest_checkpoint, restore_checkpoint

        if not self.output_dir:
            return state, 0
        path = latest_checkpoint(self.output_dir, prefix=self.snapshot_prefix)
        if path is None:
            return state, 0
        t0 = time.perf_counter()
        restore_checkpoint(path, state)
        if log and self.rank0:
            log(f"resumed from {path} at iteration {state.step} ({time.perf_counter() - t0:.3f}s)")
        return state, state.step

    def train(self, data_iter: Iterator, state: TrainState, max_iters: int,
              log: Optional[Callable[[str], None]] = print, start_iter: int = 0,
              handle_signals: bool = True, timings: Optional[Dict[str, List[float]]] = None,
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Run steps start_iter .. max_iters - 1 on the items of `data_iter`.
        With `handle_signals`, SIGTERM and SIGINT end the run after the step
        in flight, with a snapshot at that step (unless a periodic one was
        just written), so `resume` restarts from there; the old handlers
        come back on return. A log that raises OSError (a dead pipe) is
        ignored: logging must not stop the snapshot.

        `timings`, when given, gets per-step lists of milliseconds:
        `data_wait` (the host blocked on `data_iter` for the next item),
        `step` (wall, the step's host work), `host/<layer>` for each name of
        `core.profiler.LAYERS` (the host time of the step's spans of that
        layer, 0.0 where it did not run) and, on a card, `step_stream`
        (CUDA events around the step: its span on the device's stream), and
        the count `cuda_malloc` (the caching allocator's new segments, each
        a cudaMalloc, since the step before: one read of its counters, no
        sync). The lists line up index for index. With `timings` the loop
        records spans (`core.profiler.recording`): `step` around each step,
        `fetch` around each fetch, `solver` around its own bookkeeping (the
        log's reads, the stream events' flush, the metrics CSV, snapshots),
        and the step's layer spans inside `step`."""
        if not self.rank0:
            log = None
        if log is not None:
            raw_log = log

            def log(msg, _raw=raw_log):  # noqa: F811
                try:
                    _raw(msg)
                except OSError:
                    pass

        stop = {"flag": False}
        old_handlers = {}
        if handle_signals:
            def on_signal(signum, frame):
                stop["flag"] = True

            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    old_handlers[sig] = signal.signal(sig, on_signal)
                except ValueError:  # not the main thread
                    for s, h in old_handlers.items():
                        signal.signal(s, h)
                    old_handlers.clear()
                    break

        dev = next(state.model.parameters()).device
        cuda = dev.type == "cuda"
        many = self.mesh is not None and self.mesh.world > 1
        gen = torch.Generator(device=dev)
        gen.manual_seed(resume_seed(RNG_SEED, start_iter))
        pending: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

        def fetch():
            with span("fetch"):
                t = time.perf_counter()
                item = next(data_iter)
                if timings is not None:
                    timings.setdefault("data_wait", []).append((time.perf_counter() - t) * 1e3)
                return item, to_device(item, dev)

        def flush_events():
            for e0, e1 in pending:
                e1.synchronize()
                timings.setdefault("step_stream", []).append(e0.elapsed_time(e1))
            pending.clear()

        def segments() -> int:
            return torch.cuda.memory_stats_as_nested_dict(dev)["segment"]["all"]["allocated"]

        recorder = Recorder() if timings is not None else None
        metrics: Dict[str, torch.Tensor] = {}
        last_snap = -1
        t0, n0 = time.perf_counter(), start_iter
        try:
            with recording(recorder):
                batch_next = fetch() if start_iter < max_iters else None
                mallocs = segments() if recorder is not None and cuda else 0
                for it in range(start_iter, max_iters):
                    host, batch = batch_next
                    if it + 1 < max_iters:
                        batch_next = fetch()
                    if self.vis_hook is not None:
                        with span("solver"):
                            self.vis_hook(it + 1, host)
                    with span("step"):
                        t_step = time.perf_counter()
                        if timings is not None and cuda:
                            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                            e0.record()
                        metrics = self.step_fn(state, batch, Draws(gen))
                        if timings is not None:
                            if cuda:
                                e1.record()
                                pending.append((e0, e1))
                            timings.setdefault("step", []).append((time.perf_counter() - t_step) * 1e3)
                    if recorder is not None:
                        host_ms = recorder.take()
                        for name in LAYERS:
                            timings.setdefault("host/" + name, []).append(host_ms.get(name, 0.0))
                        if cuda:
                            mallocs, before = segments(), mallocs
                            timings.setdefault("cuda_malloc", []).append(float(mallocs - before))
                    with span("solver"):
                        display = (it + 1) % self.display == 0
                        if timings is not None and display:
                            flush_events()
                        if log is not None and (display or it == start_iter):
                            m = {k: float(v) for k, v in metrics.items()}
                            dt = (time.perf_counter() - t0) / (it + 1 - n0)
                            log(f"iter {it + 1}/{max_iters} "
                                + " ".join(f"{k}: {v:.6g}" for k, v in sorted(m.items())) + f" ({dt:.3f}s/it)")
                            if display and self.metrics_logger is not None:
                                self.metrics_logger.log(it + 1, {**m, "sec_per_iter": dt})
                            t0, n0 = time.perf_counter(), it + 1
                        if self.output_dir and (it + 1) % self.snapshot_iters == 0:
                            self.snapshot(state, it + 1, log)
                            last_snap = it + 1
                        if many:
                            stop["flag"] = self.mesh.any(stop["flag"], dev)
                        if stop["flag"]:
                            if log:
                                log(f"signal received: snapshotting at iteration {it + 1}")
                            if self.output_dir and last_snap != it + 1:
                                self.snapshot(state, it + 1, log)
                            break
                else:
                    if self.output_dir and self.snapshot_final and last_snap != max_iters:
                        with span("solver"):
                            self.snapshot(state, max_iters, log)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            if self.metrics_logger is not None:
                self.metrics_logger.close()
            if timings is not None:
                flush_events()
        return state, metrics

    def snapshot(self, state: TrainState, it: int, log: Optional[Callable[[str], None]] = None) -> str:
        from posecnn_torch.core.checkpoint import save_checkpoint

        t0 = time.perf_counter()
        path = save_checkpoint(self.output_dir, state, step=it, prefix=self.snapshot_prefix,
                               include_opt_state=self.snapshot_opt_state, fmt=self.snapshot_format, mesh=self.mesh)
        if log and self.rank0:
            size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs) \
                if os.path.isdir(path) else os.path.getsize(path)
            log(f"snapshot {path} ({size / 2**20:.1f} MiB, {time.perf_counter() - t0:.3f}s)")
        return path


# ------------------------------------------------------------- detection path


def det_batch_from_frame(frame, max_gt: int = 24) -> Dict[str, np.ndarray]:
    """The single-image detection batch (`train.py:det_batch_from_frame`):
    the raw colour frame (1,H,W,3) uint8, no jitter and no noise whatever
    the config says; GT boxes (max_gt,5) [x1,y1,x2,y2,cls] from each
    class's label extent (classes with >= 10 pixels, in class order); the
    GT pose rows (max_gt,13)."""
    from posecnn_torch.data.minibatch import pose_rows

    label = frame.label
    boxes = np.zeros((max_gt, 5), np.float32)
    k = 0
    for c in np.unique(label):
        if c <= 0 or k >= max_gt:
            continue
        ys, xs = np.nonzero(label == c)
        if len(xs) < 10:
            continue
        boxes[k] = [xs.min(), ys.min(), xs.max(), ys.max(), c]
        k += 1
    poses = np.zeros((max_gt, 13), np.float32)
    rows = pose_rows(0, frame)
    poses[: min(len(rows), max_gt)] = rows[:max_gt]
    return {"data": frame.color[None].astype(np.uint8), "gt_boxes": boxes, "poses": poses}


def det_losses(model, det_cfg, hp: TrainHParams, batch: Dict[str, torch.Tensor], points: torch.Tensor,
               symmetry: torch.Tensor, draws: Draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The detection loss (`train.py:make_det_train_step`'s losses_fn,
    reference train_net_det): the RPN cross entropy over the anchors with a
    label, the RPN box loss (sigma 3, summed over the anchors), the RCNN
    cross entropy and box loss, the ADD pose loss at pose_w and the L2 term,
    the terms inside the span `losses`. uint8 data has the pixel means
    subtracted and nothing else."""
    from posecnn_torch.models.detection import vgg16_det_forward
    from posecnn_torch.models.layers import log_softmax_hd
    from posecnn_torch.ops.losses import smooth_l1_loss, sparse_softmax_cross_entropy

    data = batch["data"]
    if data.dtype == torch.uint8:
        data = data.to(torch.float32) - torch.tensor(hp.pixel_means, device=data.device).reshape(1, 1, 1, 3)
    out = vgg16_det_forward(model, det_cfg, data, gt_boxes=batch["gt_boxes"], gt_poses=batch["poses"], draws=draws)
    with span("losses"):
        losses: Dict[str, torch.Tensor] = {}
        logits = out["rpn_cls_score"].reshape(-1, 2)
        rpn_labels = out["rpn_labels"].reshape(-1)
        keep = rpn_labels != -1
        lab_safe = torch.where(keep, rpn_labels, torch.zeros((), dtype=rpn_labels.dtype, device=rpn_labels.device))
        ce = -torch.gather(log_softmax_hd(logits), 1, lab_safe.long()[:, None])[:, 0]
        zero = torch.zeros((), device=ce.device)
        losses["loss_rpn_cls"] = torch.where(keep, ce, zero).sum() / torch.clamp(keep.sum(), min=1)
        losses["loss_rpn_box"] = smooth_l1_loss(
            out["rpn_bbox_pred"].reshape(1, -1, 4), out["rpn_bbox_targets"].reshape(1, -1, 4),
            out["rpn_bbox_inside_weights"].reshape(1, -1, 4), out["rpn_bbox_outside_weights"].reshape(1, -1, 4),
            sigma=3.0, dim=(1, 2),
        )
        losses["loss_cls"] = sparse_softmax_cross_entropy(out["cls_score"], out["labels"])
        losses["loss_box"] = smooth_l1_loss(out["bbox_pred"], out["bbox_targets"], out["bbox_inside_weights"],
                                            out["bbox_outside_weights"], dim=(1,))
        losses["loss_pose"] = hp.pose_w * average_distance_loss(
            out["poses_pred"], out["poses_target"], out["poses_weight"], points, symmetry, hp.margin)
        losses["loss_regu"] = regularization_loss(model, hp.weight_reg)
        loss = sum(losses[k] for k in ("loss_rpn_cls", "loss_rpn_box", "loss_cls", "loss_box", "loss_pose",
                                       "loss_regu"))
        losses["loss"] = loss
    return loss, losses


def create_det_train_state(det_cfg, hp: TrainHParams, seed: int, device="cpu") -> TrainState:
    """The detection network's train state from numpy seed `seed`
    (`train.py:create_det_train_state`: its init, a zero momentum trace,
    step 0)."""
    from posecnn_torch.models.detection import init_vgg16_det_params_numpy, make_det_model

    return create_train_state(make_det_model(det_cfg, init_vgg16_det_params_numpy(seed, det_cfg), device), hp)


def make_det_train_step(
    det_cfg, hp: TrainHParams, points: torch.Tensor, symmetry: torch.Tensor
) -> Callable[[TrainState, Dict[str, torch.Tensor], Draws], Dict[str, torch.Tensor]]:
    """The detection train step (`train.py:make_det_train_step`):
    step(state, batch, draws) computes `det_losses` and their gradients
    (through the proposals: nothing on that path is detached, as in JAX)
    and updates the state in place by momentum SGD at
    lr_schedule(hp)(state.step), without clipping (hp.clip_grad_norm is 0
    there). batch: data (1,H,W,3) uint8, gt_boxes (G,5), poses (G,13), on
    the device. Returns the loss terms (detached), the lr and the gradient
    norm."""
    sched = lr_schedule(hp)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], draws: Draws) -> Dict[str, torch.Tensor]:
        loss, losses = det_losses(state.model, det_cfg, hp, batch, points, symmetry, draws)
        lr = sched(state.step)
        g_norm = train_update(state, loss, lr)
        out = {k: v.detach() for k, v in losses.items()}
        out["lr"] = torch.tensor(lr, dtype=torch.float64)
        out["grad_norm"] = g_norm
        return out

    return step_fn
