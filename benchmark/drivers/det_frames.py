"""The detection step (NETWORK VGG16DET): the step `train_net.det_run`
builds for a cfg (`engine/train.py:make_det_train_step` on
`core/config.py:det_model_cfg` and `det_hparams`), run by
`engine/train.py:Solver.train` with steps back to back over detection
batches staged on the card (`engine/train.py:det_batch_from_frame` of each
frozen frame, one frame a step).

From the seed: the weights (drawn on the device, `reference/_plain.py:
make_weights`), the order of the staged batches (a permutation, cycled),
the check steps' frames and their draws. The Solver's draws in the window
stay its own, as `det_run` runs them.

The reference follows the program's selections (`reference/
det_vgg16_ycb.py`): the check steps record the program's RPN scores, its
decoded proposals, NMS's keep mask, the kept proposals and the sampled
RoIs and their labels of each step, and the reference checks the first
step's row by row.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
import os
from dataclasses import replace
from typing import Dict, List

import torch

from benchmark.drivers import frozen_optimizer, leaf_norms, param_snapshot, trace_leaves
from benchmark.harness import ROOT, Readings, sub_seed
from benchmark.reference import _plain as P
from benchmark.reference import det_vgg16_ycb as ref
from benchmark.reference import posecnn_vgg16_ycb as flagship

PLANTS = ("frozen", "nms_skipped", "rois_shifted")
# the shift of the "rois_shifted" fault: one cell of conv5_3
ROI_SHIFT_PX = 16.0


def _defaults(fn) -> Dict:
    params = inspect.signature(fn).parameters.items()
    return {k: p.default for k, p in params if p.default is not inspect.Parameter.empty}


def check_config(cf: Dict, dc, hp, cfg_file) -> None:
    """The configuration's file against what the program's cfg builders
    made of its cfg (and the program's anchor and proposal target layers'
    defaults, which no cfg key sets): the reference reads the one, the
    program the other. The `reduced` keys are the file's: LEARNING_RATE is
    applied to the program's hyperparameters, and the detection trainer
    takes one frame a step whatever IMS_PER_BATCH says."""
    from posecnn_torch.ops import rpn

    at, pt = _defaults(rpn.anchor_target_layer), _defaults(rpn.proposal_target_layer)
    pairs = {
        "NUM_CLASSES": dc.num_classes, "anchor_scales": list(dc.anchor_scales), "anchor_ratios": list(dc.anchor_ratios),
        "feature_stride": dc.feature_stride, "RPN_PRE_NMS_TOP_N": dc.rpn_pre_nms_top_n,
        "RPN_POST_NMS_TOP_N": dc.rpn_post_nms_top_n, "RPN_NMS_THRESH": dc.rpn_nms_thresh,
        "ROI_BATCH_SIZE": dc.roi_batch_size, "fc_dim": dc.fc_dim, "keep_prob": dc.keep_prob,
        "trunk_scale": dc.trunk_scale, "COMPUTE_DTYPE": str(dc.compute_dtype).replace("torch.", ""),
        "WEIGHT_REG": hp.weight_reg, "MOMENTUM": hp.momentum, "GAMMA": hp.gamma,
        "STEPSIZE": hp.stepsize, "GRAD_CLIP": hp.clip_grad_norm, "POSE_W": hp.pose_w, "POSE_MARGIN": hp.margin,
        "PIXEL_MEANS": list(hp.pixel_means), "MAX_GT": cfg_file.TPU.MAX_GT,
        "rpn_targets.batchsize": at["rpn_batchsize"], "rpn_targets.fg_fraction": at["fg_fraction"],
        "rpn_targets.positive_overlap": at["positive_overlap"], "rpn_targets.negative_overlap": at["negative_overlap"],
        "roi_targets.fg_fraction": pt["fg_fraction"], "roi_targets.fg_thresh": pt["fg_thresh"],
        "roi_targets.bg_thresh_hi": pt["bg_thresh_hi"], "roi_targets.bg_thresh_lo": pt["bg_thresh_lo"],
        "roi_targets.bbox_normalize_stds": list(pt["bbox_normalize_stds"]),
    }
    want = dict(cf, **{f"rpn_targets.{k}": v for k, v in cf["rpn_targets"].items()},
                **{f"roi_targets.{k}": v for k, v in cf["roi_targets"].items()})
    want.setdefault("trunk_scale", 1.0)
    bad = {k: (want.get(k), v) for k, v in pairs.items() if want.get(k) != v}
    if bad or not dc.is_train or at["clobber_positives"] or at["positive_weight"] >= 0:
        raise ValueError(f"the configuration's file and the program's cfg differ: {bad}")


def match_rows(sampled: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """Each sampled RoI row's index among the kept proposals (its exact
    copy), -1 for a zero row (past the sampled)."""
    a, b = sampled.detach().cpu(), rois.detach().cpu()
    eq = (a[:, None, :] == b[None, :, :]).all(-1)
    return torch.where(eq.any(1) & (a != 0).any(1), eq.to(torch.uint8).argmax(1), torch.full((), -1)).long()


class Cell:
    def __init__(self, spec, seed: int, device, log, shared=None):
        from posecnn_torch.core import config as C
        from posecnn_torch.data.lov_syn import LovSynVal
        from posecnn_torch.data.minibatch import rescale_points
        from posecnn_torch.engine import train as T
        from posecnn_torch.engine.test import set_float32_precision
        from posecnn_torch.models.detection import VGG16Det

        self.spec, self.seed, self.device, self.log = spec, seed, torch.device(device), log
        cf = spec.config
        self.cfg_file = C.cfg_from_file(os.path.join(ROOT, cf["cfg_file"]))
        dc = C.det_model_cfg(self.cfg_file, cf["NUM_CLASSES"], train=True)
        over = dict(cf.get("model_overrides", {}))  # the CPU tests' narrow sizes
        if "compute_dtype" in over:
            over["compute_dtype"] = getattr(torch, over["compute_dtype"])
        self.det_cfg = dc = replace(dc, **over)
        hp = replace(C.det_hparams(self.cfg_file), learning_rate=cf["LEARNING_RATE"])
        check_config(cf, dc, hp, self.cfg_file)
        set_float32_precision()
        _, sym, ext, raw = flagship.object_models(cf)
        points = torch.from_numpy(rescale_points(raw, ext, sym)).to(self.device)
        symmetry = torch.from_numpy(sym).to(self.device)
        shared = {} if shared is None else shared  # what a calibration's seeds share
        if "batches" not in shared:
            frames = LovSynVal(cf["frames_dir"])
            shared["batches"] = [T.to_device(T.det_batch_from_frame(frames.load_frame(i), max_gt=cf["MAX_GT"]),
                                              self.device) for i in range(frames.num_images)]
        batches = shared["batches"]
        n = len(batches)
        g = torch.Generator()
        g.manual_seed(sub_seed(seed, "order"))
        self.order = torch.randperm(n, generator=g).tolist()
        self.staged = [batches[i] for i in self.order]
        self._items = itertools.cycle(self.staged)
        n_check = int(spec.workload["check_steps"])
        g.manual_seed(sub_seed(seed, "check frames"))
        # the check steps' frames: all different, drawn from the seed
        self.check_ids = torch.randperm(n, generator=g)[:n_check].tolist()
        self.check_batches = [batches[i] for i in self.check_ids]
        self.H, self.W = batches[0]["data"].shape[1:3]
        model = VGG16Det(dc, device=self.device)
        model.load_state_dict(self.weights(seed), strict=True)
        self.state = T.create_train_state(model, hp)
        self.step_fn = T.make_det_train_step(dc, hp, points, symmetry)
        self.solver_kw = C.solver_settings(self.cfg_file)
        self.draws = [self._make_draws(s) for s in range(n_check)]
        self.frames_per_step = 1
        self.nms_launches: List = []
        self.launches0 = 0

    # ---------------------------------------------------------------- set-up

    def weights(self, seed: int) -> Dict[str, torch.Tensor]:
        return P.make_weights(ref.param_specs(self.spec.config), sub_seed(seed, "weights"), self.device)

    def _make_draws(self, s: int) -> Dict[str, torch.Tensor]:
        """Every random number check step s reads, by the name the program
        asks for it: the anchor and RoI sampling's uniforms and the dropout
        masks' of fc6 and fc7."""
        g = torch.Generator(device=self.device)
        g.manual_seed(sub_seed(self.seed, f"draws/{s}"))
        dc = self.det_cfg
        hf, wf = self.H, self.W
        for _ in range(4):  # the trunk's four 2x2 pools, rounding up
            hf, wf = -(-hf // 2), -(-wf // 2)
        n_anchors = hf * wf * dc.num_anchors
        u = lambda *shape: torch.rand(shape, generator=g, device=self.device)  # noqa: E731
        return {"rpn/anchor_fg": u(n_anchors), "rpn/anchor_bg": u(n_anchors),
                "rpn/target_fg": u(dc.rpn_post_nms_top_n), "rpn/target_bg": u(dc.rpn_post_nms_top_n),
                "dropout/fc6": u(dc.roi_batch_size, dc.fc_dim), "dropout/fc7": u(dc.roi_batch_size, dc.fc_dim)}

    def solver(self, step):
        from posecnn_torch.engine.train import Solver

        return Solver(step, output_dir=None, **self.solver_kw)

    def items(self):
        return self._items

    # ------------------------------------------------------------ check steps

    def check_steps(self, solver, probe, n: int, log) -> Readings:
        from posecnn_torch.engine.train import Draws
        from posecnn_torch.models import detection as D
        from posecnn_torch.ops import nms, rpn

        p0 = param_snapshot(self.state.model)
        terms, follow, grad1, heads, cur = [], [], {}, {}, {}
        cpu = lambda x: x.detach().float().cpu()  # noqa: E731

        def forward_probe(*a, **k):
            out = orig_fwd(*a, **k)
            cur.update(kept=cpu(out["rois_raw"][:, 1:5]), rows=match_rows(out["rois"], out["rois_raw"]),
                       labels=out["labels"].detach().long().cpu())
            follow.append(dict(cur))
            cur.clear()
            if not heads:  # the first step's RPN maps and head outputs
                heads.update({k: cpu(out[k]) for k in ("rpn_cls_score", "rpn_bbox_pred", "cls_score", "bbox_pred",
                                                       "poses_tanh")})
                # its kept proposals and sampled RoIs, each row as the
                # reference's own selections find it: 1 where they agree
                # (`reference/det_vgg16_ycb.py:checked_selections`)
                heads.update(proposals=torch.ones(out["rois_raw"].shape[0]), roi_rows=torch.ones(out["rois"].shape[0]))
            return out

        def proposal_probe(prob, deltas, anchors, im_info, num_anchors, **kw):
            cur["scores"] = cpu(prob[:, :, num_anchors:].reshape(-1))
            return orig_prop(prob, deltas, anchors, im_info, num_anchors, **kw)

        def clip_probe(boxes, im_shape):
            out = orig_clip(boxes, im_shape)
            cur["boxes"] = cpu(out)
            return out

        def nms_probe(boxes, thresh):
            keep = orig_nms(boxes, thresh)
            cur["keep"] = keep.detach().cpu()
            return keep

        def after(state, out, draws):
            terms.append({k: float(v) for k, v in out.items() if k.startswith("loss") or k == "grad_norm"})
            if state.step == 1:
                grad1.update(leaf_norms(trace_leaves(state)))

        probe.draws_for = lambda step: Draws(replay=self.draws[step])
        probe.after = after
        orig_fwd, orig_prop, orig_clip, orig_nms = D.vgg16_det_forward, D.proposal_layer, rpn.clip_boxes, \
            rpn.nms_keep_sorted
        D.vgg16_det_forward, D.proposal_layer, rpn.clip_boxes, rpn.nms_keep_sorted = \
            forward_probe, proposal_probe, clip_probe, nms_probe
        try:
            solver.train(iter(self.check_batches), self.state, n, log=log, start_iter=0, handle_signals=False)
        finally:
            D.vgg16_det_forward, D.proposal_layer, rpn.clip_boxes, rpn.nms_keep_sorted = \
                orig_fwd, orig_prop, orig_clip, orig_nms
            probe.draws_for = probe.after = None
        move = leaf_norms((k, p - p0[k]) for k, p in self.state.model.named_parameters())
        del p0
        self.launches0 = nms.NMS_LAUNCHES  # the window's count starts here
        return Readings([t["loss"] for t in terms], terms, grad1, move, follow=follow, heads=heads)

    def reference_steps(self, n: int) -> List[Dict]:
        return [{"frames": [i], "draws": {k: v.cpu() for k, v in d.items()}}
                for i, d in zip(self.check_ids[:n], self.draws[:n])]

    @contextlib.contextmanager
    def plant(self, name):
        """A fault planted in the program for the check steps (`PLANTS`)."""
        if name is None:
            yield
            return
        if name not in PLANTS:
            raise ValueError(f"no fault {name!r} here (faults: {PLANTS})")
        if name == "frozen":
            with frozen_optimizer():
                yield
            return
        from posecnn_torch.models import detection as D
        from posecnn_torch.ops import rpn

        if name == "nms_skipped":
            # the top proposals taken without NMS: every box kept
            owner, attr = rpn, "nms_keep_sorted"
            value = lambda boxes, thresh: torch.ones(boxes.shape[0], dtype=torch.bool, device=boxes.device)  # noqa
        else:
            # the sampled RoIs shifted right before the crop pool
            owner, attr, orig = D, "crop_pool_batched", D.crop_pool_batched

            def value(feat, rois, *a, **k):
                shift = torch.tensor([0, 0, ROI_SHIFT_PX, 0, ROI_SHIFT_PX, 0, 0], device=rois.device)
                return orig(feat, rois + shift, *a, **k)

        before = getattr(owner, attr)
        setattr(owner, attr, value)
        try:
            yield
        finally:
            setattr(owner, attr, before)

    # ---------------------------------------------------------------- window

    @contextlib.contextmanager
    def trace_hooks(self, tracer):
        """Keep each NMS launch's boxes and keep mask in the traced steps,
        for the NMS kernel's bound."""
        from posecnn_torch.ops import rpn

        orig = rpn.nms_keep_sorted

        def recorded(boxes, thresh):
            keep = orig(boxes, thresh)
            if tracer.active:
                self.nms_launches.append((boxes, keep, thresh))
            return keep

        rpn.nms_keep_sorted = recorded
        try:
            yield
        finally:
            rpn.nms_keep_sorted = orig

    def flops_per_step(self) -> float:
        from benchmark.counts.det import det_step_flops

        dc = self.det_cfg
        return det_step_flops(self.H, self.W, dc.num_classes, dc.num_anchors, dc.roi_batch_size, dc.fc_dim)

    def conv3x3_shape(self):
        """(B, H, W, Cin, Cout) of each conv3x3 launch: conv1_2 forward and dx."""
        return (1, self.H, self.W, 64, 64)

    def window_notes(self, run) -> Dict:
        from posecnn_torch.ops import conv3x3, nms, voting

        # the boxes NMS kept a step, from the traced steps' keep masks
        traced = len(run.traced)
        kept = sum(int(k.sum()) for _, k, _ in self.nms_launches) / traced if traced else None
        return {"launches": {"nms": nms.NMS_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES,
                             "hough_vote": voting.VOTE_LAUNCHES},
                "nms_per_step": {"launches": (nms.NMS_LAUNCHES - self.launches0) / max(run.steps, 1), "kept": kept}}

    def free(self) -> None:
        self.state = self.staged = self._items = self.step_fn = self.check_batches = None
