"""The flagship PoseCNN training step over the device bank: the step
`train_net.cfg_run` builds for a TPU.DEVICE_BANK config
(`engine/train.py:make_bank_train_step` on the cfg's model and
hyperparameters, the bank of `data/device_bank.py:build_bank`), run by
`engine/train.py:Solver.train` with steps back to back.

From the seed: the weights (drawn on the device, `reference/_plain.py:
make_weights`), the order of the bank's frames (a permutation of its rows,
so the Solver's own index draws pick other frames for each seed), and the
draws of the check steps. The Solver's draws in the window stay its own,
as train_net runs them.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from dataclasses import replace
from typing import Dict, List

import torch

from benchmark.drivers import frozen_optimizer, leaf_norms, param_snapshot, trace_leaves
from benchmark.harness import ROOT, Readings, sub_seed
from benchmark.reference import _plain as P
from benchmark.reference import posecnn_vgg16_ycb as ref

PLANTS = ("frozen", "half_batch", "altered")


def check_config(cf: Dict, mc, hp, cfg_file) -> None:
    """The configuration's file against what the program's cfg builders
    made of its cfg: the reference reads the one, the program the other."""
    h, lo = cf["hough"], cf["loss"]
    pairs = {
        "NUM_UNITS": mc.num_units, "keep_prob": mc.keep_prob, "threshold_label": mc.threshold_label,
        "fc_dim": mc.fc_dim, "trunk_scale": mc.trunk_scale, "hough.slots": mc.hough_class_slots,
        "hough.samples": mc.hough_max_samples, "hough.center_stride": mc.hough_center_stride,
        "hough.refine_window": mc.hough_refine_window, "hough.pixel_stride": mc.hough_pixel_stride,
        "hough.sampler": mc.hough_sampler, "hough.label_threshold": mc.label_threshold,
        "hough.gt_mix": mc.hough_gt_mix, "WEIGHT_REG": hp.weight_reg, "LEARNING_RATE": hp.learning_rate,
        "MOMENTUM": hp.momentum, "GAMMA": hp.gamma, "STEPSIZE": hp.stepsize, "GRAD_CLIP": hp.clip_grad_norm,
        "POSE_MARGIN": hp.margin, "POSE_NORM_VALID": hp.pose_norm_valid, "QUAT_AUX_W": hp.quat_w,
        "loss.vertex_w": hp.vertex_w, "loss.vertex_w_inside": hp.vertex_w_inside, "loss.pose_w": hp.pose_w,
        "IMS_PER_BATCH": cfg_file.TRAIN.IMS_PER_BATCH, "MAX_GT": cfg_file.TPU.MAX_GT,
        "CHROMATIC": cfg_file.TRAIN.CHROMATIC, "ADD_NOISE": cfg_file.TRAIN.ADD_NOISE,
    }
    want = dict(cf, **{f"hough.{k}": v for k, v in h.items()}, **{f"loss.{k}": v for k, v in lo.items()})
    want.setdefault("trunk_scale", 1.0)
    bad = {k: (want.get(k), v) for k, v in pairs.items() if want.get(k) != v}
    if bad or not (mc.use_crop_pool and mc.vertex_reg and mc.pose_reg and not mc.adaptation):
        raise ValueError(f"the configuration's file and the program's cfg differ: {bad}")


class Cell:
    def __init__(self, spec, seed: int, device, log, shared=None):
        from posecnn_torch.core import config as C
        from posecnn_torch.data.device_bank import bank_to_device, build_bank
        from posecnn_torch.data.lov_syn import LovSynVal
        from posecnn_torch.data.minibatch import rescale_points
        from posecnn_torch.engine import train as T
        from posecnn_torch.engine.test import set_float32_precision
        from posecnn_torch.models.posecnn import PoseCNN

        self.spec, self.seed, self.device, self.log = spec, seed, torch.device(device), log
        cf = spec.config
        self.cfg_file = C.cfg_from_file(os.path.join(ROOT, cf["cfg_file"]))
        model_cfg = C.train_model_cfg(self.cfg_file, cf["NUM_CLASSES"])
        if "model_overrides" in cf:  # the CPU tests' narrow sizes
            model_cfg = replace(model_cfg, **cf["model_overrides"])
        self.model_cfg = model_cfg
        hp = C.train_hparams(self.cfg_file)
        mcfg = C.minibatch_cfg(self.cfg_file, cf["NUM_CLASSES"])
        check_config(cf, model_cfg, hp, self.cfg_file)
        set_float32_precision()
        _, sym, ext, raw = ref.object_models(cf)
        pts = rescale_points(raw, ext, sym, mcfg.is_symmetric)
        consts = [torch.from_numpy(a).to(self.device) for a in (pts, sym, ext)]
        T_ = self.cfg_file.TRAIN
        self.B = T_.IMS_PER_BATCH
        shared = {} if shared is None else shared  # what a calibration's seeds share
        if "bank" not in shared:
            shared["bank"] = bank_to_device(build_bank(LovSynVal(spec.config["frames_dir"]), mcfg.max_gt),
                                            self.device)
        bank = shared["bank"]
        g = torch.Generator(device=self.device)
        g.manual_seed(sub_seed(seed, "order"))
        self.perm = torch.randperm(bank["data"].shape[0], generator=g, device=self.device)
        self.bank = {k: v[self.perm] for k, v in bank.items()}
        del bank
        self.H, self.W = self.bank["data"].shape[1:3]
        self.step_fn = T.make_bank_train_step(model_cfg, hp, *consts, batch_size=self.B,
                                              max_gt=self.cfg_file.TPU.MAX_GT, chromatic=T_.CHROMATIC,
                                              add_noise=T_.ADD_NOISE)
        model = PoseCNN(model_cfg, device=self.device)
        model.load_state_dict(self.weights(seed), strict=True)
        self.state = T.create_train_state(model, hp)
        self.solver_kw = C.solver_settings(self.cfg_file)
        n_check = int(spec.workload["check_steps"])
        g.manual_seed(sub_seed(seed, "check rows"))
        # the check steps' frames: all different, drawn from the seed
        self.check_rows = torch.randperm(self.bank["data"].shape[0], generator=g,
                                         device=self.device)[:n_check * self.B]
        self.draws = [self._make_draws(s) for s in range(n_check)]
        self.frames_per_step = self.B
        self.roi_rows = self.B * model_cfg.hough_class_slots * 9
        self.vote_launches: List = []

    # ---------------------------------------------------------------- set-up

    def weights(self, seed: int) -> Dict[str, torch.Tensor]:
        return P.make_weights(ref.param_specs(self.spec.config), sub_seed(seed, "weights"), self.device)

    def _make_draws(self, s: int) -> Dict[str, torch.Tensor]:
        """Every random number check step s reads, by the name the program
        asks for it: the batch's frames (`check_rows`), the jitter and the noise,
        the dropout masks' uniforms, Hough's ground-truth mix."""
        g = torch.Generator(device=self.device)
        g.manual_seed(sub_seed(self.seed, f"draws/{s}"))
        B, dev, mc = self.B, self.device, self.model_cfg
        h8, w8 = -(-self.H // 8), -(-self.W // 8)
        R = B * mc.hough_class_slots * 9
        u = lambda *shape: torch.rand(shape, generator=g, device=dev)  # noqa: E731
        d = {"bank/index": self.check_rows[s * B:(s + 1) * B].clone()}
        d["chroma"] = u(B, 3)
        d["noise/gate"] = u(B)
        d["noise/sigma"] = u(B)
        d["noise/field"] = torch.randn((B, self.H, self.W), generator=g, device=dev)
        d["dropout/add_score"] = u(B, h8, w8, mc.num_units)
        d["dropout/addv"] = u(B, h8, w8, 128)
        d["hough_gt_mix"] = u(B)
        d["dropout/fc6"] = u(R, mc.fc_dim)
        d["dropout/fc7"] = u(R, mc.fc_dim)
        return d

    def solver(self, step):
        from posecnn_torch.engine.train import Solver

        return Solver(step, output_dir=None, **self.solver_kw)

    def items(self):
        return itertools.repeat(self.bank)

    # ------------------------------------------------------------ check steps

    def check_steps(self, solver, probe, n: int, log) -> Readings:
        from posecnn_torch.engine import train as T
        from posecnn_torch.engine.train import Draws
        from posecnn_torch.models import posecnn as M

        p0 = param_snapshot(self.state.model)
        terms, hough, follow, grad1, heads = [], [], [], {}, {}

        def forward_probe(*a, **k):
            out = orig_fwd(*a, **k)
            if not heads:  # the first step's label and vertex heads
                heads.update(score=out["score"].detach().float().cpu(), vert=out["vertex_pred"].detach().float().cpu())
            return out

        def hough_probe(label, vert, extents, meta, gt, **kw):
            out = orig(label, vert, extents, meta, gt, **kw)
            follow.append({"label": label.detach().to(torch.int32).cpu(), "vert": vert.detach().float().cpu()})
            hough.append({"rois": out.rois.detach().cpu(), "poses_init": out.poses_init.detach().cpu(),
                          "valid": out.valid.detach().cpu()})
            return out

        def after(state, out, draws):
            terms.append({k: float(v) for k, v in out.items() if k.startswith("loss") or k == "grad_norm"})
            if state.step == 1:
                grad1.update(leaf_norms(trace_leaves(state)))

        probe.draws_for = lambda step: Draws(replay=self.draws[step])
        probe.after = after
        orig, orig_fwd = M.hough_voting, T.posecnn_forward
        M.hough_voting, T.posecnn_forward = hough_probe, forward_probe
        try:
            solver.train(self.items(), self.state, n, log=log, start_iter=0, handle_signals=False)
        finally:
            M.hough_voting, T.posecnn_forward = orig, orig_fwd
            probe.draws_for = probe.after = None
        move = leaf_norms((k, p - p0[k]) for k, p in self.state.model.named_parameters())
        del p0
        return Readings([t["loss"] for t in terms], terms, grad1, move, hough, follow, heads)

    def reference_steps(self, n: int) -> List[Dict]:
        return [{"frames": self.perm[d["bank/index"]].cpu().numpy(), "draws": {k: v.cpu() for k, v in d.items()}}
                for d in self.draws[:n]]

    @contextlib.contextmanager
    def plant(self, name):
        """A fault planted in the program for the check steps (`PLANTS`)."""
        if name is None:
            yield
            return
        if name not in PLANTS:
            raise ValueError(f"no fault {name!r} here (faults: {PLANTS})")
        from posecnn_torch.engine import train as T
        from posecnn_torch.models import posecnn as M

        if name == "frozen":
            with frozen_optimizer():
                yield
            return
        if name == "half_batch":
            orig = T.sample_batch

            def half(bank, batch_size, max_gt, chromatic, add_noise, draws):
                # the second image replaced by the first: the step's means
                # are over the first half of the batch alone
                b = orig(bank, batch_size, max_gt, chromatic, add_noise, draws)
                keep = batch_size // 2
                for k in ("data", "gt_label_2d", "meta_data", "gt_centers"):
                    b[k] = torch.cat([b[k][:keep]] * (batch_size // keep))
                rows = b["poses"][(b["poses"][:, 0] < keep) & (b["poses"][:, 1] > 0)]
                reps = [rows.clone() for _ in range(batch_size // keep)]
                for j, r in enumerate(reps):
                    r[:, 0] += j * keep
                rows = torch.cat(reps)[:max_gt]
                b["poses"] = torch.zeros_like(b["poses"])
                b["poses"][:rows.shape[0]] = rows
                return b

            T.sample_batch = half
            try:
                yield
            finally:
                T.sample_batch = orig
            return
        orig_h = M.hough_voting

        def shifted(*a, **k):
            # the answer altered where it is produced: every detection's box
            # moved 16 px to the right
            out = orig_h(*a, **k)
            rois = out.rois.clone()
            rois[:, 2:6] += torch.tensor([16.0, 0.0, 16.0, 0.0], device=rois.device) * out.valid[:, None]
            return out._replace(rois=rois)

        M.hough_voting = shifted
        try:
            yield
        finally:
            M.hough_voting = orig_h

    # ---------------------------------------------------------------- window

    @contextlib.contextmanager
    def trace_hooks(self, tracer):
        """Keep the inputs of each vote launch in the traced steps, for the
        vote kernel's bound."""
        from posecnn_torch.ops import hough_voting as HV

        orig = HV.accumulate_votes

        def recorded(samples, centers, grid_w=0):
            if tracer.active:
                self.vote_launches.append((samples, centers))
            return orig(samples, centers, grid_w=grid_w)

        HV.accumulate_votes = recorded
        try:
            yield
        finally:
            HV.accumulate_votes = orig

    def flops_per_step(self) -> float:
        from benchmark.counts import posecnn_step_flops

        cf = self.spec.config
        return posecnn_step_flops(self.B, self.H, self.W, cf["NUM_CLASSES"], cf["NUM_UNITS"], self.roi_rows,
                                  cf["fc_dim"])

    def conv3x3_shape(self):
        """(B, H, W, Cin, Cout) of each conv3x3 launch: conv1_2 forward and dx."""
        return (self.B, self.H, self.W, 64, 64)

    def window_notes(self, run) -> Dict:
        from posecnn_torch.ops import conv3x3, voting

        return {"launches": {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES}}

    def free(self) -> None:
        self.state = self.bank = self.step_fn = None
