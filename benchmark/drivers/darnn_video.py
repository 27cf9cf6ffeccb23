"""The DA-RNN video step: `engine/train.py:make_video_train_step` on the
cfg's hyperparameters and a `models/video.py:VideoConfig` of the
configuration's sizes, run by `engine/train.py:Solver.train` with steps
back to back over (T, B) windows of `data/video_layer.py:GtDataLayer`.

From the seed: the weights (drawn on the device) and the windows
(GtDataLayer's generator), which are staged on the device before the
window and handed to the Solver in turn. The frames' labels are folded
into the configuration's classes (`reference.darnn_vgg16_rgbd_scene.
fold_labels`) before the program sees them. The step draws no random
numbers.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from dataclasses import replace
from typing import Dict, List

import numpy as np
import torch

from benchmark.drivers import frozen_optimizer, leaf_norms, param_snapshot, trace_leaves
from benchmark.harness import ROOT, Readings, sub_seed
from benchmark.reference import _plain as P
from benchmark.reference import darnn_vgg16_rgbd_scene as ref

# IMS_PER_BATCH 1: the batch's part that can be left out is frames
PLANTS = ("frozen", "frames_dropped")


class FoldedFrames:
    """The frozen frames as one video, their labels folded; records the
    frames each window reads."""

    def __init__(self, frames, fold: Dict):
        self.frames = frames
        self.fold = fold
        self.image_index = [f"v4/{i:06d}" for i in range(frames.num_images)]
        self.read: List[int] = []

    def load_frame(self, i: int):
        self.read.append(i)
        f = self.frames.load_frame(i)
        return replace(f, label=ref.fold_labels(f.label, self.fold))


class Cell:
    def __init__(self, spec, seed: int, device, log, shared=None):
        from posecnn_torch.core import config as C
        from posecnn_torch.data.lov_syn import LovSynVal
        from posecnn_torch.data.minibatch import MinibatchConfig
        from posecnn_torch.data.video_layer import GtDataLayer
        from posecnn_torch.engine import train as T
        from posecnn_torch.engine.test import set_float32_precision
        from posecnn_torch.models.video import VideoConfig, VideoNet

        self.spec, self.seed, self.device, self.log = spec, seed, torch.device(device), log
        cf = spec.config
        self.cfg_file = C.cfg_from_file(os.path.join(ROOT, cf["cfg_file"]))
        hp = C.train_hparams(self.cfg_file)
        T_ = self.cfg_file.TRAIN
        self.T, self.B = T_.NUM_STEPS, T_.IMS_PER_BATCH
        fl = cf["flow"]
        self.vcfg = VideoConfig(num_classes=cf["NUM_CLASSES"], num_units=cf["NUM_UNITS"], num_steps=self.T,
                                flow_kernel=fl["kernel"], flow_threshold=fl["threshold"],
                                flow_max_weight=fl["max_weight"])
        set_float32_precision()
        shared = {} if shared is None else shared  # what a calibration's seeds share
        if "frames" not in shared:
            shared["frames"] = LovSynVal(cf["frames_dir"])
        frames = FoldedFrames(shared["frames"], cf["label_fold"])
        layer = GtDataLayer(frames, MinibatchConfig(num_classes=cf["NUM_CLASSES"]), num_steps=self.T,
                            ims_per_batch=self.B, seed=sub_seed(seed, "windows") % (1 << 32))
        self.windows, self.staged = [], []
        n_check = int(spec.workload["check_steps"])
        while len(self.staged) < int(spec.traffic["staged_windows"]):
            frames.read.clear()
            batch = layer.forward()
            ids = np.asarray(frames.read).reshape(self.B, self.T).T
            if len(self.windows) < n_check and any(np.array_equal(ids, w) for w in self.windows):
                continue  # the check steps' windows all differ
            self.staged.append(T.to_device(batch, self.device))
            self.windows.append(ids)
        self.H, self.W = self.staged[0]["data"].shape[2:4]
        self._items = itertools.cycle(self.staged)
        model = VideoNet(self.vcfg, device=self.device)
        model.load_state_dict(self.weights(seed), strict=True)
        self.state = T.create_train_state(model, hp)
        self.step_fn = T.make_video_train_step(self.vcfg, hp)
        self.solver_kw = C.solver_settings(self.cfg_file)
        self.frames_per_step = self.T * self.B

    def weights(self, seed: int) -> Dict[str, torch.Tensor]:
        return P.make_weights(ref.param_specs(self.spec.config), sub_seed(seed, "weights"), self.device)

    def solver(self, step):
        from posecnn_torch.engine.train import Solver

        return Solver(step, output_dir=None, **self.solver_kw)

    def items(self):
        return self._items

    def check_steps(self, solver, probe, n: int, log) -> Readings:
        from posecnn_torch.models import video as V

        p0 = param_snapshot(self.state.model)
        terms, grad1, scores, heads, frame_grads = [], {}, [], {}, [0.0] * self.T

        def frame_probe(*a, **k):
            out, state = orig(*a, **k)
            if len(scores) < self.T:  # the first step's frames: label scores, the last GRU state, dL/dscore
                t = len(scores)
                out["score"].register_hook(
                    lambda g: frame_grads.__setitem__(t, float(torch.linalg.vector_norm(g.double()))))
                scores.append(out["score"].detach().float().cpu())
                if len(scores) == self.T:
                    heads.update(score=torch.stack(scores), state=state[0].detach().float().cpu())
            return out, state

        def after(state, out, draws):
            terms.append({k: float(v) for k, v in out.items() if k.startswith("loss") or k == "grad_norm"})
            if state.step == 1:
                grad1.update(leaf_norms(trace_leaves(state)))

        probe.after = after
        orig = V.video_step
        V.video_step = frame_probe
        try:
            solver.train(self.items(), self.state, n, log=log, start_iter=0, handle_signals=False)
        finally:
            V.video_step = orig
            probe.after = None
        move = leaf_norms((k, p - p0[k]) for k, p in self.state.model.named_parameters())
        return Readings([t["loss"] for t in terms], terms, grad1, move, heads=heads, frame_grads=frame_grads)

    def reference_steps(self, n: int) -> List[Dict]:
        return [{"frames": w} for w in self.windows[:n]]

    @contextlib.contextmanager
    def plant(self, name):
        if name is None:
            yield
            return
        if name not in PLANTS:
            raise ValueError(f"no fault {name!r} here (faults: {PLANTS})")
        if name == "frozen":
            with frozen_optimizer():
                yield
            return
        from posecnn_torch.engine import train as T

        orig, calls = T.loss_cross_entropy_single_frame, itertools.count()
        keep = (self.T + 1) // 2

        def first_frames(prob, onehot, total=None):
            # the loss over the window's first frames alone, its mean taken
            # over them: the last frames weigh nothing
            loss = orig(prob, onehot, total)
            return loss * (self.T / keep) if next(calls) % self.T < keep else loss * 0.0

        T.loss_cross_entropy_single_frame = first_frames
        try:
            yield
        finally:
            T.loss_cross_entropy_single_frame = orig

    @contextlib.contextmanager
    def trace_hooks(self, tracer):
        yield

    def flops_per_step(self) -> float:
        from benchmark.counts import video_step_flops

        cf = self.spec.config
        return video_step_flops(self.T * self.B, self.H, self.W, cf["NUM_CLASSES"], cf["NUM_UNITS"])

    def conv3x3_shape(self):
        return (self.B, self.H, self.W, 64, 64)

    def window_notes(self, run) -> Dict:
        from posecnn_torch.ops import conv3x3

        return {"launches": {"conv3x3": conv3x3.CONV3X3_LAUNCHES}}

    def free(self) -> None:
        self.state = self.staged = self._items = self.step_fn = None
