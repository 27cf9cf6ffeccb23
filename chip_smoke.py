#!/usr/bin/env python3
"""Smoke check of the PyTorch port (`posecnn_torch`) on one NVIDIA GPU.

Runs the port's main path, flagship PoseCNN inference (raw 640x480 BGR frame
in, ROIs and 6-DoF poses out), through its user entry points, and checks it:

  1. device: CUDA present; the card's name and power limit (nvidia-smi)
  2. build: every CUDA kernel of the path, from the sources in this checkout
  3. kernel against its plain PyTorch version on the card, at the shapes the
     main path gives it, with median times
  4. Hough voting on the card against the JAX package's golden
  5. the whole network on the card against the JAX package's golden
     (small config, float32, TF32 off)
  (4 and 5 use the checks of tests/torch_parity.py, as the tests do)
  6. flagship inference through `posecnn_torch.entry` and
     `engine.test.make_inference_fn` + `postprocess_detections` on the first
     8 frozen frames of data/lov_syn_val_v4; per-frame latency, peak memory,
     and the kernel launch counts of that run; then the same model and
     frames through the port on the CPU, against which the card's labels,
     valid slots, classes and rois are held at bf16 limits
  7. one JSON line: {"ok": true, "device": {...}}

Any failure raises and the process exits nonzero; nothing falls back to the
CPU. It imports no JAX. Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FRAMES_DIR = os.path.join(ROOT, "data", "lov_syn_val_v4")
N_FRAMES, N_WARMUP = 8, 2


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def median_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() over `reps` launches, CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


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


def main() -> int:
    import torch

    # phase 1: the device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from posecnn_torch import _build
    from posecnn_torch.config import PIXEL_MEANS, flagship_cfg
    from posecnn_torch.engine.test import make_inference_fn, postprocess_detections, set_float32_precision
    from posecnn_torch.entry import entry
    from posecnn_torch.ops import voting
    from posecnn_torch.utils.meta import build_meta_data
    from tests.torch_parity import check_hough_golden, check_slice_golden, hough_on_golden_frame, small_slice_on_golden

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    set_float32_precision()
    phase(1, f"device {name}; torch {torch.__version__} cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    print(smi, flush=True)

    # phase 2: build every kernel of the path
    phase(2, f"built and loaded the CUDA kernels in {_build.build_all():.2f} s")

    # phase 3: kernel against plain at the main path's shapes
    samples, coarse, window = vote_inputs(np.random.RandomState(0), 8, 512, 480, 640)
    s_t = torch.from_numpy(samples).to(dev)
    errs = []
    for label, centers in (("coarse (S=8, P=512, NC=19200, shared)", coarse), ("refine (S=8, 256 per slot)", window)):
        c_t = torch.from_numpy(centers).to(dev)
        v_k, d_k = voting.accumulate_votes(s_t, c_t)
        v_p, d_p = voting.accumulate_votes_plain(s_t, c_t)
        torch.cuda.synchronize()
        check(torch.equal(v_k, v_p), f"{label}: kernel votes differ from the plain version")
        torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-4)
        err = max((v_k - v_p).abs().max().item(), (d_k - d_p).abs().max().item())
        errs.append(err)
        t_plain = [median_ms(lambda: voting.accumulate_votes_plain(s_t, c_t))]
        t_kern = [median_ms(lambda: voting.accumulate_votes(s_t, c_t)) for _ in range(2)]
        t_plain.append(median_ms(lambda: voting.accumulate_votes_plain(s_t, c_t)))
        k_ms, p_ms = statistics.median(t_kern), statistics.median(t_plain)
        if centers is coarse:
            kernel_ms, plain_ms = k_ms, p_ms
        phase(3, f"hough_vote {label}: votes equal, dsum max|err| {err:.3g} (rtol 1e-5, atol 1e-4); "
                 f"kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us (median of 20, runs {t_kern} / {t_plain} ms)")

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
    voting.VOTE_LAUNCHES = 0
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
    peak = torch.cuda.max_memory_allocated()
    check(launches == 2 * len(frames), f"hough_vote launched {launches} times for {len(frames)} frames")
    lat = statistics.median(dev_ms[N_WARMUP:])
    phase(6, f"flagship 640x480 bf16, {len(frames)} frames: per-frame {lat:.3f} ms stream (CUDA events around "
             f"the call, host gaps included; median of frames {N_WARMUP + 1}-{len(frames)}; first {dev_ms[0]:.1f} ms), "
             f"{statistics.median(host_ms[N_WARMUP:]):.3f} ms wall incl. NMS; num_rois {n_rois}; hough_vote launches "
             f"{launches}; peak memory {peak / 2**20:.1f} MiB")
    print(f"per-frame stream ms {[round(x, 3) for x in dev_ms]}; wall ms {[round(x, 3) for x in host_ms]}", flush=True)

    # the card against the CPU port (held to JAX by the CPU tests), same
    # model and frames, at bf16 limits: the two round the bf16 convolutions'
    # f32 sums in other orders, so a few labels flip and near-tied vote
    # counts can move a centre by a pixel or two
    infer_cpu = make_inference_fn(flagship_cfg(is_train=False), PIXEL_MEANS, "cpu")
    model_cpu = copy.deepcopy(model).cpu()
    t0, agree, box_err, vote_err = time.perf_counter(), [], 0.0, 0.0
    for (color, meta), out in zip(frames, outs):
        ref = infer_cpu(model_cpu, torch.from_numpy(color), torch.from_numpy(meta), extents.cpu())
        agree.append(float((out["label_2d"] == ref["label_2d"]).double().mean()))
        check(torch.equal(out["rois_valid"], ref["rois_valid"]), "valid slots differ from the CPU port")
        rois, ref_rois = out["rois"], ref["rois"]
        check(torch.equal(rois[:, :2], ref_rois[:, :2]), "roi batch or class differs from the CPU port")
        box_err = max(box_err, (rois[:, 2:6] - ref_rois[:, 2:6]).abs().max().item())
        vote_err = max(vote_err, (rois[:, 6] - ref_rois[:, 6]).abs().max().item())
    check(min(agree) >= 0.999 and box_err <= 4.0 and vote_err <= 2.0,
          f"card against CPU: label agreement {agree}, roi box max|err| {box_err} px, votes {vote_err}")
    phase(6, f"card against the CPU port on the same {len(frames)} frames ({time.perf_counter() - t0:.1f} s): "
             f"label_2d agreement min {min(agree):.6f} (limit 0.999), valid slots and classes equal, roi box "
             f"max|err| {box_err:.3g} px (limit 4), votes max|err| {vote_err:.3g} (limit 2)")

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "hough_vote", "route": "cuda", "source": "posecnn_torch/csrc/hough_vote.cu",
        "replaces": "posecnn_tpu/ops/pallas/voting.py:36", "launches": launches,
        "max_abs_err": max(errs), "ms": kernel_ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
