"""Where a flagship inference frame of the PyTorch port spends its device time.

Runs `posecnn_torch` flagship inference (640x480, bf16, seeded weights) on
frozen frames under torch.profiler and prints the device's busy share of the
profiled wall window, host and device time per stage, and the device time by
kernel (the `--top` largest). Stages are spans this tool opens around the
calls into each layer: the trunk, Hough voting, RoI pooling, the fc layers
and host NMS; "heads" is the rest of the frame. Needs one NVIDIA GPU.

Usage: python tools/profile_torch_inference.py [--frames 6] [--top 25]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from posecnn_torch.config import PIXEL_MEANS, flagship_cfg
    from posecnn_torch.engine import test as engine
    from posecnn_torch.entry import entry
    from posecnn_torch.models import backbone, layers
    from posecnn_torch.models import posecnn as model_mod
    from posecnn_torch.utils.meta import build_meta_data

    def span(name, fn):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    stages = {
        "stage:trunk": (backbone.VGGTrunk, "forward"),
        "stage:hough": (model_mod, "hough_voting"),
        "stage:roi_pool": (model_mod, "roi_pool_batched"),
        "stage:fc": (layers, "fc"),
        "stage:host_nms": (engine, "postprocess_detections"),
    }
    for name, (owner, attr) in stages.items():
        setattr(owner, attr, span(name, getattr(owner, attr)))

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _, (model, _, _, extents) = entry(dev)
    infer = engine.make_inference_fn(flagship_cfg(is_train=False), PIXEL_MEANS, dev)
    d = os.path.join(ROOT, "data", "lov_syn_val_v4")
    frames = []
    for name in sorted(os.listdir(d))[: args.frames]:
        with np.load(os.path.join(d, name)) as f:
            frames.append((np.ascontiguousarray(f["color"][None]), build_meta_data(f["intrinsic_matrix"])[None]))

    def run(color, meta):
        with record_function("stage:frame"):
            out = infer(model, torch.from_numpy(color).to(dev), torch.from_numpy(meta).to(dev), extents)
            return engine.postprocess_detections(out)

    for color, meta in frames[:2]:  # warm-up: cuDNN plans, the kernel build
        run(color, meta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for color, meta in frames:
            run(color, meta)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    avg = prof.key_averages()
    n = len(frames)
    spans = {e.key: e for e in avg if e.key.startswith("stage:") and e.device_type.name == "CPU"}
    print(f"{'host ms/frame':>13} {'device ms/frame':>15}  stage")
    frame = spans["stage:frame"]
    rest_cpu, rest_dev = frame.cpu_time_total, frame.device_time_total
    for name in stages:
        e = spans[name]
        rest_cpu -= e.cpu_time_total
        rest_dev -= e.device_time_total
        print(f"{e.cpu_time_total / n / 1e3:13.3f} {e.device_time_total / n / 1e3:15.3f}  {name[6:]}")
    print(f"{rest_cpu / n / 1e3:13.3f} {rest_dev / n / 1e3:15.3f}  heads and the rest")
    print(f"{frame.cpu_time_total / n / 1e3:13.3f} {frame.device_time_total / n / 1e3:15.3f}  frame")
    events = [e for e in avg if e.device_time_total > 0 and e.device_type.name == "CUDA" and e.key not in spans]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    total = sum(e.device_time_total for e in events)
    print(f"{torch.cuda.get_device_name(0)}; {n} frames; device kernel time {total / n / 1e3:.3f} ms/frame; "
          f"wall {wall_us / n / 1e3:.3f} ms/frame; device busy {100 * total / wall_us:.1f}% of wall")
    print(f"{'ms/frame':>9} {'share':>6} {'calls/frame':>11}  kernel")
    for e in events[: args.top]:
        print(f"{e.device_time_total / n / 1e3:9.4f} {100 * e.device_time_total / total:5.1f}% "
              f"{e.count / n:11.1f}  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
