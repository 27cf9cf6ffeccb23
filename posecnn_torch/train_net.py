"""Train the flagship PoseCNN on the card: `engine.train.Solver` over the
step of `entry.train_entry`, with the capstone's solver settings
(`config.FLAGSHIP_SOLVER`): a log line and a `train_metrics.csv` row every
20 steps, a light snapshot (`vgg16_fcn_color_lov_syn_capstone_iter_N.npz`,
the JAX npz layout) every 5000 steps and at the end, and one at the step
reached when SIGTERM or SIGINT arrives.

Usage: python -m posecnn_torch.train_net --iters N [--output DIR] [--resume] [--device cuda]

--resume restarts from the latest snapshot in the output directory, at its
step, with a fresh momentum trace where the snapshot is light. Each log line
starts with the seconds since the program started.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, required=True, help="train up to this step")
    ap.add_argument("--output", default=None,
                    help="snapshot and metrics directory (default output/lov_syn_capstone/lov_syn_val_v4/vgg16_convs)")
    ap.add_argument("--resume", action="store_true", help="resume from the latest snapshot in the output directory")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from posecnn_torch.config import EXP_DIR, FLAGSHIP_SOLVER
    from posecnn_torch.engine.train import Solver
    from posecnn_torch.entry import train_entry
    from posecnn_torch.ops import conv3x3, voting

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("train_net: no CUDA device (pass --device cpu to train on the CPU)", file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(f"[{time.perf_counter() - t_start:.3f}s] {msg}", flush=True)

    output = args.output or os.path.join(ROOT, "output", EXP_DIR, "lov_syn_val_v4", "vgg16_convs")
    step, state, bank = train_entry(args.device)
    log(f"bank: {bank['data'].shape[0]} frames on {args.device}; output {output}")
    solver = Solver(step, output_dir=output, **FLAGSHIP_SOLVER)
    start = 0
    if args.resume:
        state, start = solver.resume(state, log=log)
    voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = 0
    solver.train(state, bank, args.iters, log=log, start_iter=start)
    log(f"done at iteration {state.step}; launches hough_vote {voting.VOTE_LAUNCHES} "
        f"conv3x3 {conv3x3.CONV3X3_LAUNCHES}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
