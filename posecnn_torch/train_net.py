"""Train the flagship PoseCNN on the card: `engine.train.Solver` over the
step of `entry.train_entry`, with a log line of every step's losses and lr.

Usage: python -m posecnn_torch.train_net --iters N [--device cuda]

Snapshots, resume and SIGTERM handling are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, required=True, help="training steps to run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from posecnn_torch.engine.train import Solver
    from posecnn_torch.entry import train_entry

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("train_net: no CUDA device (pass --device cpu to train on the CPU)", file=sys.stderr)
        return 2
    step, state, bank = train_entry(args.device)
    print(f"bank: {bank['data'].shape[0]} frames on {args.device}", flush=True)
    Solver(step).train(state, bank, args.iters, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
