"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with an NVIDIA GPU. Prints one JSON object as
the last line of standard output (`correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and last `checks`: each
number `correct` compared, beside its limit), and the same numbers as the
last lines of standard error. Exits non-zero, printing no result, without
a card (or with fewer than the cell asks for), when a module of JAX or of
the JAX package was loaded, or when a run fails.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window's length")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: read the per-layer metrics")
    args = ap.parse_args(argv)

    from benchmark import harness

    harness.set_cache_dirs()
    spec = harness.load_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {spec.chips} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start=T_START)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"benchmark: the run loaded {bad}: the program under test may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
