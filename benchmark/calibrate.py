"""The readings the limits of `correct` are set from, many seeds in one
process: for each seed and each plant (`none`: the program as it runs;
`control`: the reference in the lower precision in its place; a fault's
name: the program broken underneath), the check steps, then the
reference, then the numbers `correct` compares. No measured window.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--plants none,control,frozen]

One JSON line a (seed, plant) on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def worst_leaf(prog, ref, keep=None):
    import numpy as np

    med = float(np.median(list(ref.values())))
    names = [k for k in ref if keep is None or k in keep]
    return max(names, key=lambda k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--plants", default="none", help="comma-separated: none, control, or faults")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    harness.set_cache_dirs()
    spec = harness.load_spec(args.workload)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    shared = {}
    n = int(spec.workload["check_steps"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        for plant in args.plants.split(","):
            plant = None if plant == "none" else plant
            t0 = time.perf_counter()
            cell = harness.driver_module(spec).Cell(spec, seed, args.device, lambda m: None, shared=shared)
            probe = harness.StepProbe(cell.step_fn)
            solver = cell.solver(probe)
            prog = harness.program_readings(spec, cell, seed, args.device, plant, solver, probe, lambda m: None)
            cell.free()
            del solver, probe
            if args.device.startswith("cuda"):
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            ref = harness.reference_side(spec, cell, seed, args.device, n, follow=prog.follow or None)
            numbers = harness.compare(prog, ref)
            keep = harness.kept_leaves(ref.grad1)
            line = {"seed": seed, "plant": plant or "none", "numbers": numbers,
                    "correct": harness.judge(numbers, spec.workload["limits"]),
                    "loss_prog": prog.loss, "loss_ref": ref.loss, "terms_prog": prog.terms, "terms_ref": ref.terms,
                    "grad_worst": worst_leaf(prog.grad1, ref.grad1),
                    "move_worst": worst_leaf(prog.move, ref.move, keep),
                    "left_out": sorted(set(ref.grad1) - keep), "program_s": t1 - t0,
                    "reference_s": time.perf_counter() - t1}
            print(json.dumps(harness._finite(line)), flush=True)
            del cell, prog, ref
            if args.device.startswith("cuda"):
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
