"""The NMS kernel's share of its roofline, %: the traced launches' bounds
(counts/nms.py: the IoU tests a greedy sweep of each launch's own sorted
boxes needs, nms_bound) over the traced times of its two kernels, the mask
pass and the sweep."""

import sys

from benchmark.counts.nms import nms_bound, nms_sweep_tests, suppression

KERNELS = ("nms_mask_kernel", "nms_sweep_kernel")


def read(run):
    tr = run.trace
    launches = getattr(run.cell, "nms_launches", None)
    if tr is None or not launches:
        return None
    kernels = [k for k in tr.kernels if any(n in k.name for n in KERNELS)]
    passes = sum(1 for k in kernels if KERNELS[0] in k.name)
    if not passes:
        return None
    bounds = [nms_bound(b.shape[0], nms_sweep_tests(suppression(b, t))[1])[0] for b, _, t in launches]
    bound = sum(bounds)
    if passes != len(launches):
        # the trace lost or gained records: the launches' mean bound for each traced launch
        print(f"nms_roofline: {passes} launches traced for {len(launches)} recorded", file=sys.stderr)
        bound = bound / len(bounds) * passes
    return 100.0 * bound / (sum(k.dur for k in kernels) * 1e-6)
