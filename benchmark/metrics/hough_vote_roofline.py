"""The vote kernel's share of its roofline, %: the traced launches' bounds
(counts/kernels.py: vote_pairs over each launch's own samples and centres,
vote_bound) over the traced `hough_vote_kernel` times."""

import sys

from benchmark.counts import vote_bound, vote_bytes, vote_pairs


def read(run):
    tr = run.trace
    launches = getattr(run.cell, "vote_launches", None)
    if tr is None or not launches:
        return None
    kernels = [k for k in tr.kernels if "hough_vote_kernel" in k.name]
    if not kernels:
        return None
    bounds = [vote_bound(vote_bytes(s, c), vote_pairs(s, c)[0])[0] for s, c in launches]
    bound = sum(bounds)
    if len(kernels) != len(launches):
        # the trace lost or gained records: the launches' mean bound for each traced kernel
        print(f"hough_vote_roofline: {len(kernels)} kernels traced for {len(launches)} launches recorded",
              file=sys.stderr)
        bound = bound / len(bounds) * len(kernels)
    return 100.0 * bound / (sum(k.dur for k in kernels) * 1e-6)
