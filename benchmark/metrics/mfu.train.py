"""The model FLOPs of a step (counts/flops.py, from the cell's shapes)
over the mean time of the traced run's steps before the profiled slice
(CUDA events on the stream; the profiler not yet started), as a share of
the H100's dense bf16 peak, %."""

from benchmark.counts import PEAK_BF16_FLOP_PER_S
from benchmark.timeline import untraced


def read(run):
    tr = run.trace
    steps_ms = untraced(run.step_intervals_ms, run.traced)
    if tr is None or not tr.kernels or not steps_ms:
        return None
    step_s = sum(steps_ms) / len(steps_ms) * 1e-3
    return 100.0 * run.cell.flops_per_step() / step_s / PEAK_BF16_FLOP_PER_S
