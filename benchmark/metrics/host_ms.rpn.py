"""Host ms a step in the detection network's `rpn` spans: the RPN's 3x3 conv, its class and box heads and the anchor targets
(`models/detection.py`). The Solver's `timings["host/rpn"]`
(`posecnn_torch/core/profiler.py`), mean over the traced run's steps
before the profiled slice; None where the program records no such span."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/rpn")
